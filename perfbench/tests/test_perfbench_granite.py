"""The granite-4.0-h-small cell's files: its reference's tree against the
port's, its work formulas and model FLOPs by hand, its discovery by
name, and its limits against the reference's faults and the fp8 control
at smoke size on the CPU."""
import copy
import time

import pytest
import torch

from perfbench import bench, harness, program
from perfbench.reference import granite_hybrid
from perfbench.workmath import causal_pairs, visible

CELL = "granite-4.0-h-small.serve.longprompt"
OPS = bench.ops()
# the port's smoke widths (configs/granite_4_0_h_small.py SMOKE)
SMOKE = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=32, vocab_size=256, num_experts=8,
             num_experts_per_tok=3, shared_expert_d_ff=48, ssm_state=16,
             ssm_head_dim=16, ssm_chunk=32, attn_layers=[1],
             attention_multiplier=0.0625)


def smoke_cell() -> bench.Cell:
    cell = copy.deepcopy(bench.cell(CELL))
    cell.config["model"].update(SMOKE)
    cell.traffic.update(clients=2, prompt_lens=[16, 24, 32], gen_tokens=4,
                        check_requests=4, check_longest=2, trace_batches=1)
    return cell


def _run(cell, **kw):
    rec = harness.run_cell(cell, program.load(), torch.device("cpu"),
                           seed=7, seconds=0.5, trace=False,
                           t_start=time.perf_counter(), **kw)
    return rec.check


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_leaf_specs_are_the_ports_tree(size):
    from perfbench.train_cell import check_layout
    cell = smoke_cell() if size == "smoke" else bench.cell(CELL)
    prog = program.load()
    cfg = program.model_config(prog, cell.config)
    check_layout(prog, cfg, granite_hybrid.leaf_specs(cell.config["model"]))
    if size == "full":  # every size of the file reaches the port
        assert (cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.d_ff,
                cfg.shared_expert_d_ff, cfg.vocab_size) == \
            (40, 4096, 72, 768, 1536, 100352)
        assert cfg.attn_layers == (5, 15, 25, 35) and not cfg.use_rope
        assert cfg.moe_dropless and not cfg.tie_embeddings


def test_file_keeps_the_catalog_numbers():
    conf = bench.cell(CELL).config
    pub, m = conf, conf["model"]
    assert conf["reduced"] == ["mamba_chunk_size", "tie_word_embeddings"]
    assert set(conf["departs"]) == set(conf["reduced"])
    assert (pub["mamba_chunk_size"], pub["tie_word_embeddings"]) == \
        (m["ssm_chunk"], m["tie_embeddings"])
    assert [i for i, t in enumerate(pub["layer_types"])
            if t == "attention"] == m["attn_layers"]
    for k_pub, k in (("num_hidden_layers", "num_layers"),
                     ("hidden_size", "d_model"),
                     ("num_attention_heads", "num_heads"),
                     ("num_key_value_heads", "num_kv_heads"),
                     ("intermediate_size", "d_ff"),
                     ("num_local_experts", "num_experts"),
                     ("num_experts_per_tok", "num_experts_per_tok"),
                     ("shared_intermediate_size", "shared_expert_d_ff"),
                     ("vocab_size", "vocab_size"),
                     ("mamba_d_state", "ssm_state"),
                     ("mamba_d_head", "ssm_head_dim"),
                     ("mamba_d_conv", "ssm_conv"),
                     ("mamba_expand", "ssm_expand"),
                     ("embedding_multiplier", "embedding_multiplier"),
                     ("attention_multiplier", "attention_multiplier"),
                     ("residual_multiplier", "residual_multiplier"),
                     ("logits_scaling", "logits_scaling"),
                     ("rms_norm_eps", "norm_eps")):
        assert pub[k_pub] == m[k], k
    assert pub["mamba_n_heads"] * pub["mamba_d_head"] == \
        pub["mamba_expand"] * pub["hidden_size"]


def test_moe_experts_work_by_hand():
    f, b = OPS["moe_experts"].work(T=4, K=2, E=3, d=8, f=4)
    assert f == 2 * 4 * 2 * 8 * 3 * 4
    assert b == 2 * (3 * 3 * 8 * 4 + 8 * 8 + 2 * 8 * 4 + 8 * 8)
    # fewer pairs than experts: only the experts that have rows
    f, b = OPS["moe_experts"].work(T=1, K=2, E=72, d=8, f=4)
    assert b == 2 * (3 * 2 * 8 * 4 + 2 * 8 + 2 * 2 * 4 + 2 * 8)


def test_moe_patterns_name_the_prefill_kernels_only():
    names = ["void moe_up_prefill_kernel((anonymous namespace)::Args)",
             "moe_down_prefill_kernel", "moe_up_decode_kernel",
             "moe_down_decode_kernel", "void flash_fwd_tc_kernel<128>(x)",
             "ssd_scan_tc_kernel<64>"]
    owner = {n: [o for o, op in OPS.items()
                 if any(p in n for p in op.patterns)] for n in names}
    assert owner == {names[0]: ["moe_experts"],
                     names[1]: ["moe_experts"], names[2]: [], names[3]: [],
                     names[4]: ["flash_fwd"], names[5]: ["ssd_fwd"]}


def test_forward_flops_by_hand():
    c = dict(num_layers=3, d_model=8, num_heads=2, num_kv_heads=1,
             head_dim=4, d_ff=4, vocab_size=10, num_experts=4,
             num_experts_per_tok=2, shared_expert_d_ff=6, ssm_state=2,
             ssm_expand=2, ssm_head_dim=4, ssm_chunk=2, ssm_conv=3,
             attn_layers=[1])
    din, N, H = 16, 2, 4
    mamba = 8 * (2 * din + 2 * N + H) + din * 8 + 3 * (din + 2 * N)
    attn_proj = 2 * 8 * 8 + 2 * 8 * 4
    moe = 8 * 4 + 2 * 3 * 8 * 4 + 3 * 8 * 6
    mats = 2 * mamba + attn_proj + 3 * moe + 10 * 8
    B, S = 2, 4
    attn = 4.0 * B * 2 * 10 * 4  # 10 causal pairs of 4 positions
    pairs = causal_pairs(S, 2)
    scan = 2.0 * B * pairs * N + 2.0 * B * H * pairs * 4 \
        + 4.0 * B * H * S * N * 4
    want = 2.0 * mats * B * S + attn + 2 * scan
    assert granite_hybrid.forward_flops(c, B, S, OPS) == want


def test_kernel_calls_by_hand():
    c = bench.cell(CELL).config["model"]
    calls = granite_hybrid.kernel_calls(c, "prefill", 16, 4096, 4104)
    names = [n for n, _ in calls]
    assert names.count("flash_fwd") == 4 and names.count("ssd_fwd") == 36
    assert names.count("moe_experts") == 40
    assert names[10:12] == ["flash_fwd", "moe_experts"]  # layer 5
    kw = dict(calls[11][1])
    assert kw == dict(T=16 * 4096, K=10, E=72, d=4096, f=768)
    assert calls[10][1] == dict(B=16, Sq=4096, Sk=4104, kv_len=4096, Hq=32,
                                Hkv=8, D=128)
    assert calls[0][1] == dict(B=16, S=4096, H=128, P=64, G=1, N=128,
                               chunk=128)
    fl, by = OPS["moe_experts"].work(**kw)
    assert fl == pytest.approx(12.37e12, rel=1e-3)  # 6 T K d f
    assert visible(4096, 4104, kv_len=4096)[0] == 4096 * 4097 // 2
    with pytest.raises(ValueError):
        granite_hybrid.kernel_calls(c, "train", 16, 4096)


def test_the_cell_resolves_and_its_readers_wait_for_data():
    cell = bench.cell(CELL)
    assert cell.chips == 1 and cell.family is granite_hybrid
    assert cell.config["draw_by_layer"]
    names = {m["name"] for m in cell.per_layer}
    assert names == {"mfu.prefill", "flash_roofline.prefill",
                     "moe_roofline.prefill", "ssd_roofline.prefill"}
    assert {m["name"] for m in cell.end_to_end} == {"ttft_p95_ms",
                                                    "setup_s"}
    rec = harness.Record(cell, 0.0)
    for m in cell.per_layer:
        assert bench.metric_reader(m["name"]).read(rec) is None
    # training records read nothing from the new prefill readers
    rec.kind = "train"
    for name in ("moe_roofline.prefill", "ssd_roofline.prefill"):
        assert bench.metric_reader(name).read(rec) is None


def test_limits_sit_between_sound_runs_and_every_control():
    """Each number compared lies above every sound reading on the cards
    and below the smallest reading of at least one control or fault
    (the cell's limits file), and every control and fault fails one."""
    lim = bench.cell(CELL).limits
    limits, readings = lim["limits"], lim["readings"]
    for k, v in limits.items():
        assert max(readings[k]["program_values"]) < v, k
    for source in ("fp8", "top9", "noshared"):
        assert any(min(r[source]) > limits[k]
                   for k, r in readings.items() if r.get(source)), source


_SOUND = {}


def sound():
    if "check" not in _SOUND:
        _SOUND["check"] = _run(smoke_cell())
    return _SOUND["check"]


def test_sound_smoke_run_reads_every_number_compared():
    got = sound()
    assert set(bench.cell(CELL).limits["limits"]) <= set(got)


def test_mixer_in_row_blocks_under_the_harness_rules(monkeypatch):
    """The Mamba2 mixer taken a batch row at a time (as the cell's prefill
    takes 4 rows of 4096), under the host rules and batch split the
    harness serves with, gives the logits and states of the whole batch
    at once."""
    import repro_torch.models.granite_hybrid as gh
    from perfbench import weights
    cell = smoke_cell()
    prog = program.load()
    cfg = program.model_config(prog, cell.config)
    params = weights.draw_tree(
        granite_hybrid.leaf_specs(cell.config["model"]), 5, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (3, 32),
                        generator=torch.Generator().manual_seed(2))
    rules = prog.host_rules(None, torch.device("cpu"))
    outs = []
    for block in (gh.MIXER_TOKEN_BLOCK, 32):
        monkeypatch.setattr(gh, "MIXER_TOKEN_BLOCK", block)
        with prog.use_rules(rules), prog.batch_split(3, ()), \
                torch.inference_mode():
            cache = prog.engine.init_cache(cfg, 3, 40, device="cpu")
            lg, cache = prog.registry.prefill(params, cfg, prog.RunConfig(),
                                              {"tokens": tok}, cache)
        outs.append((lg, cache["ssm"].clone()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("fault", granite_hybrid.FAULTS)
def test_faults_exceed_the_limits_at_smoke_size(fault):
    """The reference with the fault, in the program's place, reads above
    the sound run and above a limit of the logits."""
    limits = bench.cell(CELL).limits["limits"]
    got = _run(smoke_cell(), fault=fault)
    ok = sound()
    compared = [k for k in limits if k.startswith("logit")]
    assert any(got[k.replace("logit", fault)] > limits[k] for k in compared)
    assert all(got[k.replace("logit", fault)] > ok[k] for k in compared)
