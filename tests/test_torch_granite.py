"""granite-4.0-h-small in the port: the ``granite_hybrid`` family against
the benchmark's plain f32 reference (``perfbench/reference/
granite_hybrid.py``) at the smoke widths on the CPU, the dropless MoE
against the capacity path, ``chip_smoke.py``'s launch formula against
the kernel ops a serving run calls, and the port-only registry.

The cases marked ``cuda`` hold the grouped expert kernels against their
plain twin at the cell's widths and the flash forward at Granite's
softmax scale, on a card (they skip elsewhere):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_granite.py
"""
import collections
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import (RunConfig, all_cells, get_config,
                                      get_smoke_config, list_archs)
from repro_torch.core import obs
from repro_torch.kernels import moe_experts as kmoe
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import granite_hybrid as G
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.serve import engine

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import weights  # noqa: E402
from perfbench.reference import common, granite_hybrid, serve_ref  # noqa: E402

ARCH = "granite-4.0-h-small"


def _model_dict(cfg):
    """The reference's view of a port config: the cell file's keys."""
    keys = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
            "d_ff", "vocab_size", "num_experts", "num_experts_per_tok",
            "shared_expert_d_ff", "ssm_state", "ssm_expand", "ssm_head_dim",
            "ssm_chunk", "ssm_conv", "embedding_multiplier",
            "attention_multiplier", "residual_multiplier", "logits_scaling",
            "norm_eps", "act")
    c = {k: getattr(cfg, k) for k in keys}
    c["attn_layers"] = list(cfg.attn_layers)
    return c


def _f32_tree(c, seed):
    specs = {p: common.Leaf(l.shape, torch.float32, l.init, l.scale)
             for p, l in granite_hybrid.leaf_specs(c).items()}
    return specs, weights.draw_tree(specs, seed, "cpu")


def test_smoke_keeps_every_kind_of_layer():
    cfg = get_smoke_config(ARCH)
    assert 0 < min(cfg.attn_layers) and max(cfg.attn_layers) < \
        cfg.num_layers - 1
    assert cfg.num_experts >= 8 and cfg.num_experts_per_tok >= 3
    assert cfg.shared_expert_d_ff and cfg.moe_dropless and not cfg.use_rope


def test_port_only_registry():
    """The arch resolves by name and stays out of the JAX package's
    list, and so out of the dry run's cells."""
    assert get_config(ARCH).family == "granite_hybrid"
    assert get_smoke_config(ARCH).num_layers == 4
    assert ARCH not in list_archs()
    assert ARCH not in {a for a, *_ in all_cells()}
    with pytest.raises(KeyError):
        get_config("granite-4.0-h-nonexistent")


def test_tree_is_the_references_at_full_size():
    cfg = get_config(ARCH)
    have = {p: (tuple(d.shape), d.dtype) for p, d in
            common.flatten(registry.param_defs(cfg)).items()}
    want = {p: (tuple(l.shape), l.dtype) for p, l in
            granite_hybrid.leaf_specs(_model_dict(cfg)).items()}
    assert have == want
    n = sum(torch.Size(s).numel() for s, _ in have.values())
    # 32.2 B published (tied) + the untied head's 100352 x 4096
    assert abs(n - 100352 * 4096 - 32.2e9) < 0.05e9, n


def test_prefill_and_decode_against_the_reference():
    """Prefill logits, then 4 decode steps through the flat cache, against
    the reference's full forward over the prompt and the decoded tokens:
    f32 weights; the KV cache holds bf16 K / V, which prefill attends over
    too (2e-3), and decode reads bf16 conv tails besides (2e-2)."""
    cfg = get_smoke_config(ARCH)
    c = _model_dict(cfg)
    _, params = _f32_tree(c, 11)
    run = RunConfig(use_kernels=False)
    g = torch.Generator().manual_seed(5)
    tok = torch.randint(0, cfg.vocab_size, (2, 37), generator=g)
    cache = engine.init_cache(cfg, 2, 48, device="cpu")
    assert set(cache) == {"k", "v", "tail_x", "tail_B", "tail_C", "ssm"}
    seen, got = tok, []
    with torch.no_grad():
        lg, cache = registry.prefill(params, cfg, run, {"tokens": tok},
                                     cache)
        got.append(lg)
        for j in range(4):
            nxt = got[-1][:, -1].argmax(-1, keepdim=True)
            seen = torch.cat([seen, nxt], 1)
            lg, cache = registry.decode(params, cfg, run, nxt, cache,
                                        37 + j)
            got.append(lg)
        want = serve_ref.logits_at(granite_hybrid, c, params, [seen],
                                   [36])[0]
    got = torch.cat(got, dim=1)
    err = serve_ref.rel_err(got, want)
    assert float(err[:, 0].max()) < 2e-3, err
    assert float(err.max()) < 2e-2, err


def test_run_serving_drives_the_family():
    """``launch/serve.py::run_serving`` serves the smoke twin through the
    engine and the registry on the CPU."""
    from repro_torch.launch.serve import run_serving
    res = run_serving(ARCH, prompt_len=20, gen=4, batch=2, device="cpu")
    assert res["generated"] == (2, 4) and res["layers"] == 4


def test_reference_faults_move_the_logits():
    c = _model_dict(get_smoke_config(ARCH))
    _, params = _f32_tree(c, 3)
    tok = torch.randint(0, c["vocab_size"], (2, 40),
                        generator=torch.Generator().manual_seed(1))
    sound = serve_ref.logits_at(granite_hybrid, c, params, [tok], [0])[0]
    for fault in granite_hybrid.FAULTS:
        bad = serve_ref.logits_at(granite_hybrid, c, params, [tok], [0],
                                  mode=fault)[0]
        assert float(serve_ref.rel_err(bad, sound).median()) > 0.05, fault


def _moe_case(case, seed=0):
    """An MoE layer of 8 experts top 3 (d 64, f 32) and 3 x 20 tokens:
    routing as drawn, one expert that no token takes, or one that every
    token takes (the router's column made very low or very high over
    tokens of positive entries)."""
    base = get_smoke_config(ARCH)
    g = torch.Generator().manual_seed(seed)
    p = P.layer(P.materialize(L.moe_defs(base.replace(shared_expert_d_ff=0),
                                         1), g, "cpu"), 0)
    p = {k: v.float() for k, v in p.items()}
    x = torch.randn(3, 20, base.d_model, generator=g)
    if case != "drawn":
        x = x.abs()
        p["router"][:, 2] = -1.0 if case == "empty_expert" else 1.0
    return base, p, x


@pytest.mark.parametrize("case", ["drawn", "empty_expert", "full_expert"])
def test_dropless_equals_the_capacity_path(case):
    """At capacity factor E / K the capacity path drops nothing, so the
    dropless path computes the same sums (up to f32 rounding: the
    products run over other row counts)."""
    base, p, x = _moe_case(case)
    E, K = base.num_experts, base.num_experts_per_tok
    run = RunConfig(use_kernels=False)
    cap = base.replace(moe_dropless=False, shared_expert_d_ff=0,
                       moe_capacity_factor=E / K)
    drop = base.replace(shared_expert_d_ff=0)
    with torch.no_grad():
        r = L.moe_route(p, cap, x)
        assert bool(r.keep.all())
        want = L.moe_block(p, cap, run, x)
        got = L.moe_block(p, drop, run, x)
        rows = moe_rows(drop, p, x)
    if case == "empty_expert":
        assert rows[2] == 0
    if case == "full_expert":
        assert rows[2] == x.shape[0] * x.shape[1]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def moe_rows(cfg, p, x):
    top_e, _ = L._top_weights(*L._gates_top(p, cfg, x.reshape(-1,
                                                              x.shape[-1])))
    return torch.bincount(top_e.reshape(-1), minlength=cfg.num_experts)


def test_moe_sort_groups_pairs_by_expert():
    base, p, x = _moe_case("drawn", seed=4)
    xt = x.reshape(-1, x.shape[-1])
    top_e, top_w = L._top_weights(*L._gates_top(p, base, xt))
    r = L.moe_sort(base, top_e, top_w)
    K = base.num_experts_per_tok
    off = r.offsets.tolist()
    assert off[0] == 0 and off[-1] == top_e.numel()
    for e in range(base.num_experts):
        pairs = r.token[off[e]:off[e + 1]].long()
        assert bool((top_e[pairs] == e).any(dim=1).all())
        assert bool((pairs[1:] > pairs[:-1]).all())  # stable: token order
    # each pair's row in the sorted order holds its own token and expert
    tok = torch.arange(xt.shape[0])[:, None].expand(-1, K)
    assert torch.equal(r.token[r.where].long(), tok)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mixer_block,moe_block", [(8192, 8192), (24, 16)],
                         ids=["whole", "blocks"])
def test_launch_formula_counts_the_kernel_ops(monkeypatch, mixer_block,
                                              moe_block):
    """``chip_smoke.granite_launches`` against the kernel ops one
    ``run_serving`` calls: on the CPU each op runs its plain version, one
    call where the card launches its kernel (the grouped experts launch
    two a call).  The prompt whole, and the mixers and the MoE in blocks
    of rows and tokens (2 mixer blocks, 3 MoE calls a layer)."""
    smoke = _chip_smoke()
    monkeypatch.setattr(G, "MIXER_TOKEN_BLOCK", mixer_block)
    monkeypatch.setattr(L, "MOE_TOKEN_BLOCK", moe_block)
    calls = collections.Counter()
    for name in ("rmsnorm", "rmsnorm_split", "flash_attention", "ssd",
                 "moe_experts"):
        def counted(*a, _fn=getattr(ops, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    batch, prompt, gen = 4, 12, 3
    res = serve.run_serving(ARCH, smoke=True, prompt_len=prompt, gen=gen,
                            batch=batch, device="cpu")
    assert res["generated"] == (batch, gen)
    got = {"rmsnorm": calls["rmsnorm"],
           "flash_attention": calls["flash_attention"],
           "ssd_scan": calls["ssd"], "rmsnorm_split": calls["rmsnorm_split"],
           "moe_experts": 2 * calls["moe_experts"]}
    assert got == smoke.granite_launches(get_smoke_config(ARCH), batch,
                                         prompt, gen)


def test_shared_expert_and_spans_in_the_layer():
    """The shared expert is added to the routed sum, under ``moe.shared``
    inside ``moe``; the model's mixers run under ``block.mamba2`` and
    ``attention``."""
    cfg = get_smoke_config(ARCH)
    g = torch.Generator().manual_seed(9)
    params = P.materialize(registry.param_defs(cfg), g, "cpu")
    run = RunConfig(use_kernels=False)
    tok = torch.randint(0, cfg.vocab_size, (1, 12), generator=g)
    obs.start()
    try:
        with torch.no_grad():
            registry.forward(params, cfg, run, {"tokens": tok})
    finally:
        spans = obs.stop()
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert names.count("block.mamba2") == cfg.num_layers - len(
        cfg.attn_layers)
    assert names.count("attention") == len(cfg.attn_layers)
    shared = [s for s in spans if s["name"] == "moe.shared"]
    assert len(shared) == cfg.num_layers
    assert all(by_id[s["parent"]]["name"] == "moe" for s in shared)
    p = {k: v.float() for k, v in P.layer(params["blocks"]["moe"], 0).items()
         if k != "shared"}
    p["shared"] = {k: v[0].float() for k, v in
                   params["blocks"]["moe"]["shared"].items()}
    x = torch.randn(2, 6, cfg.d_model, generator=g)
    with torch.no_grad():
        whole = L.moe_block(p, cfg, run, x)
        routed = L.moe_block({k: v for k, v in p.items() if k != "shared"},
                             cfg, run, x)
        shared_y = L.mlp(p["shared"], L.shared_expert_cfg(cfg), run, x)
    torch.testing.assert_close(whole, routed + shared_y)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _uneven_route(T, K, E, dev, seed):
    """Each token's K distinct experts drawn with weights falling as
    1 / (e + 1), expert 3 never and expert 5 always: loads from none to
    every token."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = 1.0 / torch.arange(1, E + 1, device=dev, dtype=torch.float32)
    w[3], w[5] = 0.0, 0.0
    rest = torch.multinomial(w.expand(T, E), K - 1, generator=g)
    top_e = torch.cat([rest, torch.full((T, 1), 5, device=dev)], 1)
    top_e = torch.sort(top_e, dim=1).values
    top_w = torch.rand(T, K, generator=g, device=dev)
    return top_e, top_w / top_w.sum(1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16384, 16])
def test_grouped_kernel_against_plain_twin(cuda, T):
    """The grouped kernels against the plain per-expert loop at the cell's
    widths (d 4096, 72 experts of 768, top 10), loads from 0 rows to every
    token, bf16 (2e-2); the same bits over two runs."""
    cfg = get_config(ARCH)
    E, K, d, f = cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model, \
        cfg.d_ff
    g = torch.Generator(device=cuda).manual_seed(T)
    bf = torch.bfloat16
    x = torch.randn(T, d, generator=g, device=cuda).to(bf)
    wg = (torch.randn(E, d, f, generator=g, device=cuda) * d ** -0.5).to(bf)
    wu = (torch.randn(E, d, f, generator=g, device=cuda) * d ** -0.5).to(bf)
    wd = (torch.randn(E, f, d, generator=g, device=cuda) * f ** -0.5).to(bf)
    top_e, top_w = _uneven_route(T, K, E, cuda, T + 1)
    r = L.moe_sort(cfg, top_e, top_w)
    counts = (r.offsets[1:] - r.offsets[:-1]).tolist()
    assert counts[3] == 0 and counts[5] == T
    got = kmoe.moe_experts_cuda(x, r.token, r.offsets, wg, wu, wd,
                                decode=T == 16)
    again = kmoe.moe_experts_cuda(x, r.token, r.offsets, wg, wu, wd,
                                  decode=T == 16)
    want = kmoe.moe_experts_ref(x, r.token, r.offsets, wg, wu, wd)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_flash_forward_at_granite_scale(cuda):
    """Flash forward at softmax scale 1/128 (Granite's attention
    multiplier, not 128^-1/2), 32 / 8 heads of 128, against the plain
    path, bf16 (2e-2)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    B, Sq, Sk, Hq, Hkv, D = 2, 256, 264, 32, 8, 128
    q, k, v = (torch.randn(B, s, h, D, generator=g, device=cuda).to(
        torch.bfloat16) for s, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
    got = ops.flash_attention(q, k, v, kv_len=Sq, scale=1 / 128)
    want = ref.flash_attention_ref(q, k, v, kv_len=Sq, scale=1 / 128)
    plain = ref.flash_attention_ref(q, k, v, kv_len=Sq)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert float((want.float() - plain.float()).abs().max()) > 0.1
