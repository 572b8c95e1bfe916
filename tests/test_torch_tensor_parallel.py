"""The compute split over the ``model`` axis (heads, ``ffn`` columns,
vocab rows; query rows where the heads do not divide; a KV cache split
over its positions or heads; the Mamba2 block by SSM heads or by the SSD
head dim, its gated RMSNorm over a split row, its decode state the rank's
block; MoE decode's experts where they lie), on the CPU: 4 ``gloo``
ranks, f32 smoke configs, held against the JAX package under
``use_rules`` on an Auto mesh of the same shape.

The harness is tests/test_torch_distributed.py's: a module fixture runs
``python tests/test_torch_tensor_parallel.py jax OUT`` (4 host devices)
beside ``... torch RANK STORE OUT`` four times over a ``file://`` store;
both draw weights and inputs from numpy seeds and write ``.npz`` files.

- serving (``SERVE``): the prefill's logits and ``N_DEC`` teacher-forced
  decode steps' over a cache of the rank's block: split over ``kv_seq``
  where ``max_len`` divides ``model``, else over heads or whole (bf16 and
  int8 caches); yi-6b (heads divide, Hkv 2 does not at model 4),
  qwen1.5-4b (3 heads: the query rows, ``"q_seq"``), mixtral (attention
  split beside the expert block), whisper (cross-attention and its cache)
  llava (patches before the prompt), zamba2 (its shared attention
  block and its mamba blocks split, 2 of 8 SSM heads a rank) and mamba2
  (2 of 8 heads; with ``ssm_head_dim`` 64, 2 heads that do not divide 4,
  16 of 64 head-dim channels); MoE decode (S = 1, the gspmd path) runs
  the rank's experts (mixtral's 4 at model 4: one a rank) or, with 6
  experts, all of them on its ffn slice;
- training (``TRAIN``): the loss and the first batch's gradients, then a
  train step, for those archs and mamba2 (the tied head's vocab-parallel
  CE; its blocks split by heads, and by head dim);
- on each rank: the leaves replicated over ``model`` (norms, routers,
  ``b_down``, the mamba block's B / C / dt projections and convolutions,
  ``A_log``, ``D``, ``dt_bias``) get the same gradient bit for bit on
  every model rank, and the calls see the local sizes (yi-6b at (1, 4): 1
  of 4 query heads, 32 of 128 ``ffn`` columns, 64 of 256 vocab rows;
  qwen1.5-4b: 4 of 16 query rows; the SSD scan's heads and head dim, the
  gated norm's 32 of 128 columns, the decode experts);
- a checkpoint saved at (1, 4) loads at one rank, and the other way
  round, bit for bit; and, in this process, the CE statistics of four
  vocab shards merged against the whole vocab's, the split-row RMSNorm's
  four column shards against the whole row, and the SSD scan on a head
  dim zero-padded to 8 against it unpadded.

Limits: logits against the port at one rank (under one-rank rules: the
MoE block's semantics) rtol 1e-4 (atol 1e-4 of the largest), and against
JAX 2e-3 (tests/test_torch_serving.py's f32 limit; see ``CACHE_ROUNDING``);
training as tests/test_torch_distributed.py: loss rtol 1e-6, gradients
rtol 1e-4, params after a step rtol 1e-5 plus 2 lr.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_distributed as TD  # noqa: E402

HERE = os.path.abspath(__file__)
WORLD = 4
B, S, N_DEC = 4, 16, 3
# name: (arch, mesh, config overrides, cache max_len)
SERVE = {
    "yi_1x4": ("yi-6b", (1, 4), {}, 24),  # kv_seq split, kv heads whole
    "yi_1x4_int8_whole": ("yi-6b", (1, 4), {"kv_cache_dtype": "int8"}, 22),
    "yi_2x2_heads": ("yi-6b", (2, 2), {}, 23),  # the cache split by heads
    "yi_2x2_int8": ("yi-6b", (2, 2), {"kv_cache_dtype": "int8"}, 24),
    "qwen4b_1x4": ("qwen1.5-4b", (1, 4), {}, 24),
    "qwen4b_1x4_int8": ("qwen1.5-4b", (1, 4), {"kv_cache_dtype": "int8"},
                        24),
    "qwen4b_1x4_int8_whole": ("qwen1.5-4b", (1, 4),
                              {"kv_cache_dtype": "int8"}, 22),
    "mixtral_1x4": ("mixtral-8x7b", (1, 4), {}, 24),
    "whisper_1x4": ("whisper-tiny", (1, 4), {}, 22),  # cross cache kv_seq
    "llava_1x4": ("llava-next-mistral-7b", (1, 4), {}, 36),
    "zamba2_1x4": ("zamba2-1.2b", (1, 4), {}, 24),  # shared block, heads
    "mamba2_1x4": ("mamba2-130m", (1, 4), {}, 24),  # SSM heads
    "mamba2_1x4_p": ("mamba2-130m", (1, 4), {"ssm_head_dim": 64}, 24),
    "mixtral_1x4_ffn": ("mixtral-8x7b", (1, 4), {"num_experts": 6}, 24),
}
# name: (arch, mesh, config overrides)
TRAIN = {
    "yi_1x4": ("yi-6b", (1, 4), {}),
    "qwen4b_1x4": ("qwen1.5-4b", (1, 4), {}),
    "qwen4b_2x2": ("qwen1.5-4b", (2, 2), {}),
    "mixtral_1x4": ("mixtral-8x7b", (1, 4), {}),
    "whisper_1x4": ("whisper-tiny", (1, 4), {}),
    "llava_1x4": ("llava-next-mistral-7b", (1, 4), {}),
    "mamba2_1x4": ("mamba2-130m", (1, 4), {}),
    "mamba2_1x4_p": ("mamba2-130m", (1, 4), {"ssm_head_dim": 64}),
    "zamba2_1x4": ("zamba2-1.2b", (1, 4), {}),
}
CKPT_ARCH = "yi-6b"
# cases whose one-rank port already lies farther from JAX than the JAX
# limit: a cached element whose f32 value sits at a rounding midpoint
# rounds apart in the two packages (int8: tests/test_torch_serving_archs.py;
# bf16: tests/test_torch_ssm.py's one bf16 ulp), and the move grows
# downstream (yi-6b int8: ~5e-3 at one rank; zamba2's shared block, read
# after the mamba blocks: ~1.6e-2; mamba2's bf16 conv tails: ~2.2e-3).
# These are held against the port at one rank, and no farther from JAX
# than it.
CACHE_ROUNDING = ("yi_1x4_int8_whole", "yi_2x2_int8", "zamba2_1x4",
                  "mamba2_1x4")
# cases held against the port at one rank with their caches in f32 (both
# runs): zamba2's split mamba blocks move the residual stream in its last
# bits, and its shared block's bf16 KV cache rounds ~0.2% of K/V elements
# apart, which moves the logits by up to 3e-4 (with f32 caches the split
# lies 2e-6 from one rank)
F32_CACHES = ("zamba2_1x4",)


def _prefix(cfg) -> int:
    """Positions before the first decode step: a VLM's patches count."""
    return S + (cfg.num_img_patches if cfg.family == "vlm" else 0)


def _modality(cfg, rng, batch):
    from repro_torch.models import registry
    extra = registry.modality_input(cfg)
    if extra is None:
        return {}
    name, n = extra
    return {name: (rng.normal(size=(batch, n, cfg.d_model)) * 0.02
                   ).astype(np.float32)}


def _serve_inputs(cfg):
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    out.update(_modality(cfg, rng, B))
    dec = rng.integers(0, cfg.vocab_size, (B, N_DEC)).astype(np.int32)
    return out, dec


def _train_batch(cfg):
    b = TD._np_batch(cfg, 0)
    b.update(_modality(cfg, np.random.default_rng(5), B))
    return b


# ---------------------------------------------------------------------------
# The JAX reference (its own process: 4 host devices)
# ---------------------------------------------------------------------------


def _jax_main(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import get_smoke_config as j_smoke
    from repro.models import registry as jreg
    from repro.optim import adamw_init as j_adamw_init
    from repro.serve import engine as jengine
    from repro.sharding import ShardingRules as JRules
    from repro.sharding import use_rules as j_use_rules
    from repro.train.step import grads_and_metrics as j_grads
    from repro.train.step import make_train_step as j_make_train_step

    def mesh(shape):
        devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        return jax.sharding.Mesh(devs, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)

    for name, (arch, shape, over, max_len) in SERVE.items():
        cfg = TD._cfg(arch, **over)
        jcfg = j_smoke(arch).replace(**over)
        jp = jax.tree.map(jnp.asarray, TD._np_params(cfg))
        prompt, dec = _serve_inputs(cfg)
        run = JRunConfig()
        with j_use_rules(JRules(mesh(shape))):
            cache = jengine.init_cache(jcfg, B, max_len)
            lg, cache = jax.jit(lambda p, b, c: jreg.prefill(
                p, jcfg, run, b, c))(
                jp, {k: jnp.asarray(v) for k, v in prompt.items()}, cache)
            step = jax.jit(lambda p, t, c, pos: jreg.decode(
                p, jcfg, run, t, c, pos))
            outs = [lg]
            for i in range(N_DEC):
                lg, cache = step(jp, jnp.asarray(dec[:, i:i + 1]), cache,
                                 jnp.int32(_prefix(cfg) + i))
                outs.append(lg)
        np.savez(os.path.join(out, f"serve_jax_{name}.npz"),
                 logits=np.concatenate([np.asarray(o, np.float32)
                                        for o in outs], axis=1))

    for name, (arch, shape, over) in TRAIN.items():
        cfg = TD._cfg(arch, **over)
        run = TD._run(cfg)
        jrun = JRunConfig(total_steps=run.total_steps,
                          warmup_steps=run.warmup_steps,
                          ce_block_v=run.ce_block_v, ce_dtype=run.ce_dtype)
        jcfg = j_smoke(arch).replace(**over)
        jp = jax.tree.map(jnp.asarray, TD._np_params(cfg))
        b = {k: jnp.asarray(v) for k, v in _train_batch(cfg).items()}
        with j_use_rules(JRules(mesh(shape))):
            grads, m0 = jax.jit(lambda p, b: j_grads(p, jcfg, jrun, b))(jp, b)
            state = {"params": jp, "opt": j_adamw_init(jp)}
            state, m = jax.jit(j_make_train_step(jcfg, jrun))(state, b)
        np.savez(os.path.join(out, f"train_jax_{name}.npz"),
                 loss=np.float32(m0["loss"]),
                 norm=np.float32(m["grad_norm"]),
                 **TD._flat(jax.tree.map(np.asarray, state["params"])),
                 **TD._flat(jax.tree.map(np.asarray, grads), "grad"))


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------


def _rules(shape):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ShardingRules
    return ShardingRules(make_mesh(shape, ("data", "model"), "cpu"))


def _serve_path(cfg, rules, prompt, dec, max_len):
    """Prefill and N_DEC teacher-forced decode steps under ``rules`` on
    this rank's rows; returns (the logits of every rank's rows, the
    rank's cache)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import params as P
    from repro_torch.models import registry
    from repro_torch.serve import engine
    from repro_torch.sharding import batch_split, shard_params, use_rules
    rows, axes = rules.rows(B), rules.batch_axes(B)
    run = RunConfig()
    with use_rules(rules), torch.inference_mode(), \
            batch_split(len(rows), axes):
        params = shard_params(P.tree_map(torch.from_numpy,
                                         TD._np_params(cfg)),
                              registry.param_defs(cfg), rules)
        batch = {k: torch.from_numpy(v)[rows] for k, v in prompt.items()}
        batch["tokens"] = batch["tokens"].long()
        cache = engine.init_cache(cfg, len(rows), max_len, "cpu")
        lg, cache = registry.prefill(params, cfg, run, batch, cache)
        outs = [lg]
        toks = torch.from_numpy(dec).long()[rows]
        for i in range(N_DEC):
            lg, cache = registry.decode(params, cfg, run, toks[:, i:i + 1],
                                        cache, _prefix(cfg) + i)
            outs.append(lg)
        return rules.all_gather(torch.cat(outs, dim=1), 0, axes), cache


@contextlib.contextmanager
def _f32_caches():
    """KV caches and mamba states held in f32 (patched into the defs), so
    that no cached element rounds."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    saved = L.kv_cache_defs, M.state_defs

    def f32(fn):
        return lambda *a: {k: dataclasses.replace(d, dtype=torch.float32)
                           for k, d in fn(*a).items()}
    L.kv_cache_defs, M.state_defs = f32(L.kv_cache_defs), f32(M.state_defs)
    try:
        yield
    finally:
        L.kv_cache_defs, M.state_defs = saved


def _torch_serve(name, out, rank):
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import params as P
    from repro_torch.sharding import ShardingRules, use_rules
    arch, shape, over, max_len = SERVE[name]
    cfg = TD._cfg(arch, **over)
    rules = _rules(shape)
    one_rank = ShardingRules(Mesh((1, 1), ("data", "model")))
    prompt, dec = _serve_inputs(cfg)
    with _Sizes() as sizes:
        logits, cache = _serve_path(cfg, rules, prompt, dec, max_len)
    held = {"sizes": sizes.as_dict()}
    if cfg.family != "ssm":
        kv = {"encdec": lambda c: c["self"], "hybrid": lambda c: c["kv"]
              }.get(cfg.family, lambda c: c)(cache)
        held.update(positions_heads=list(kv["k"].shape[2:4]),
                    kv_positions=L.kv_positions(P.layer(kv, 0)))
    if cfg.family == "encdec":
        held["cross_positions"] = L.kv_positions(P.layer(cache["cross"], 0))
    if cfg.family in ("ssm", "hybrid"):
        st = cache if cfg.family == "ssm" else cache["mamba"]
        held["mamba"] = {k: list(v.shape) for k, v in st.items()}
        with use_rules(rules):
            held["ssm_split"] = M.ssm_split(cfg)
    saved = {"logits": logits}
    if rank == 0:
        saved["one"] = _serve_path(cfg, one_rank, prompt, dec, max_len)[0]
    if name in F32_CACHES:
        with _f32_caches():
            saved["logits_f32"] = _serve_path(cfg, rules, prompt, dec,
                                              max_len)[0]
            if rank == 0:
                saved["one_f32"] = _serve_path(cfg, one_rank, prompt, dec,
                                               max_len)[0]
    if rank == 0:
        np.savez(os.path.join(out, f"serve_port_{name}.npz"),
                 **{k: v.numpy() for k, v in saved.items()})
    with open(os.path.join(out, f"serve_cache_{name}_{rank}.json"), "w") as f:
        json.dump(held, f)
    dist.barrier()


class _Sizes:
    """Records the local sizes the split calls see (patched in): flash
    attention's (query rows, query heads, kv heads), the MLP's ``ffn``
    columns, the CE's vocab rows, the SSD scan's and decode step's (heads,
    head dim), the split gated norm's (columns, whole row) and the expert
    grid's (experts, ffn columns) at decode (S = 1)."""

    def __init__(self):
        self.flash, self.mlp, self.ce = set(), set(), set()
        self.ssd, self.norm, self.experts = set(), set(), set()

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        from repro_torch.models import layers as L
        self.saved = (ops.flash_attention, L.mlp,
                      ref.cross_entropy_partial_ref, ops.ssd,
                      ops.ssd_decode, ops.rmsnorm_split, L._experts_combine)
        flash, mlp, ce, ssd, ssd_decode, norm, experts = self.saved

        def rec_flash(q, k, v, **kw):
            self.flash.add((q.shape[1], q.shape[2], k.shape[2]))
            return flash(q, k, v, **kw)

        def rec_mlp(p, cfg, run, x):
            self.mlp.add(p["w_up"].shape[-1])
            return mlp(p, cfg, run, x)

        def rec_ce(hidden, w, targets, **kw):
            self.ce.add(w.shape[0])
            return ce(hidden, w, targets, **kw)

        def rec_ssd(x, *a, **kw):
            self.ssd.add(tuple(x.shape[2:]))
            return ssd(x, *a, **kw)

        def rec_ssd_decode(x, *a):
            self.ssd.add(tuple(x.shape[1:]))
            return ssd_decode(x, *a)

        def rec_norm(x, w, **kw):
            self.norm.add((x.shape[-1], kw["d_whole"]))
            return norm(x, w, **kw)

        def rec_experts(p, cfg, x, *a):
            if x.shape[1] == 1:
                self.experts.add((a[-2], p["w_gate"].shape[-1]))
            return experts(p, cfg, x, *a)
        ops.flash_attention, L.mlp = rec_flash, rec_mlp
        ref.cross_entropy_partial_ref = rec_ce
        ops.ssd, ops.ssd_decode = rec_ssd, rec_ssd_decode
        ops.rmsnorm_split, L._experts_combine = rec_norm, rec_experts
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops, ref
        from repro_torch.models import layers as L
        (ops.flash_attention, L.mlp, ref.cross_entropy_partial_ref, ops.ssd,
         ops.ssd_decode, ops.rmsnorm_split, L._experts_combine) = self.saved

    def as_dict(self):
        return {"flash": sorted(self.flash), "mlp": sorted(self.mlp),
                "ce": sorted(self.ce), "ssd": sorted(self.ssd),
                "norm": sorted(self.norm), "experts": sorted(self.experts)}


def _torch_train(name, out, rank):
    import torch.distributed as dist

    from repro_torch.models import params as TP
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import (gather_params, rules as SRm,
                                      shard_params, use_rules)
    from repro_torch.train import step as tstep
    arch, shape, over = TRAIN[name]
    cfg = TD._cfg(arch, **over)
    rules = _rules(shape)
    defs = registry.param_defs(cfg)
    run = TD._run(cfg)
    b = {k: torch.from_numpy(v) for k, v in _train_batch(cfg).items()}
    with use_rules(rules):
        params = shard_params(TP.tree_map(torch.from_numpy,
                                          TD._np_params(cfg)), defs, rules)
        params = TP.tree_map(lambda t: t.clone(), params)
        with _Sizes() as sizes:
            grads, m0 = tstep.grads_and_metrics(params, cfg, run, b)
        # leaves replicated over "model": the same gradient on every rank
        same = {}
        for path, (g, d) in _flat_pairs(grads, defs).items():
            if "model" in {a for ax in rules.spec(d.logical, d.shape)
                           for a in SRm._axes(ax)}:
                continue
            every = rules.all_gather(g[None], 0, ("model",))
            same[path] = bool(all(torch.equal(every[0], e) for e in every))
        with torch.no_grad():
            full_g = gather_params(grads, defs)
        state = {"params": params, "opt": adamw_init(params)}
        state, m = tstep.make_train_step(cfg, run)(state, b)
        with torch.no_grad():
            full_p = gather_params(state["params"], defs)
    if rank == 0:
        np.savez(os.path.join(out, f"train_port_{name}.npz"),
                 loss=np.float32(m0["loss"]), norm=np.float32(m["grad_norm"]),
                 **TD._flat(full_p), **TD._flat(full_g, "grad"))
    with open(os.path.join(out, f"train_rank_{name}_{rank}.json"), "w") as f:
        json.dump({"replicated_equal": same, "sizes": sizes.as_dict()}, f)
    dist.barrier()


def _flat_pairs(tree, defs, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_pairs(tree[k], defs[k], f"{prefix}/{k}"))
        return out
    return {prefix: (tree, defs)}


def _torch_ckpt(out, rank, ckpt_in):
    """(1, 4): loads the one-rank checkpoint (its blocks saved per rank)
    and writes a state drawn sharded from a seed."""
    import torch.distributed as dist

    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.sharding import use_rules
    from repro_torch.train import step as tstep
    cfg = TD._cfg(CKPT_ARCH)
    sdefs = tstep.state_defs(cfg)
    rules = _rules((1, 4))
    with use_rules(rules):
        state, _ = load_checkpoint(os.path.join(ckpt_in, "one"), defs=sdefs)
        torch.save(state, os.path.join(out, f"ckpt_blocks_{rank}.pt"))
        fresh = tstep.init_state(torch.Generator().manual_seed(0), cfg,
                                 TD._run(cfg))
        save_checkpoint(os.path.join(out, "ckpt_tp"), fresh, 0, defs=sdefs)
    dist.barrier()


def _torch_main(rank, store, out, ckpt_in):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    torch.set_num_threads(1)
    for name in SERVE:
        _torch_serve(name, out, rank)
    for name in TRAIN:
        _torch_train(name, out, rank)
    _torch_ckpt(out, rank, ckpt_in)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2])
    else:
        _torch_main(int(sys.argv[2]), *sys.argv[3:6])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes a one-rank checkpoint, then runs the JAX reference and the 4
    ranks together; returns (output directory, checkpoint directory)."""
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.sharding import use_rules
    from repro_torch.train import step as tstep
    out = tmp_path_factory.mktemp("tp")
    ckpt = tmp_path_factory.mktemp("tp_ckpt")
    cfg = TD._cfg(CKPT_ARCH)
    with use_rules(None):
        state = tstep.init_state(torch.Generator().manual_seed(1), cfg,
                                 TD._run(cfg))
        save_checkpoint(str(ckpt / "one"), state, 0)
    procs = [subprocess.Popen(
        [sys.executable, HERE, "jax", str(out)], env=TD._env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_PLATFORMS="cpu"))]
    store = str(out / "store")
    procs += [subprocess.Popen(
        [sys.executable, HERE, "torch", str(rank), store, str(out),
         str(ckpt)], env=TD._env()) for rank in range(WORLD)]
    try:
        for p in procs:
            assert p.wait(timeout=600) == 0, p.args
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out, ckpt


@pytest.mark.parametrize("case", list(SERVE))
def test_prefill_and_decode_match_one_rank_and_jax_under_rules(runs, case):
    """The split path against the port at one rank under one-rank rules
    (the same function: sums in another order), then against the JAX
    package under rules at the port's f32 serving limit against JAX
    (tests/test_torch_serving.py: 2e-3); the ``CACHE_ROUNDING`` cases no
    farther from JAX than one rank.  The ``F32_CACHES`` cases are held
    against one rank with both runs' caches in f32, where no cached
    element can round apart."""
    out, _ = runs
    port = np.load(out / f"serve_port_{case}.npz")
    got, one = port["logits"], port["one"]
    want = np.load(out / f"serve_jax_{case}.npz")["logits"]
    assert got.shape == want.shape == one.shape == (B, 1 + N_DEC,
                                                    got.shape[-1])
    if case in F32_CACHES:
        TD._close(port["logits_f32"], port["one_f32"], 1e-4, atol_share=1e-4,
                  msg=f"{case} one rank, f32 caches")
    else:
        TD._close(got, one, 1e-4, atol_share=1e-4, msg=f"{case} one rank")
    if case in CACHE_ROUNDING:
        assert np.abs(got - want).max() <= np.abs(one - want).max() + 1e-4
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3,
                                   err_msg=case)


def _held(out, case, rank=0):
    with open(out / f"serve_cache_{case}_{rank}.json") as f:
        return json.load(f)


def test_caches_hold_the_rank_block_of_their_spec(runs):
    """max_len 24 divides model 4 (and 2): the cache holds 24 / n
    positions of every kv head; 22 does not: yi-6b's 2 kv heads do not
    divide 4 either, so the cache is whole; at model 2 with max_len 23
    the heads split; whisper's self cache (22) splits its 4 heads.  The
    mamba states: ``tail_x`` the rank's din / 4 channels, ``ssm`` its 2 of
    8 heads (smoke) or, at head dim 64 (2 heads), its 16 of 64 channels;
    the B and C tails whole."""
    out, _ = runs
    want = {"yi_1x4": ([6, 2], [0, 6]),
            "yi_1x4_int8_whole": ([22, 2], None),
            "yi_2x2_heads": ([23, 1], None),
            "yi_2x2_int8": ([12, 2], [0, 12]),
            "qwen4b_1x4": ([6, 3], [0, 6]),
            "qwen4b_1x4_int8": ([6, 3], [0, 6]),
            "qwen4b_1x4_int8_whole": ([22, 3], None),
            "mixtral_1x4": ([6, 2], [0, 6]),
            "whisper_1x4": ([22, 1], None),
            "llava_1x4": ([9, 2], [0, 9]),
            "zamba2_1x4": ([6, 4], [0, 6])}
    for case, (held, positions) in want.items():
        for rank in range(WORLD):
            got = _held(out, case, rank)
            assert got["positions_heads"] == held, case
            m = rank % SERVE[case][1][1]  # the rank's model coordinate
            first = None if positions is None else \
                [positions[1] * m, positions[1]]
            assert got["kv_positions"] == first, (case, rank)
    assert _held(out, "whisper_1x4")["cross_positions"] == [0, 8]  # 32
    for case, mode in (("zamba2_1x4", "heads"), ("mamba2_1x4", "heads"),
                       ("mamba2_1x4_p", "p")):
        arch, _, over, _ = SERVE[case]
        cfg = TD._cfg(arch, **over)
        H, P, N, W = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_conv)
        lead = [cfg.num_layers, B]
        ssm = [H // WORLD, P] if mode == "heads" else [H, P // WORLD]
        for rank in range(WORLD):
            got = _held(out, case, rank)
            assert got["ssm_split"] == mode, case
            assert got["mamba"] == {
                "tail_x": lead + [W - 1, cfg.ssm_inner // WORLD],
                "tail_B": lead + [W - 1, N], "tail_C": lead + [W - 1, N],
                "ssm": lead + ssm + [N]}, (case, rank, got["mamba"])

@pytest.mark.parametrize("case", list(TRAIN))
def test_loss_gradients_and_step_match_jax_under_rules(runs, case):
    out, _ = runs
    a = np.load(out / f"train_port_{case}.npz")
    b = np.load(out / f"train_jax_{case}.npz")
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
    np.testing.assert_allclose(a["norm"], b["norm"], rtol=1e-5)
    TD._grads_close(a, b, case)
    lr = TD._run(TD._cfg(TRAIN[case][0])).learning_rate
    keys = [k for k in b.files if k.startswith("/")]
    assert keys and set(keys) == {k for k in a.files if k.startswith("/")}
    for k in keys:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=2 * lr,
                                   err_msg=f"{case} {k}")


# the mamba block's leaves the rules replicate over "model": each rank's
# heads (or head-dim channels) give a part of their gradients
MAMBA_REPLICATED = ("A_log", "D", "dt_bias", "w_B", "w_C", "w_dt", "conv_B",
                    "conv_C", "conv_B_b", "conv_C_b", "ln")


@pytest.mark.parametrize("case", list(TRAIN))
def test_replicated_gradients_are_equal_on_every_model_rank(runs, case):
    """Norms, routers, ``b_down``, and the mamba block's leaves the rules
    still replicate (``A_log``, ``D``, ``dt_bias``, ``w_B``, ``w_C``,
    ``w_dt``, ``conv_B``, ``conv_C`` and their biases, its norm): every
    leaf the rules do not split over ``model`` has one gradient on every
    model rank, bit for bit (summed over ``model`` where the ranks' blocks
    each give a part of it, nothing summed away)."""
    out, _ = runs
    for rank in range(WORLD):
        with open(out / f"train_rank_{case}_{rank}.json") as f:
            same = json.load(f)["replicated_equal"]
        assert same and all(same.values()), (case, rank, same)
    assert any("ln" in k for k in same)
    if TRAIN[case][0] in ("mamba2-130m", "zamba2-1.2b"):
        blocks = {k.split("/")[-1] for k in same if "/blocks/" in k}
        assert blocks == set(MAMBA_REPLICATED), (case, blocks)


def test_each_rank_computes_its_block(runs):
    """yi-6b at (1, 4): each rank's flash calls see 1 of 4 query heads
    (and the one kv head it reads), its MLP products 32 of 128 columns,
    its CE 64 of 256 vocab rows; qwen1.5-4b (3 heads) at (1, 4) attends
    with 4 of 16 query rows, all 3 heads; mamba2's CE 64 rows; the mamba
    blocks' SSD scan and decode steps (training and serving) see the
    rank's heads or head-dim channels and the gated norm its columns;
    MoE decode runs the rank's experts or its ffn slice of all."""
    out, _ = runs
    for rank in range(WORLD):
        def sizes(case):
            with open(out / f"train_rank_{case}_{rank}.json") as f:
                return json.load(f)["sizes"]
        yi = sizes("yi_1x4")
        assert yi == {"flash": [[S, 1, 1]], "mlp": [32], "ce": [64],
                      "ssd": [], "norm": [], "experts": []}, yi
        qw = sizes("qwen4b_1x4")
        assert qw["flash"] == [[S // 4, 3, 3]] and qw["ce"] == [64], qw
        assert qw["mlp"] == [96 // 4], qw
        assert sizes("qwen4b_2x2")["flash"] == [[S // 2, 3, 3]]
        # the mamba blocks: 2 of 8 SSM heads of 16 (or, at head dim 64,
        # both heads' 16 of 64 channels), the gated norm's 32 of 128
        mamba = {"ssd": [[2, 16]], "norm": [[32, 128]]}
        for case in ("mamba2_1x4", "mamba2_1x4_p", "zamba2_1x4"):
            got = sizes(case)
            assert {k: got[k] for k in mamba} == mamba, (case, got)
            served = _held(out, case, rank)["sizes"]
            assert {k: served[k] for k in mamba} == mamba, (case, served)
        assert sizes("mamba2_1x4")["ce"] == [64]
        # MoE decode: mixtral's 4 experts, one a rank, with all 128 ffn
        # columns; 6 experts (no multiple of 4) on 32 of 128 columns each
        assert _held(out, "mixtral_1x4", rank)["sizes"]["experts"] == \
            [[1, 128]]
        assert _held(out, "mixtral_1x4_ffn", rank)["sizes"]["experts"] == \
            [[6, 32]]


def test_checkpoint_saved_at_1x4_loads_at_one_rank(runs):
    """The state four ranks drew split over ``model`` and saved loads at
    one rank equal, bit for bit, to the one-rank draw; a one-rank
    checkpoint loads at (1, 4) as each rank's blocks of it."""
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.sharding import ShardingRules, use_rules
    from repro_torch.train import step as tstep
    out, ckpt = runs
    cfg = TD._cfg(CKPT_ARCH)
    loaded, _ = load_checkpoint(str(out / "ckpt_tp"))
    with use_rules(None):
        want = tstep.init_state(torch.Generator().manual_seed(0), cfg,
                                TD._run(cfg))
    fl, fw = TD._flat_t(loaded), TD._flat_t(want)
    assert set(fl) == set(fw)
    for path, t in fw.items():
        assert torch.equal(fl[path], torch.as_tensor(t).to(
            fl[path].dtype)), path
    one, _ = load_checkpoint(str(ckpt / "one"))
    sdefs = TD._flat_t(tstep.state_defs(cfg))
    flat_one = TD._flat_t(one)
    for rank in range(WORLD):
        got = TD._flat_t(torch.load(out / f"ckpt_blocks_{rank}.pt"))

        class _M:
            shape = {"data": 1, "model": 4}

            def coord(self, a, _r=rank):
                return {"data": 0, "model": _r}[a]
        r = ShardingRules(_M())
        for path, t in got.items():
            d = sdefs[path]
            blk = (flat_one[path] if d is None
                   else r.local_shard(flat_one[path], d.logical, d.shape))
            assert torch.equal(t, blk), (rank, path)
    assert any(t.shape != flat_one[p].shape for p, t in got.items())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_shards_merge_to_the_whole_vocab(dtype):
    """Four shards' (m, l, target logit) triples (``cross_entropy_partial
    _ref``, targets shifted by each shard's first id) merged by
    ``ce_merge_ref`` equal the whole vocab's statistics; targets on the
    shard boundaries included."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    T, D, V, n = 37, 24, 256, 4
    h = torch.randn((T, D), generator=g).to(dtype)
    w = (torch.randn((V, D), generator=g) * D ** -0.5).to(dtype)
    t = torch.randint(0, V, (T,), generator=g)
    t[:4] = torch.tensor([0, 63, 64, 255])
    nll, lse = ref.cross_entropy_stats_ref(h, w, t, block_v=48)
    vs = V // n
    parts = torch.stack([ref.cross_entropy_partial_ref(
        h, w[i * vs:(i + 1) * vs], t - i * vs, block_v=48)
        for i in range(n)])
    got_nll, got_lse = ref.ce_merge_ref(parts)
    torch.testing.assert_close(got_lse, lse, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(got_nll, nll, rtol=1e-6, atol=1e-5)
    # a target lies in one shard: the others add nothing
    assert (parts[:, :, 2] != 0).sum(0).max() == 1


def _within_ulp(got, want, dtype):
    """f32: rtol 1e-6 (atol 1e-6 of the largest); bf16: one ulp of want."""
    got, want = got.double(), want.double()
    if dtype == torch.float32:
        tol = 1e-6 * want.abs() + 1e-6 * want.abs().max()
    else:
        tol = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(
            2.0 ** -126))) - 7)
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_rows_of_the_rmsnorm_equal_the_whole_row(dtype):
    """Four column shards of each row through the split-row plain RMSNorm
    (``rmsnorm_stat_ref`` / ``rmsnorm_split_fwd_ref``, then
    ``rmsnorm_bwd_stat_ref`` / ``rmsnorm_split_bwd_ref``), the shards'
    statistics summed, equal the whole row's ``rmsnorm_fwd_ref`` /
    ``rmsnorm_bwd_ref`` (f32 rtol 1e-6, bf16 within one ulp); with one
    shard they are the whole row's bit for bit."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    D, n, eps = 128, 4, 1e-5
    x = torch.randn((3, 37, D), generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(D, generator=g)).to(dtype)
    gy = torch.randn((3, 37, D), generator=g).to(dtype)
    y, inv = ref.rmsnorm_fwd_ref(x, w, eps)
    dx, dw = ref.rmsnorm_bwd_ref(x, w, inv, gy)
    for k in (1, n):
        cols = [slice(i * D // k, (i + 1) * D // k) for i in range(k)]
        stat = sum(ref.rmsnorm_stat_ref(x[..., c].contiguous())
                   for c in cols)
        fwd = [ref.rmsnorm_split_fwd_ref(x[..., c], w[c], stat, D, eps)
               for c in cols]
        bstat = sum(ref.rmsnorm_bwd_stat_ref(x[..., c], w[c], f[1],
                                             gy[..., c])
                    for c, f in zip(cols, fwd))
        bwd = [ref.rmsnorm_split_bwd_ref(x[..., c], w[c], f[1], gy[..., c],
                                         bstat, D)
               for c, f in zip(cols, fwd)]
        got = (torch.cat([f[0] for f in fwd], -1), fwd[0][1],
               torch.cat([b[0] for b in bwd], -1),
               torch.cat([b[1] for b in bwd], -1))
        for a, b in zip(got, (y, inv, dx, dw)):
            if k == 1:
                assert torch.equal(a, b)
            else:
                _within_ulp(a, b, dtype if a.dtype == dtype
                            else torch.float32)


def test_ssd_plain_path_on_a_zero_padded_head_dim_equals_it_unpadded():
    """The SSD kernels' wrapper pads a head dim that is no multiple of 8
    (mamba2-130m's P 64 over 16 ranks: 4) with zeros and cuts the results
    back; on the plain path the same padding leaves y, the final state and
    every gradient of ``ssd_bwd_ref`` bit for bit as they were."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    B_, S_, H, P, N, chunk = 2, 50, 3, 4, 16, 32
    x, dy = (torch.randn((B_, S_, H, P), generator=g) for _ in range(2))
    dt = torch.rand((B_, S_, H), generator=g) * 0.5 + 0.01
    A = -torch.rand(H, generator=g) - 0.1
    Bm, Cm = (torch.randn((B_, S_, 1, N), generator=g) for _ in range(2))
    h0, dh = (torch.randn((B_, H, P, N), generator=g) for _ in range(2))
    pad_x = lambda t: F.pad(t, (0, 8 - P))  # noqa: E731
    pad_h = lambda t: F.pad(t, (0, 0, 0, 8 - P))  # noqa: E731
    y, h = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, init_state=h0,
                       return_state=True)
    yp, hp = ref.ssd_ref(pad_x(x), dt, A, Bm, Cm, chunk=chunk,
                         init_state=pad_h(h0), return_state=True)
    assert torch.equal(yp[..., :P], y) and torch.equal(hp[:, :, :P], h)
    assert not yp[..., P:].any()
    want = ref.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, chunk=chunk, init_state=h0,
                           d_state=dh)
    got = list(ref.ssd_bwd_ref(pad_x(x), dt, A, Bm, Cm, pad_x(dy),
                               chunk=chunk, init_state=pad_h(h0),
                               d_state=pad_h(dh)))
    got[0], got[5] = got[0][..., :P], got[5][:, :, :P]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
