"""The dry run's per-device counts (``repro_torch.launch.dryrun.count_cell``
with a mesh): one rank of a cell counted on the meta device under
``ShardingRules`` over an abstract mesh, its collectives charged by kind
and not run; on the CPU, at smoke size.

- a KV cache split over ``kv_seq`` is marked by its storage's identity:
  two meta caches keep their own blocks, and a split cache counts the
  same wherever it falls in a sweep (every meta storage's address is 0);
- at (4, 1) the per-device FLOPs are the one-card count's quarter,
  exactly, for every family's prefill, decode and train step, in kernel
  and plain mode, but for kernel mode's AdamW FLOPs on the leaves a rank
  holds whole;
- every rank of (2, 2) counts the same collectives by kind, peak and
  calls; the data coordinate changes nothing; the model coordinate
  changes only what depends on the positions a rank holds (its writes
  into a cache split over ``kv_seq``, and where the heads do not divide,
  the visible pairs of its query rows), asserted at its exact size;
- a collective on an abstract mesh takes meta tensors only;
- plain-mode per-device FLOPs against ``hlo_cost.analyze`` of the JAX
  steps compiled under ``use_rules`` with ``lower_cell``'s shardings on an
  Auto mesh of 4 host devices (a JAX subprocess), at (4, 1), (1, 4) and
  (2, 2) for yi-6b and mamba2-130m: equal, or each difference at its
  exact size with its cause;
- on 4 ``gloo`` ranks (subprocesses of this file over a ``file://``
  store), yi-6b and zamba2-1.2b split at (1, 4) and (2, 2): each rank's
  tally of the bytes its collectives moved, by kind, over a prefill, a
  decode step and a train step, equals the meta count at its coordinate;
  at (1, 4) both equal the collectives' formula (PERF.md §3).

Inputs are abstract (shapes and dtypes) but for the gloo ranks', whose
tokens come from numpy with a seed and whose weights are drawn from a
torch seed.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_distributed as TD  # noqa: E402

from repro_torch.configs.base import (RunConfig, ShapeConfig,  # noqa: E402
                                      get_smoke_config)
from repro_torch.kernels import adamw as kadamw  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.sharding import ShardingRules, use_rules  # noqa: E402

HERE = os.path.abspath(__file__)
AXES = ("data", "model")
B, S = 8, 64  # the counted cells: 8 rows split over up to 4 data ranks
FAMILIES = ["yi-6b", "qwen1.5-4b", "mixtral-8x7b", "mamba2-130m",
            "zamba2-1.2b", "whisper-tiny", "llava-next-mistral-7b"]
KINDS = ["prefill", "decode", "train"]
JAX_ARCHS = ["yi-6b", "mamba2-130m"]
JAX_MESHES = [(4, 1), (1, 4), (2, 2)]
PLAIN_TRAIN = dict(remat="none", ce_mode="direct")  # test_torch_cost's
# the gloo ranks' path: TB x TS prompts and batches, caches of TMAX
WORLD, TP_ARCHS, TP_MESHES = 4, ["yi-6b", "zamba2-1.2b"], [(1, 4), (2, 2)]
TB, TS, TMAX = 4, 16, 24
TP_TRAIN = RunConfig(remat="none")


def _mesh(shape, coords=None) -> Mesh:
    return Mesh(shape, AXES, coords=coords)


def _count(arch, kind, mesh=None, mode="kernel", **run_kw):
    return dryrun.count_cell(get_smoke_config(arch),
                             ShapeConfig("s", S, B, kind),
                             RunConfig(**run_kw), mesh=mesh, mode=mode)


# --- the kv_seq marks on meta ---------------------------------------------

def test_meta_caches_keep_their_own_blocks():
    """Two meta KV stacks marked with different blocks each keep theirs,
    also after the first is freed (their storages' addresses are both 0;
    their identities differ), and a view reads its stack's mark."""
    a = torch.empty(2, 4, 8, 2, 16, device="meta")
    b = torch.empty(2, 4, 8, 2, 16, device="meta")
    L.mark_kv_positions(a, 0, 8)
    L.mark_kv_positions(b, 24, 8)
    assert L.kv_positions({"k": a[1]}) == (0, 8)
    assert L.kv_positions({"k": b[1]}) == (24, 8)
    del a
    gc.collect()
    assert L.kv_positions({"k": b[0]}) == (24, 8)


def test_kv_seq_split_meta_cache_counts_the_same_at_every_position():
    """yi-6b's decode at (1, 4), whose cache splits over ``kv_seq``: the
    same count alone, after other cells, with another rank's marked cache
    alive, and with an earlier cell's cache freed in the middle of the
    count (after the counted cache is marked), as a sweep's garbage
    collection may free it."""
    cfg = get_smoke_config("yi-6b")
    shape = ShapeConfig("s", S, B, "decode")
    mesh = _mesh((1, 4))
    run = RunConfig()
    want = dryrun.count_cell(cfg, shape, mesh=mesh)
    assert want["collective_bytes"] > 0
    with use_rules(ShardingRules(mesh)):
        assert L.kv_positions(P.layer(engine.abstract_cache(cfg, B, S),
                                      0)) == (0, S // 4)
    for arch in ("zamba2-1.2b", "whisper-tiny"):
        dryrun.count_cell(get_smoke_config(arch), shape, mesh=mesh)
    assert dryrun.count_cell(cfg, shape, mesh=mesh) == want
    with use_rules(ShardingRules(_mesh((1, 4), (0, 2)))):
        other = engine.abstract_cache(cfg, B, S)
    assert dryrun.count_cell(cfg, shape, mesh=mesh) == want

    def step(params, tokens, pos):
        cache = engine.abstract_cache(cfg, B, S)
        held.clear()  # the earlier cell's cache goes
        gc.collect()
        return engine.decode_step(params, tokens, cache, pos, cfg=cfg,
                                  run=run)

    from repro_torch.launch import cost
    with use_rules(ShardingRules(mesh)), torch.inference_mode():
        held = [engine.abstract_cache(cfg, B, S)]
        params = P.abstract(registry.param_defs(cfg))
        specs = registry.input_specs(cfg, shape)
        got = cost.analyze(step, params, specs["tokens"], specs["pos"])
    for key in ("flops", "collective_bytes", "calls"):
        assert got[key] == want[key], key
    assert L.kv_positions(P.layer(other, 0)) == (2 * S // 4, S // 4)


# --- (4, 1): the data ranks split the one-card count ---------------------

def _whole_adamw_flops(cfg, mesh) -> float:
    """Kernel mode's AdamW FLOPs that a rank of ``mesh`` counts in full:
    the norm and the update of each leaf it holds whole (a norm's weight,
    replicated) and the finalize."""
    defs = list(P.tree_leaves(registry.param_defs(cfg)))
    with use_rules(ShardingRules(mesh)):
        local = list(P.tree_leaves(P.abstract(registry.param_defs(cfg))))
    flops = kadamw.final_work(len(defs))[0]
    for d, t in zip(defs, local):
        if tuple(t.shape) == tuple(d.shape):
            flops += kadamw.norm_work(t)[0] + kadamw.update_work(
                t, t, t, t, clip=True, decay=t.dim() >= 2)[0]
    return flops


@pytest.mark.parametrize("mode", ["kernel", "plain"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_four_data_ranks_each_count_a_quarter_of_one_card(arch, kind, mode):
    """At (4, 1) a device runs 2 of the 8 rows on the whole weights
    (ZeRO-3: gathered a layer at a time): its FLOPs are exactly a quarter
    of the one-card count, but for AdamW's on the leaves it holds whole
    and its finalize (kernel mode; the plain mode counts no elementwise
    FLOPs), its collectives the gathers (and the train step's gradient
    reduce-scatters and norm sums)."""
    one = _count(arch, kind, mode=mode)
    mesh = _mesh((4, 1))
    dev = _count(arch, kind, mesh, mode=mode)
    assert one["collective_bytes"] == 0
    whole = (_whole_adamw_flops(get_smoke_config(arch), mesh)
             if (kind, mode) == ("train", "kernel") else 0)
    assert dev["flops"] * 4 == one["flops"] + 3 * whole
    assert dev["calls"] == one["calls"]
    assert dev["coll_all-gather"] > 0
    assert ("coll_reduce-scatter" in dev) == (kind == "train")


# --- (2, 2): every rank counts the same ----------------------------------

def _written_bytes(cfg, kind, coords) -> int:
    """Bytes the counted step's writes into KV caches split over
    ``kv_seq`` move on the rank at ``coords`` of (2, 2): the rows of its
    block that the step writes (prefill: the prompt, a VLM's patches
    first, and whisper's encoder frames into its cross cache; decode: the
    new position, ``seq_len - 1``), each moved twice (read and written,
    as the counter charges a scatter)."""
    max_len = S + cfg.num_img_patches + 8 if kind == "prefill" else S
    with use_rules(ShardingRules(_mesh((2, 2), coords))):
        cache = engine.abstract_cache(cfg, B // 2, max_len)
    total = 0

    def walk(tree, name=""):
        nonlocal total
        if not isinstance(tree, dict):
            return
        if "k" in tree and "v" in tree:
            block = L.kv_positions(P.layer(tree, 0))
            if block is None:
                return
            if kind == "decode":
                lo, hi = (S - 1, S) if name != "cross" else (0, 0)
            elif name == "cross":
                lo, hi = 0, cfg.encoder_frames
            else:
                lo, hi = 0, S + cfg.num_img_patches
            rows = max(min(hi, sum(block)) - max(lo, block[0]), 0)
            for k in ("k", "v"):
                t = tree[k]
                total += 2 * rows * t.numel() // t.shape[2] \
                    * t.element_size()
            return
        for k, v in tree.items():
            walk(v, k)
    walk(cache)
    return total


def _query_row_charges(cfg, kind, model_coord):
    """(FLOPs, bytes) charged to a rank's flash attention where the heads
    do not divide ``model`` and the rank runs its half of the query rows
    (``"q_seq"``) against every key: its visible pairs depend on where its
    rows lie.  The train step (remat "full") runs the forward twice (with
    the statistic) and the backward once a layer."""
    if cfg.num_heads % 2 == 0 or kind == "decode":
        return 0.0, 0
    dt = getattr(torch, cfg.dtype)
    q = torch.empty(B // 2, S // 2, cfg.num_heads, cfg.head_dim,
                    dtype=dt, device="meta")
    k = torch.empty(B // 2, S, cfg.num_kv_heads, cfg.head_dim, dtype=dt,
                    device="meta")
    off = model_coord * S // 2
    if kind == "prefill":
        parts = [kflash.work(q, k, q_offset=off)]
    else:
        fwd = kflash.work(q, k, q_offset=off, lse=True)
        parts = [fwd, fwd, kflash.bwd_work(q, k, q_offset=off)]
    return (cfg.num_layers * sum(f for f, _ in parts),
            cfg.num_layers * sum(b for _, b in parts))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_rank_of_2x2_counts_the_same(arch, kind):
    """The four ranks of (2, 2): the same collectives by kind, peak and
    calls on every rank; the same FLOPs and bytes on the two data ranks of
    a model coordinate; between the model coordinates, FLOPs and bytes
    differ exactly by the charges that depend on the positions a rank
    holds (``_written_bytes``, ``_query_row_charges``), so the rank at
    coordinate 0 stands for every device up to them."""
    cfg = get_smoke_config(arch)
    counts = {c: _count(arch, kind, _mesh((2, 2), c))
              for c in [(0, 0), (0, 1), (1, 0), (1, 1)]}
    first = counts[(0, 0)]
    coll = {k: v for k, v in first.items() if k.startswith("coll")}
    assert coll["collective_bytes"] > 0
    for c, got in counts.items():
        assert {k: v for k, v in got.items() if k.startswith("coll")} \
            == coll, c
        assert got["peak_bytes"] == first["peak_bytes"], c
        assert got["calls"] == first["calls"], c
    for m in (0, 1):
        assert counts[(0, m)] == counts[(1, m)]
    one = counts[(0, 1)]
    want_flops = want_bytes = 0
    for sign, m in ((1, 1), (-1, 0)):
        f, b = _query_row_charges(cfg, kind, m)
        want_flops += sign * f
        want_bytes += sign * (b + _written_bytes(cfg, kind, (0, m)))
    assert one["flops"] - first["flops"] == want_flops
    assert one["hbm_bytes"] - first["hbm_bytes"] == want_bytes
    if arch == "qwen1.5-4b" and kind != "decode":
        assert want_flops > 0  # the later rows see more keys


# --- collectives on an abstract mesh --------------------------------------

@pytest.mark.parametrize("collective", ["all_reduce", "all_gather",
                                        "reduce_scatter"])
def test_abstract_mesh_collective_takes_meta_tensors_only(collective):
    """On an abstract mesh a collective is charged and not run: a meta
    tensor gets the result's shape, any other tensor raises (a run
    without a process group must not go on as if it had summed)."""
    from repro_torch.launch import cost
    rules = ShardingRules(_mesh((2, 4), (1, 3)))
    call = {"all_reduce": lambda x: rules.all_reduce(x, ("data", "model")),
            "all_gather": lambda x: rules.all_gather(x, 0,
                                                     ("data", "model")),
            "reduce_scatter": lambda x: rules.reduce_scatter(x, 0,
                                                             "model")}[
        collective]
    x = torch.empty(8, 3, dtype=torch.bfloat16, device="meta")
    res = cost.analyze(lambda t: call(t), x)
    kind = collective.replace("_", "-")
    n = x.numel() * 2
    want, shape = {"all_reduce": (2 * n, (8, 3)),
                   "all_gather": (n + 4 * n, (64, 3)),  # model, then data
                   "reduce_scatter": (n, (2, 3))}[collective]
    assert res[f"coll_{kind}"] == res["collective_bytes"] == want
    assert tuple(call(x).shape) == shape
    with pytest.raises(ValueError, match="meta tensors only"):
        call(torch.zeros(8, 3))


# --- against JAX's per-device walk (a subprocess of 4 host devices) ------

def _jax_main(out):
    """``hlo_cost.analyze`` of JAX_ARCHS' smoke prefill, decode and train
    steps compiled under ``use_rules`` with ``lower_cell``'s shardings on
    an Auto mesh of each JAX_MESHES shape; writes ``jax.json`` and each
    program's HLO text."""
    import jax
    jax.devices()  # the backend first: the dryrun import's XLA_FLAGS
    from jax.sharding import AxisType  # come too late to change it

    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.configs.base import get_smoke_config as j_smoke
    from repro.launch import dryrun as jd
    from repro.launch import hlo_cost
    from repro.models import params as JP
    from repro.models import registry as jreg
    from repro.serve import engine as jengine
    from repro.sharding import ShardingRules as JRules
    from repro.sharding import param_shardings
    from repro.sharding import use_rules as j_use_rules
    from repro.train import step as jstep

    res = {}
    for shape in JAX_MESHES:
        devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        rules = JRules(jax.sharding.Mesh(devs, AXES,
                                         axis_types=(AxisType.Auto,) * 2))
        for arch in JAX_ARCHS:
            cfg = j_smoke(arch)
            defs = jreg.param_defs(cfg)
            for kind in KINDS:
                run = JRunConfig(**PLAIN_TRAIN) if kind == "train" \
                    else JRunConfig()
                specs = jreg.input_specs(cfg, JShapeConfig("s", S, B, kind))
                with j_use_rules(rules):
                    if kind == "train":
                        st_sh = jd.state_shardings(cfg, run, rules)
                        lowered = jax.jit(
                            jstep.make_train_step(cfg, run),
                            in_shardings=(st_sh,
                                          jd.batch_shardings(rules, specs)),
                            out_shardings=(st_sh, None),
                            donate_argnums=(0,)).lower(
                                jstep.abstract_state(cfg, run), specs)
                    elif kind == "prefill":
                        max_len = S + cfg.num_img_patches + 8
                        c_sh = jd.cache_shardings(cfg, rules, B, max_len)
                        lowered = jax.jit(
                            jengine.make_prefill_step(cfg, run),
                            in_shardings=(param_shardings(defs, rules),
                                          jd.batch_shardings(rules, specs),
                                          c_sh),
                            out_shardings=(None, c_sh),
                            donate_argnums=(2,)).lower(
                                JP.abstract(defs), specs,
                                jengine.abstract_cache(cfg, B, max_len))
                    else:
                        c_sh = jd.cache_shardings(cfg, rules, B, S)
                        tok_sh = rules.sharding(("batch", None), (B, 1))
                        lowered = jax.jit(
                            jengine.make_decode_step(cfg, run),
                            in_shardings=(param_shardings(defs, rules),
                                          tok_sh, c_sh, None),
                            out_shardings=(tok_sh, c_sh),
                            donate_argnums=(2,)).lower(
                                JP.abstract(defs), specs["tokens"],
                                jengine.abstract_cache(cfg, B, S),
                                specs["pos"])
                text = lowered.compile().as_text()
                name = f"{arch}_{kind}_{shape[0]}x{shape[1]}"
                with open(os.path.join(out, name + ".hlo"), "w") as f:
                    f.write(text)
                res[name] = hlo_cost.analyze(text)["flops"]
    with open(os.path.join(out, "jax.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def jax_walk(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_mesh_jax")
    p = subprocess.run(
        [sys.executable, HERE, "jax", str(out)], capture_output=True,
        text=True, timeout=900, env=TD._env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-3000:]
    with open(out / "jax.json") as f:
        return out, json.load(f)


def _kv_whole_flops(cfg, shape, kind) -> float:
    """Where the kv heads do not divide ``model``, each model rank
    projects K and V whole (``model_whole``), while GSPMD splits the
    flattened ``qkv`` columns: (1 - 1 / model) of the two projections
    more, in the forward, and twice that again in the backward."""
    data, model = shape
    if cfg.num_kv_heads % model == 0:
        return 0.0
    tokens = B // data * (1 if kind == "decode" else S)
    fwd = 2 * 2.0 * tokens * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
    return cfg.num_layers * fwd * (1 - 1 / model) * (
        3 if kind == "train" else 1)


def _cache_length_flops(cfg, shape) -> float:
    """JAX's prefill under a model split attends over the whole cache's
    ``max_len`` keys (S + 8, the last 8 masked); the port's prefill over
    the prompt's S: Q Kᵀ and P V of 8 keys more a query row and head."""
    data, model = shape
    if model == 1:
        return 0.0
    heads = cfg.num_heads // model
    return cfg.num_layers * 2 * 2.0 * (B // data) * heads * S * 8 \
        * cfg.head_dim


def _replicated_bc_flops(cfg, shape, kind) -> float:
    """At (2, 2) GSPMD splits over ``model`` the mamba block's B and C
    projections (d -> 2 N, replicated over ``model``), which the port
    computes whole on each model rank: half of them, in decode's forward
    and in the train step's weight gradient."""
    data, model = shape
    if shape != (2, 2) or kind == "prefill":
        return 0.0
    tokens = B // data * (1 if kind == "decode" else S)
    return 0.5 * cfg.num_layers * 2.0 * tokens * cfg.d_model \
        * 2 * cfg.ssm_state


@pytest.mark.parametrize("shape", JAX_MESHES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_plain_per_device_flops_against_jax_under_rules(jax_walk, arch, kind,
                                                        shape):
    """Plain mode (the plain path op by op) per device against the JAX
    program's per-device walk: equal at (4, 1) but for the one-card
    differences of tests/test_torch_cost.py (the SSM decode's rewritten
    convolution; the SSD and depthwise-convolution backwards), each at its
    local shapes; under a model split, GSPMD's own choices differ from the
    port's Megatron layout by ``_kv_whole_flops``, ``_cache_length_flops``
    and ``_replicated_bc_flops``, at their exact sizes."""
    import test_torch_cost as TC
    out, walk = jax_walk
    name = f"{arch}_{kind}_{shape[0]}x{shape[1]}"
    want = walk[name]
    kw = PLAIN_TRAIN if kind == "train" else {}
    got = _count(arch, kind, _mesh(shape), mode="plain", **kw)["flops"]
    cfg = get_smoke_config(arch)
    data, model = shape
    rows = B // data
    if cfg.family == "ssm":
        text = (out / f"{name}.hlo").read_text()
        j_conv = TC._jax_conv_flops(text)
        conv = 2.0 * rows * (1 if kind == "decode" else S) * cfg.ssm_conv \
            * (cfg.ssm_inner // model + 2 * cfg.ssm_state) * cfg.num_layers
        if kind == "prefill":
            extra = 0.0
        elif kind == "decode":
            assert j_conv == 0  # XLA's multiply and reduce
            extra = conv
        else:
            H, Pd, N = cfg.ssm_heads // model, cfg.ssm_head_dim, \
                cfg.ssm_state
            t_ssd, j_ssd = TC._ssd_fwd_bwd(cfg.ssm_chunk, (
                ((rows, S, H, Pd), torch.bfloat16),
                ((rows, S, H), torch.float32), ((H,), torch.float32),
                ((rows, S, 1, N), torch.bfloat16)))
            assert t_ssd != j_ssd and 3 * conv != j_conv
            extra = cfg.num_layers * (t_ssd - j_ssd) + (3 * conv - j_conv)
        extra += _replicated_bc_flops(cfg, shape, kind)
    else:
        extra = _kv_whole_flops(cfg, shape, kind)
        if kind == "prefill":
            extra -= _cache_length_flops(cfg, shape)
    assert got - want == extra, (got, want)


# --- 4 gloo ranks: the tally of what moved against the count -------------

def _tp_path(cfg, rules) -> dict:
    """A rank's prefill (TB x TS, cache TMAX), one decode step and one
    train step (TP_TRAIN) under ``rules``, the collective tally reset
    before and read after each."""
    from repro_torch.sharding import (batch_split, collective_tally,
                                      reset_collective_tally)
    from repro_torch.train import step as tstep
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TB, TS)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TB, TS)))
    out = {}
    with use_rules(rules):
        params = P.materialize(registry.param_defs(cfg),
                               torch.Generator().manual_seed(1), "cpu")
        split = rules.local_batch({"tokens": tokens})
        prompt, rows, axes = split or ({"tokens": tokens}, TB, ())
        cache = engine.init_cache(cfg, rows, TMAX, "cpu")
        with torch.inference_mode(), batch_split(rows, axes):
            reset_collective_tally()
            tok, cache = engine.prefill_step(params, prompt, cache, cfg=cfg,
                                             run=RunConfig())
            out["prefill"] = collective_tally()
            reset_collective_tally()
            engine.decode_step(params, tok, cache, TS, cfg=cfg,
                               run=RunConfig())
            out["decode"] = collective_tally()
        state = tstep.init_state(torch.Generator().manual_seed(2), cfg,
                                 TP_TRAIN)
        batch = {"tokens": tokens, "labels": labels,
                 "loss_mask": torch.ones(TB, TS)}
        reset_collective_tally()
        tstep.train_step(state, batch, cfg=cfg, run=TP_TRAIN)
        out["train"] = collective_tally()
    return out


def _torch_main(rank, store, out):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    torch.set_num_threads(1)
    res = {}
    for arch in TP_ARCHS:
        for shape in TP_MESHES:
            rules = ShardingRules(make_mesh(shape, AXES, "cpu"))
            res[f"{arch}_{shape[0]}x{shape[1]}"] = {
                "coords": [rules.mesh.coord(a) for a in AXES],
                **_tp_path(get_smoke_config(arch), rules)}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def rank_tallies(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_mesh_ranks")
    store = str(out / "store")
    procs = [subprocess.Popen(
        [sys.executable, HERE, "torch", str(rank), store, str(out)],
        env=TD._env()) for rank in range(WORLD)]
    try:
        for p in procs:
            assert p.wait(timeout=600) == 0, p.args
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = []
    for rank in range(WORLD):
        with open(out / f"rank{rank}.json") as f:
            ranks.append(json.load(f))
    return ranks


def _tp_count(arch, kind, shape, coords) -> dict:
    cfg = get_smoke_config(arch)
    if kind == "prefill":
        shp, run, kw = ShapeConfig("s", TS, TB, kind), RunConfig(), \
            {"max_len": TMAX}
    elif kind == "decode":
        shp, run, kw = ShapeConfig("s", TMAX, TB, kind), RunConfig(), {}
    else:
        shp, run, kw = ShapeConfig("s", TS, TB, kind), TP_TRAIN, {}
    res = dryrun.count_cell(cfg, shp, run, mesh=_mesh(shape, coords), **kw)
    return {k[len("coll_"):]: v for k, v in res.items()
            if k.startswith("coll_")}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", TP_MESHES)
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_rank_tally_equals_the_meta_count(rank_tallies, arch, shape, kind):
    """Each gloo rank's bytes moved by kind (its real collectives over the
    process groups) equal the count of the same step on meta at an
    abstract mesh standing for that rank."""
    key = f"{arch}_{shape[0]}x{shape[1]}"
    for rank, res in enumerate(rank_tallies):
        coords = tuple(res[key]["coords"])
        assert coords == divmod(rank, shape[1])
        want = _tp_count(arch, kind, shape, coords)
        assert res[key][kind] == want, (rank, coords)
        assert sum(want.values()) > 0


def _formula(arch, kind) -> dict:
    """The collectives of one rank at (1, 4) (PERF.md §3), bf16, by kind.
    Every split region starts with ``enter_model`` and ends with
    ``leave_model``: the embedding, each attention and MLP (and each mamba
    block's out projection) all-reduce their activations forward; in the
    backward each region's input gradient is all-reduced (the CE's too).
    A mamba block adds a (rows,) f32 statistic each way and, backward, the
    gradient sums of the leaves it uses whole.  The CE all-gathers (T, 3)
    f32 triples; serving all-gathers the last position's f32 logits.
    yi-6b's 2 kv heads do not divide 4: its K / V weights are gathered
    whole and their gradients reduce-scattered.  zamba2's kv heads do, and
    its cache holds every head of its positions: K / V are all-gathered
    over heads before the write; a decode step gathers q over heads and
    each rank's partial softmax (its f32 output and two statistics a
    head)."""
    from repro_torch.models import mamba2 as M
    cfg = get_smoke_config(arch)
    m, e, d, hd = 4, 2, cfg.d_model, cfg.head_dim
    T = TB if kind == "decode" else TB * TS
    act = T * d * e
    hybrid = cfg.family == "hybrid"
    A = cfg.num_layers // cfg.attn_every if hybrid else cfg.num_layers
    Lm = cfg.num_layers if hybrid else 0
    ar = (1 + 2 * A + Lm) * act + Lm * T * 4
    ag = rs = 0
    kv_weights = 2 * A * d * cfg.num_kv_heads * hd * e  # whole, bf16
    if cfg.num_kv_heads % m:
        ag += kv_weights // m
    if kind != "train":
        ag += TB * cfg.vocab_size // m * 4
        if cfg.num_kv_heads % m == 0:
            ag += 2 * A * T * cfg.num_kv_heads // m * hd * e
        if kind == "decode":
            ag += A * TB * cfg.num_heads // m * hd * e
            ag += A * TB * cfg.num_heads * (hd + 2) * 4
    else:
        ag += T * 3 * 4
        ar += (1 + 2 * A + Lm) * act + Lm * T * 4
        if cfg.num_kv_heads % m:
            rs += kv_weights
        if hybrid:
            defs = P.unstack(M.block_defs(cfg, 1))
            ar += Lm * sum(
                int(np.prod(defs[k].shape)) * defs[k].dtype.itemsize
                for k in ("w_B", "w_C", "w_dt", "conv_B", "conv_C",
                          "conv_B_b", "conv_C_b", "dt_bias", "A_log", "D"))
        rules = ShardingRules(_mesh((1, 4)))
        split = [d_ for d_ in P.tree_leaves(registry.param_defs(cfg))
                 if "model" in {a for ax in rules.spec(d_.logical, d_.shape)
                                for a in (ax if isinstance(ax, tuple)
                                          else (ax,)) if a}]
        ar += 4 * len(split)  # the global norm: each split leaf's sum
    out = {"all-reduce": ar, "all-gather": ag, "reduce-scatter": rs}
    return {k: float(v) for k, v in out.items() if v}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_rank_tally_equals_the_formula_at_1x4(rank_tallies, arch, kind):
    want = _formula(arch, kind)
    for res in rank_tallies:
        assert res[f"{arch}_1x4"][kind] == want


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2])
    else:
        _torch_main(int(sys.argv[2]), *sys.argv[3:5])
    sys.exit(0)
