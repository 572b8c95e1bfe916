"""The port's multi-rank path on the CPU: 4 ``gloo`` ranks (a file store
each run), f32 smoke configs, held against the JAX package under
``use_rules`` on an Auto mesh of the same shape, and against one rank.

The reference and the ranks run as subprocesses of this file, started
together by a module fixture: ``python tests/test_torch_distributed.py
jax OUT`` (4 host devices, ``XLA_FLAGS`` set in that process alone) and
``... torch RANK STORE OUT CKPT`` four times.  Both draw the same weights
and batches from numpy seeds; each writes its results under ``OUT``.

- ``moe_block`` (the shardmap path) at (1, 4), (2, 2) and (4, 1) for
  qwen3-moe (experts split over "model") and mixtral, and mixtral with 6
  experts at (1, 4), where E does not divide and each rank runs every
  expert on its ffn slice: output, loss and gradients against JAX's;
- the shardmap path against the gspmd one at B 2, and the port's prefill
  under rules against the JAX prefill under rules (in this process, one
  device): the entry-point MoE semantics;
- the first batch's gradients, then two yi-6b train steps and one
  mixtral step, at (2, 2) against one rank and against
  ``grads_and_metrics`` / ``make_train_step`` under rules on a (2, 2)
  mesh;
- checkpoints written at 4 ranks load at 1, and the other way round, bit
  for bit.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(os.path.dirname(HERE)), "src")
WORLD = 4
MOE = "qwen3-moe-235b-a22b", "mixtral-8x7b"
MOE_CASES = {  # name: (arch, mesh, config overrides)
    "qwen3_1x4": (MOE[0], (1, 4), {}),
    "qwen3_2x2": (MOE[0], (2, 2), {}),
    "qwen3_4x1": (MOE[0], (4, 1), {}),
    "mixtral_1x4": (MOE[1], (1, 4), {}),
    "mixtral_2x2": (MOE[1], (2, 2), {}),
    "mixtral_4x1": (MOE[1], (4, 1), {}),
    "mixtral_e6_fslice_1x4": (MOE[1], (1, 4), {"num_experts": 6}),
}
TRAIN = {"yi-6b": 2, "mixtral-8x7b": 1}  # arch: steps
TRAIN_B, TRAIN_S, MOE_B, MOE_S = 4, 16, 4, 8
CKPT_ARCH = "mixtral-8x7b"


# ---------------------------------------------------------------------------
# Inputs both sides draw from numpy
# ---------------------------------------------------------------------------


def _cfg(arch, **over):
    from repro_torch.configs.base import get_smoke_config
    return get_smoke_config(arch).replace(**over)


def _moe_inputs(cfg):
    rng = np.random.default_rng(7)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": rng.normal(size=(d, E)) * 0.3,
         "w_gate": rng.normal(size=(E, d, f)) * d ** -0.5,
         "w_up": rng.normal(size=(E, d, f)) * d ** -0.5,
         "w_down": rng.normal(size=(E, f, d)) * f ** -0.5}
    x = rng.normal(size=(MOE_B, MOE_S, d))
    r = rng.normal(size=(MOE_B, MOE_S, d))
    f32 = lambda a: a.astype(np.float32)
    return {k: f32(v) for k, v in p.items()}, f32(x), f32(r)


def _np_params(cfg, seed=0):
    """A param tree of f32 numpy arrays for the port's defs of ``cfg``."""
    from repro_torch.models import params as TP
    from repro_torch.models import registry
    rng = np.random.default_rng(seed)

    def leaf(d):
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        if d.init == "zeros":
            return (rng.normal(size=d.shape) * 0.01).astype(np.float32)
        fan = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        s = 0.02 if d.init == "normal" else fan ** -0.5
        return (rng.normal(size=d.shape) * s).astype(np.float32)
    return TP.tree_map(leaf, registry.param_defs(cfg))


def _np_batch(cfg, i):
    rng = np.random.default_rng(100 + i)
    shape = (TRAIN_B, TRAIN_S)
    mask = np.ones(shape, np.float32)
    mask[0, -5:] = 0.0  # the ranks hold different counts of valid tokens
    mask[3, :2] = 0.0
    return {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
            "loss_mask": mask}


def _train_cfg(arch, no_drops=False):
    cfg = _cfg(arch)
    if no_drops and cfg.num_experts:
        cfg = cfg.replace(moe_capacity_factor=cfg.num_experts
                          / cfg.num_experts_per_tok)
    return cfg


def _run(cfg):
    from repro_torch.launch.train import default_run_config
    return default_run_config(cfg, 3).replace(ce_dtype="float32")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32) if not isinstance(
        tree, torch.Tensor) else tree.detach().float().numpy()}


# ---------------------------------------------------------------------------
# The JAX reference (its own process: 4 host devices)
# ---------------------------------------------------------------------------


def _jax_main(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import get_smoke_config as j_smoke
    from repro.models import layers as JL
    from repro.optim import adamw_init as j_adamw_init
    from repro.sharding import ShardingRules as JRules
    from repro.sharding import use_rules as j_use_rules
    from repro.train.step import grads_and_metrics as j_grads
    from repro.train.step import make_train_step as j_make_train_step

    def mesh(shape):
        devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        return jax.sharding.Mesh(devs, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)

    for name, (arch, shape, over) in MOE_CASES.items():
        cfg = j_smoke(arch).replace(**over)
        p, x, r = _moe_inputs(_cfg(arch, **over))
        run = JRunConfig()
        with j_use_rules(JRules(mesh(shape))):
            loss = lambda p, x: jnp.sum(JL.moe_block(p, cfg, run, x) * r)
            (val, (gp, gx)) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1)))(p, x)
            y = jax.jit(lambda p, x: JL.moe_block(p, cfg, run, x))(p, x)
        res = {"y": y, "loss": val, "dx": gx,
               **{f"d_{k}": v for k, v in gp.items()}}
        np.savez(os.path.join(out, f"moe_{name}.npz"),
                 **{k: np.asarray(v) for k, v in res.items()})

    for arch, steps in TRAIN.items():
        tcfg = _train_cfg(arch)
        run = _run(tcfg)
        jrun = JRunConfig(total_steps=run.total_steps,
                          warmup_steps=run.warmup_steps,
                          ce_block_v=run.ce_block_v, ce_dtype=run.ce_dtype)
        jp = jax.tree.map(jnp.asarray, _np_params(tcfg))
        state = {"params": jp, "opt": j_adamw_init(jp)}
        losses, norms = [], []
        with j_use_rules(JRules(mesh((2, 2)))):
            b0 = {k: jnp.asarray(v) for k, v in _np_batch(tcfg, 0).items()}
            grads, _ = jax.jit(lambda p, b: j_grads(p, j_smoke(arch), jrun,
                                                    b))(jp, b0)
            fn = jax.jit(j_make_train_step(j_smoke(arch), jrun))
            for i in range(steps):
                b = {k: jnp.asarray(v) for k, v in _np_batch(tcfg, i).items()}
                state, m = fn(state, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        np.savez(os.path.join(out, f"train_jax_{arch}.npz"),
                 losses=np.array(losses), norms=np.array(norms),
                 **_flat(jax.tree.map(np.asarray, state["params"])),
                 **_flat(jax.tree.map(np.asarray, grads), "grad"))


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------


def _torch_moe(name, out, rank):
    import torch.distributed as dist

    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.sharding import (ShardingRules, batch_split,
                                      gather_params, shard_params,
                                      sync_grads, use_rules)
    arch, shape, over = MOE_CASES[name]
    cfg = _cfg(arch, **over)
    p, x, r = _moe_inputs(cfg)
    rules = ShardingRules(make_mesh(shape, ("data", "model"), "cpu"))
    defs = L.moe_layer_defs(cfg)
    with use_rules(rules):
        local = shard_params({k: torch.from_numpy(v) for k, v in p.items()},
                             defs, rules)
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in local.items()}
        axes = rules.batch_axes(MOE_B)
        rows = rules.rows(MOE_B)
        xl = torch.from_numpy(x)[rows].requires_grad_()
        with batch_split(len(rows), axes):
            y = L.moe_block(leaves, cfg, RunConfig(), xl)
            loss = (y * torch.from_numpy(r)[rows]).sum()
            loss.backward()
            grads = sync_grads({k: v.grad for k, v in leaves.items()}, defs)
        full = gather_params(grads, defs)
        y_all = rules.all_gather(y.detach(), 0, axes)
        dx_all = rules.all_gather(xl.grad, 0, axes)
        total = rules.all_reduce(loss.detach().clone(), axes)
    if rank == 0:
        res = {"y": y_all, "loss": total, "dx": dx_all,
               **{f"d_{k}": v for k, v in full.items()}}
        np.savez(os.path.join(out, f"port_moe_{name}.npz"),
                 **{k: v.numpy() for k, v in res.items()})
    dist.barrier()


def _train_run(cfg, rules, steps):
    """The gradients of the first batch, then ``steps`` train steps, from
    the numpy weights under ``rules``; returns (losses, grad norms, the
    whole params, the whole gradients)."""
    from repro_torch.models import params as TP
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import gather_params, shard_params, use_rules
    from repro_torch.train import step as tstep
    defs = registry.param_defs(cfg)
    with use_rules(rules):
        full = TP.tree_map(torch.from_numpy, _np_params(cfg))
        params = shard_params(full, defs, rules)
        params = TP.tree_map(lambda t: t.clone(), params)
        state = {"params": params, "opt": adamw_init(params)}
        b0 = {k: torch.from_numpy(v) for k, v in _np_batch(cfg, 0).items()}
        grads, _ = tstep.grads_and_metrics(state["params"], cfg, _run(cfg),
                                           b0)
        with torch.no_grad():
            grads = gather_params(grads, defs)
        fn = tstep.make_train_step(cfg, _run(cfg))
        losses, norms = [], []
        for i in range(steps):
            b = {k: torch.from_numpy(v) for k, v in _np_batch(cfg, i).items()}
            state, m = fn(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        with torch.no_grad():
            return (losses, norms, gather_params(state["params"], defs),
                    grads)


def _torch_train(out, rank):
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, make_mesh
    from repro_torch.sharding import ShardingRules
    rules = ShardingRules(make_mesh((2, 2), ("data", "model"), "cpu"))
    one = ShardingRules(Mesh((1, 1), ("data", "model")))  # one rank's
    for arch, steps in TRAIN.items():
        for tag, no_drops in (("", False), ("_nodrops", True)):
            if tag and arch == "yi-6b":
                continue
            cfg = _train_cfg(arch, no_drops)
            losses, norms, params, grads = _train_run(cfg, rules, steps)
            if rank == 0:
                np.savez(os.path.join(out, f"train_2x2_{arch}{tag}.npz"),
                         losses=np.array(losses), norms=np.array(norms),
                         **_flat(params), **_flat(grads, "grad"))
                if no_drops or not cfg.num_experts:
                    l1, n1, p1, g1 = _train_run(cfg, one, steps)
                    np.savez(os.path.join(out, f"train_1_{arch}{tag}.npz"),
                             losses=np.array(l1), norms=np.array(n1),
                             **_flat(p1), **_flat(g1, "grad"))
            dist.barrier()


def _torch_ckpt(out, rank, ckpt):
    import torch.distributed as dist

    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ShardingRules, use_rules
    from repro_torch.train import step as tstep
    cfg = _cfg(CKPT_ARCH)
    sdefs = tstep.state_defs(cfg)
    rules = ShardingRules(make_mesh((2, 2), ("data", "model"), "cpu"))
    with use_rules(rules):
        state, meta = load_checkpoint(os.path.join(ckpt, "one"), defs=sdefs)
        torch.save({"state": state, "data": rules.mesh.coord("data"),
                    "model": rules.mesh.coord("model")},
                   os.path.join(out, f"ckpt_blocks_{rank}.pt"))
        save_checkpoint(os.path.join(out, "ckpt_resaved"), state,
                        meta["step"], defs=sdefs)
        fresh = tstep.init_state(torch.Generator().manual_seed(0), cfg,
                                 _run(cfg))
        save_checkpoint(os.path.join(out, "ckpt_four"), fresh, 0,
                        defs=sdefs)
    dist.barrier()


def _torch_constrain(out, rank):
    """``constrain`` on a DTensor redistributes it to the rules' placements
    (a replicated batch becomes split over "data"); the full tensor and
    this rank's local rows follow."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ShardingRules, constrain, use_rules
    rules = ShardingRules(make_mesh((2, 2), ("data", "model"), "cpu"))
    full = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)
    dt = distribute_tensor(full, rules.mesh.device_mesh,
                           (Replicate(), Replicate()))
    with use_rules(rules):
        got = constrain(dt, "batch", None)
    ok = (tuple(got.placements) == (Shard(0), Replicate())
          and torch.equal(got.full_tensor(), full)
          and torch.equal(got.to_local(), full[rules.rows(4)]))
    flags = torch.tensor([float(ok)])
    dist.all_reduce(flags)
    if rank == 0:
        np.save(os.path.join(out, "constrain.npy"), flags.numpy())


def _torch_main(rank, store, out, ckpt):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    torch.set_num_threads(1)
    for name in MOE_CASES:
        _torch_moe(name, out, rank)
    _torch_train(out, rank)
    _torch_ckpt(out, rank, ckpt)
    _torch_constrain(out, rank)
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


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes the one-rank checkpoint, then runs the JAX reference and the
    4 ranks together; returns the output directory."""
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.sharding import use_rules
    from repro_torch.train import step as tstep
    out = tmp_path_factory.mktemp("dist")
    ckpt = tmp_path_factory.mktemp("ckpt_in")
    cfg = _cfg(CKPT_ARCH)
    run = _run(cfg)
    with use_rules(None):
        state = tstep.init_state(torch.Generator().manual_seed(0), cfg, run)
        b = {k: torch.from_numpy(v) for k, v in _np_batch(cfg, 0).items()}
        state, _ = tstep.make_train_step(cfg, run)(state, b)
        save_checkpoint(str(ckpt / "one"), state, 1)
    procs = [subprocess.Popen(
        [sys.executable, HERE, "jax", str(out)], env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_PLATFORMS="cpu"))]
    store = str(out / "store")
    procs += [subprocess.Popen(
        [sys.executable, HERE, "torch", str(rank), store, str(out),
         str(ckpt)], env=_env()) for rank in range(WORLD)]
    try:
        for p in procs:
            assert p.wait(timeout=600) == 0, p.args
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out, ckpt


def _close(got, want, rtol, atol_share=1e-6, msg=""):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_share * max(np.abs(want).max(), 1),
                               err_msg=msg)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_jax_under_rules(runs, case):
    out, _ = runs
    want = np.load(out / f"moe_{case}.npz")
    got = np.load(out / f"port_moe_{case}.npz")
    assert set(got.files) == set(want.files)
    _close(got["y"], want["y"], 1e-5, msg=f"{case} y")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    for k in want.files:
        if k.startswith("d"):
            _close(got[k], want[k], 1e-4, msg=f"{case} {k}")


def test_constrain_redistributes_a_dtensor(runs):
    out, _ = runs
    assert np.load(out / "constrain.npy").tolist() == [WORLD]


def test_fslice_case_runs_every_expert_on_a_slice():
    """E 6 over model 4: the rules put "model" on the ffn dim, so each
    rank holds all 6 experts' f / 4 slice."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    from repro_torch.sharding import ShardingRules
    arch, shape, over = MOE_CASES["mixtral_e6_fslice_1x4"]
    cfg = _cfg(arch, **over)
    r = ShardingRules(Mesh(shape, ("data", "model")))
    d = L.moe_layer_defs(cfg)["w_gate"]
    assert r.spec(d.logical, d.shape) == (None, "data", "model")
    assert cfg.num_experts % 4 and cfg.d_ff % 4 == 0


def _grads_close(a, b, arch):
    """The first batch's gradients, gathered whole, leaf by leaf (rtol
    1e-4, as ``test_torch_moe_training.py``): each rank's blocks of the
    ZeRO-3 gathers' reduce-scatter, ``sync_grads`` and the MoE router's
    sum over "model" must land on the right leaf, once."""
    keys = [k for k in b.files if k.startswith("grad/")]
    assert keys and set(keys) == {k for k in a.files
                                  if k.startswith("grad/")}
    for k in keys:
        _close(a[k], b[k], 1e-4, msg=f"{arch} {k}")


@pytest.mark.parametrize("arch", list(TRAIN))
def test_train_steps_at_2x2_match_one_rank(runs, arch):
    """Gradients, losses, grad norms and updated params at (2, 2) against
    one rank (mixtral at capacity factor E / K: no pair drops, so the
    data split's per-shard capacity does not change the function)."""
    out, _ = runs
    tag = "_nodrops" if arch != "yi-6b" else ""
    a = np.load(out / f"train_2x2_{arch}{tag}.npz")
    b = np.load(out / f"train_1_{arch}{tag}.npz")
    lr = _run(_cfg(arch)).learning_rate
    _grads_close(a, b, arch)
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
    np.testing.assert_allclose(a["norms"], b["norms"], rtol=1e-5)
    for k in b.files:
        if k.startswith("/"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=2 * lr,
                                       err_msg=f"{arch} {k}")


@pytest.mark.parametrize("arch", list(TRAIN))
def test_train_steps_at_2x2_match_jax_under_rules(runs, arch):
    out, _ = runs
    a = np.load(out / f"train_2x2_{arch}.npz")
    b = np.load(out / f"train_jax_{arch}.npz")
    lr = _run(_cfg(arch)).learning_rate
    _grads_close(a, b, arch)
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
    np.testing.assert_allclose(a["norms"], b["norms"], rtol=1e-5)
    keys = [k for k in b.files if k.startswith("/")]
    assert keys and set(keys) == {k for k in a.files if k.startswith("/")}
    for k in keys:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=2 * lr,
                                   err_msg=f"{arch} {k}")


def _leaf_files(d):
    import json
    with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
        man = json.load(f)
    return {leaf["path"]: open(os.path.join(d, "step_00000001",
                                            leaf["file"]), "rb").read()
            for leaf in man["leaves"]}


def test_checkpoint_written_at_one_rank_loads_at_four(runs):
    """Each rank's blocks are its slices of the one-rank leaves, bit for
    bit, and the four ranks write the one-rank files again."""
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import ShardingRules
    from repro_torch.train import step as tstep
    out, ckpt = runs
    one, _ = load_checkpoint(str(ckpt / "one"))
    sdefs = tstep.state_defs(_cfg(CKPT_ARCH))
    flat_one, flat_defs = _flat_t(one), _flat_t(sdefs)
    for rank in range(WORLD):
        got = torch.load(out / f"ckpt_blocks_{rank}.pt")

        class _M:
            shape = {"data": 2, "model": 2}

            def coord(self, a, _g=got):
                return _g[a]
        r = ShardingRules(_M())
        for path, t in _flat_t(got["state"]).items():
            d = flat_defs[path]
            want = (flat_one[path] if d is None
                    else r.local_shard(flat_one[path], d.logical, d.shape))
            assert t.dtype == want.dtype and torch.equal(t, want), path
    assert _leaf_files(out / "ckpt_resaved") == _leaf_files(ckpt / "one")


def test_checkpoint_written_at_four_ranks_loads_at_one(runs):
    """The state the four ranks drew sharded and saved loads at one rank
    equal, bit for bit, to the one-rank draw from the same seed."""
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.sharding import use_rules
    from repro_torch.train import step as tstep
    out, _ = runs
    cfg = _cfg(CKPT_ARCH)
    loaded, meta = load_checkpoint(str(out / "ckpt_four"))
    assert meta["step"] == 0
    with use_rules(None):
        want = tstep.init_state(torch.Generator().manual_seed(0), cfg,
                                _run(cfg))
    fl, fw = _flat_t(loaded), _flat_t(want)
    assert set(fl) == set(fw)
    for path, t in fw.items():
        t = torch.as_tensor(t)
        assert torch.equal(fl[path], t.to(fl[path].dtype)), path
        assert fl[path].dtype == t.dtype or path.endswith("step"), path


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_t(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# The entry-point MoE semantics (one device, in this process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_shardmap_differs_from_gspmd_where_drops_differ(arch):
    """At B 2 under rules the block routes the rank's 2 S tokens as one
    row (capacity over them) and equals the JAX ``moe_block`` under rules;
    the gspmd path (per-row capacity) drops other pairs and differs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs.base import RunConfig as JRunConfig
    from repro.models import layers as JL
    from repro.sharding import ShardingRules as JRules
    from repro.sharding import use_rules as j_use_rules
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    from repro_torch.sharding import ShardingRules, use_rules
    cfg = _cfg(arch)
    p, x, _ = _moe_inputs(cfg)
    x = x[:2]
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    with use_rules(ShardingRules(Mesh((1, 1), ("data", "model")))):
        sm = L.moe_block(tp, cfg, RunConfig(), tx)
        assert L.moe_uses_shardmap(tx)
    gs = L.moe_block(tp, cfg, RunConfig(), tx)  # no rules: gspmd
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jcfg = __import__("repro.configs.base", fromlist=["x"]) \
        .get_smoke_config(arch)
    with j_use_rules(JRules(mesh)):
        want = jax.jit(lambda p, x: JL.moe_block(p, jcfg, JRunConfig(), x))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    want_gs = JL._moe_block_gspmd(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, JRunConfig(),
        jnp.asarray(x))
    _close(sm.numpy(), np.asarray(want), 1e-5, msg="shardmap")
    _close(gs.numpy(), np.asarray(want_gs), 1e-5, msg="gspmd")
    # the drops differ: whole token outputs move
    r_row = L.moe_route(tp, cfg, tx)
    r_all = L.moe_route(tp, cfg, tx.reshape(1, -1, cfg.d_model))
    assert r_all.capacity != r_row.capacity
    assert not torch.equal(r_all.keep.reshape(-1), r_row.keep.reshape(-1))
    assert float((sm - gs).abs().max()) > 1e-2


@pytest.mark.parametrize("arch", MOE)
def test_prefill_under_rules_matches_jax_prefill_under_rules(arch):
    """The entry points' path: ``registry.prefill`` at B 2 under the host
    mesh's rules (one rank) equals the JAX prefill under rules on a (1, 1)
    mesh, and differs from the port's prefill without rules (the path the
    port's serving driver took before it ran under rules)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import get_smoke_config as j_smoke
    from repro.models import params as JP
    from repro.models import registry as jreg
    from repro.serve import engine as jengine
    from repro.sharding import ShardingRules as JRules
    from repro.sharding import use_rules as j_use_rules
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.serve import host_rules
    from repro_torch.models import params as TP
    from repro_torch.models import registry as treg
    from repro_torch.serve import engine as tengine
    from repro_torch.sharding import use_rules
    jcfg, cfg = j_smoke(arch), _cfg(arch)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), JP.materialize(
        jax.random.PRNGKey(0), jreg.param_defs(jcfg)))
    tp = TP.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with j_use_rules(JRules(mesh)):
        jc = jengine.init_cache(jcfg, 2, 32)
        jl, _ = jax.jit(lambda p, b, c: jreg.prefill(p, jcfg, JRunConfig(),
                                                     b, c))(
            jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    run = RunConfig()
    tb = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        with use_rules(host_rules(None, torch.device("cpu"))):
            tl, _ = treg.prefill(tp, cfg, run, tb,
                                 tengine.init_cache(cfg, 2, 32, "cpu"))
        old, _ = treg.prefill(tp, cfg, run, tb,
                              tengine.init_cache(cfg, 2, 32, "cpu"))
    _close(tl.float().numpy(), np.asarray(jl, np.float32), 1e-4,
           atol_share=1e-5)
    assert float((tl - old).abs().max()) > 1e-3


def test_remat_recompute_keeps_the_rules_on_another_thread():
    """The backward (and the blocks' recompute under remat) may run on
    another thread than the forward, as CUDA's autograd device threads
    do; the recompute must see the forward's rules, or the MoE block
    recomputes through the other path.  Here the backward runs on a new
    thread and must equal one on this thread."""
    import threading

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import params as TP
    from repro_torch.sharding import ShardingRules, use_rules
    from repro_torch.train import loss as tloss
    cfg = _cfg("mixtral-8x7b")
    run = _run(cfg)
    assert run.remat == "full"
    params = TP.tree_map(torch.from_numpy, _np_params(cfg))
    b = {k: torch.from_numpy(v) for k, v in _np_batch(cfg, 0).items()}
    grads = []
    for other_thread in (False, True):
        leaves = TP.tree_map(lambda t: t.clone().requires_grad_(), params)
        with use_rules(ShardingRules(Mesh((1, 1), ("data", "model")))):
            loss, _ = tloss.lm_loss(leaves, cfg, run, b)
        errors = []

        def back():
            try:
                loss.backward()
            except BaseException as e:  # surfaced below
                errors.append(e)
        if other_thread:
            t = threading.Thread(target=back)
            t.start()
            t.join()
        else:
            back()
        assert not errors, errors
        grads.append([t.grad for t in TP.tree_leaves(leaves)])
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)
