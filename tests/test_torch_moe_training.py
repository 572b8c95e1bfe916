"""The port's MoE training against the JAX reference, on the CPU
(mixtral-8x7b-smoke and qwen3-moe-235b-a22b-smoke).

The same numpy inputs, and the same weights carried over with
``from_jax_params``, go through the JAX functions and through the port's
plain paths, which are what the port runs on CPU tensors:

- ``grads_and_metrics`` against the JAX ``grads_and_metrics``, then one
  ``train_step`` against ``jax.jit(make_train_step)`` (called outside
  ``use_rules``: the JAX launch code fails on jax 0.9, ROADMAP C1), in f32
  with the loss head's products in f32 too (``ce_dtype="float32"``);
- bf16 against f32 in each package, over eight batches;
- remat "full" and "dots" against "none";
- the entry point ``run_training``, synthetic and carousel-fed.

Tolerances, with their reasons:

- f32: the loss at rtol 1e-6 and each gradient elementwise at rtol 1e-4
  plus 1e-6 of the leaf's largest entry: sums in another order, nothing
  rounded to bf16.  With the default ``ce_dtype`` bf16 the loss head
  rounds the hidden states to bf16, and an f32 difference in their last
  bits flips a rounding, which moves the gradients further apart than
  sums in another order do.  Params after the step elementwise at rtol
  1e-5 plus 2 lr, as tests/test_torch_training.py holds them;
- bf16: MoE routing is discrete, so bf16 flips top-K choices and
  capacity drops (ROADMAP C5), and a flip moves whole gradients, in
  either package on some batches, about ten times as far as rounding
  moves them on the others.  So the port's bf16 gradients are held
  against its own f32 ones by the spread of the JAX package's bf16
  gradients from its f32 ones, measured here on the same eight batches:
  the port's median and largest worst-leaf distance within 1.5 times the
  JAX package's.  A fault of the port's bf16 path would move every
  batch, and with it the median; flips are drawn by both packages from
  the same process, and over eight batches their counts differ by chance
  (the factor).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_smoke_config as j_smoke
from repro.models import params as JP
from repro.models import registry as jreg
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import grads_and_metrics as j_grads
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import train as ttrain
from repro_torch.models import params as TP
from repro_torch.optim import adamw_init
from repro_torch.train import step as tstep

ARCHS = ["mixtral-8x7b", "qwen3-moe-235b-a22b"]
B, S = 2, 40
N_SPREAD_BATCHES = 8
SPREAD_FACTOR = 1.5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(i):
    rng = np.random.default_rng(300 + i)
    toks = rng.integers(0, 256, (B, S), dtype=np.int32)
    labels = rng.integers(0, 256, (B, S), dtype=np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
         "loss_mask": jnp.asarray(mask)}
    t = {"tokens": torch.from_numpy(toks).long(),
         "labels": torch.from_numpy(labels).long(),
         "loss_mask": torch.from_numpy(mask)}
    return j, t


@pytest.fixture(scope="module")
def jax_params():
    return {arch: JP.materialize(jax.random.PRNGKey(0),
                                 jreg.param_defs(j_smoke(arch)))
            for arch in ARCHS}


def _cast_like_model(tree, dtype):
    """The bf16 leaves in ``dtype``; the f32 router stays f32."""
    return jax.tree.map(
        lambda a: a.astype(getattr(jnp, dtype))
        if a.dtype == jnp.bfloat16 else a, tree)


def _both(jax_params, arch, dtype):
    jp = _cast_like_model(jax_params[arch], dtype)
    return jp, TP.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _runs(cfg, **kw):
    run = ttrain.default_run_config(cfg, 3).replace(**kw)
    jrun = JRunConfig(total_steps=run.total_steps,
                      warmup_steps=run.warmup_steps,
                      ce_block_v=run.ce_block_v, ce_dtype=run.ce_dtype)
    return jrun, run


def _leaf_pairs(jtree, ttree):
    for path, a in jax.tree_util.tree_leaves_with_path(jtree):
        t = ttree
        for k in path:
            t = t[k.key]
        yield jax.tree_util.keystr(path), a, t


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_and_train_step_match_jax_in_f32(jax_params, arch):
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    jrun, run = _runs(cfg, ce_dtype="float32")
    jp, tp = _both(jax_params, arch, "float32")
    jb, tb = _batch(0)
    jg, jm = jax.jit(lambda p, b: j_grads(p, jcfg, jrun, b))(jp, jb)
    tg, tm = tstep.grads_and_metrics(tp, cfg, run, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    for name, a, t in _leaf_pairs(jg, tg):
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape, name
        a = _np(a)
        np.testing.assert_allclose(_np(t), a, rtol=1e-4,
                                   atol=1e-6 * np.abs(a).max(),
                                   err_msg=f"{arch} grad {name}")

    jstate, jmet = jax.jit(j_make_train_step(jcfg, jrun))(
        {"params": jp, "opt": j_adamw_init(jp)}, jb)
    tstate, tmet = tstep.make_train_step(cfg, run)(
        {"params": tp, "opt": adamw_init(tp)}, tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    for name, a, t in _leaf_pairs(jstate["params"], tstate["params"]):
        np.testing.assert_allclose(_np(t), _np(a), rtol=1e-5,
                                   atol=2 * tmet["lr"],
                                   err_msg=f"{arch} step 1 {name}")


def _worst_leaf(g_bf16, g_f32) -> float:
    return max(_rel_l2(a, b) for a, b in zip(g_bf16, g_f32))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_grads_lie_within_the_jax_spread(jax_params, arch):
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    jrun, run = _runs(cfg)
    j_fn = jax.jit(lambda p, b: j_grads(p, jcfg, jrun, b)[0])
    params = {dt: _both(jax_params, arch, dt)
              for dt in ("float32", "bfloat16")}
    d_jax, d_port = [], []
    for i in range(N_SPREAD_BATCHES):
        jb, tb = _batch(i)
        jg = {dt: jax.tree_util.tree_leaves(j_fn(params[dt][0], jb))
              for dt in params}
        tg = {dt: list(TP.tree_leaves(tstep.grads_and_metrics(
            params[dt][1], cfg, run, tb)[0])) for dt in params}
        assert all(bool(torch.isfinite(g).all()) for g in tg["bfloat16"])
        d_jax.append(_worst_leaf(jg["bfloat16"], jg["float32"]))
        d_port.append(_worst_leaf(tg["bfloat16"], tg["float32"]))
    for stat in (np.median, np.max):
        assert stat(d_port) <= SPREAD_FACTOR * stat(d_jax), (
            stat.__name__, d_port, d_jax)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_grads_of_none(jax_params, arch, remat):
    """Checkpointed MoE blocks, whole ("full") or keeping the projections
    ("dots": no ``bmm`` is saved, as ``dots_with_no_batch_dims_saveable``
    saves none), give the loss and gradients of "none" bit for bit; every
    leaf, the router's too, gets a gradient."""
    cfg = get_smoke_config(arch)
    _, tp = _both(jax_params, arch, "float32")
    _, tb = _batch(1)
    run = ttrain.default_run_config(cfg, 3)
    gn, mn = tstep.grads_and_metrics(tp, cfg, run.replace(remat="none"), tb)
    gr, mr = tstep.grads_and_metrics(tp, cfg, run.replace(remat=remat), tb)
    assert float(mr["loss"]) == float(mn["loss"])
    for a, b in zip(TP.tree_leaves(gr), TP.tree_leaves(gn)):
        assert torch.equal(a, b) and bool(b.any())


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_moe_archs_on_cpu(arch):
    """The entry point trains both MoE archs on the CPU, synthetic and
    carousel-fed."""
    for carousel in (False, True):
        res = ttrain.run_training(arch, smoke=True, steps=2, seq_len=24,
                                  global_batch=2, carousel=carousel,
                                  device="cpu")
        assert res["steps"] == 2 and res["final_step"] == 2
        assert all(np.isfinite(res["losses"]))
