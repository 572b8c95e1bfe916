"""The port's training slice against the JAX reference, on the CPU.

The same numpy inputs (and, for the model, the same weights carried over
with ``from_jax_params``) go through the JAX functions and through the
port's plain paths, which are what the port runs on CPU tensors:

- the custom backwards: RMSNorm and flash attention against ``jax.vjp``
  of ``repro.kernels.ref``, the CE statistics against
  ``cross_entropy_pallas`` in interpret mode, ``ce_blockwise`` against
  ``repro.train.loss.ce_blockwise``;
- ``adamw_update`` against the JAX ``adamw_update``;
- ``grads_and_metrics`` and one and three ``train_step``s on yi-6b-smoke
  against ``jax.jit(make_train_step)`` (called outside ``use_rules``: the
  JAX launch code fails on jax 0.9, ROADMAP C1), on seeded batches and on
  batches recorded from the port's carousel;
- ``remat="dots"`` against "none", "full" and the JAX package's "dots";
- the entry point ``run_training``, synthetic and carousel-fed, with
  checkpoints and resume: twins of tests/test_integration.py's
  training tests, on the CPU.

Tolerances, with their reasons:

- kernels' plain versions, as tests/test_kernels.py: 3e-5 in f32 (sums in
  another order), 2e-2 in bf16 (one output rounding apart);
- gradients of the train step: relative L2 1e-4 with f32 params (sums in
  another order through 2 layers), 3e-2 with bf16 params (bf16 matmul
  outputs and cotangents round at other places in the two frameworks);
- params after AdamW: AdamW's first steps turn each gradient into about
  +-lr, so a gradient near zero whose sign differs between the frameworks
  moves its parameter about 2 lr apart; the bound is 2 lr summed over the
  steps, plus one bf16 ulp (2^-7 relative) with bf16 params.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.kernels.cross_entropy import cross_entropy_pallas
from repro.models import params as JP
from repro.models import registry as jreg
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.train import loss as jloss
from repro.train.step import grads_and_metrics as j_grads
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.base import RunConfig, get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.carousel.delivery import device_put
from repro_torch.launch import train as ttrain
from repro_torch.models import params as TP
from repro_torch.models import registry as treg
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim import cosine_schedule
from repro_torch.train import loss as tloss
from repro_torch.train import step as tstep

ARCH = "yi-6b"
CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len
    (2, 128, 128, 4, 2, 64, True, 0, 0, None),
    (1, 100, 160, 6, 6, 64, True, 0, 0, None),      # whisper-ish heads
    (2, 1, 256, 8, 2, 128, True, 0, 200, 201),      # decode
    (2, 64, 256, 4, 4, 64, True, 48, 0, None),      # sliding window
    (1, 96, 160, 4, 2, 64, False, 0, 0, None),      # cross attention
    (1, 80, 80, 40, 40, 32, True, 0, 0, None),      # qwen32b head count
]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=3e-5, atol=3e-5))


def _pair(a: np.ndarray, dtype: str):
    """One f32 numpy array as a JAX and a torch array of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# Custom backwards of the kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 384), (1, 513)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_grads_match_jax_vjp(shape, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal(shape, np.float32), dtype)
    jw, tw = _pair(rng.standard_normal(shape[-1:], np.float32), dtype)
    jg, tg = _pair(rng.standard_normal(shape, np.float32), dtype)

    def ref(x, w, g):
        y, vjp = jax.vjp(lambda x, w: jref.rmsnorm_ref(x, w, 1e-5), x, w)
        return y, *vjp(g)

    y, jdx, jdw = jax.jit(ref)(jx, jw, jg)
    tx.requires_grad_()
    tw.requires_grad_()
    ty = tops.rmsnorm(tx, tw, eps=1e-5)
    ty.backward(tg)
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype
    np.testing.assert_allclose(_np(ty), _np(y), **_tol(dtype))
    np.testing.assert_allclose(_np(tx.grad), _np(jdx), **_tol(dtype))
    np.testing.assert_allclose(_np(tw.grad), _np(jdw), **_tol(dtype))


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 384), (1, 513)])
def test_rmsnorm_bwd_ref_in_f64_matches_jax_vjp(shape):
    """``rmsnorm_bwd_ref(compute_dtype=float64)``, the yardstick of the
    f32 kernel's dw over many rows: the same formula, results in f32."""
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal(shape, np.float32), "float32")
    jw, tw = _pair(rng.standard_normal(shape[-1:], np.float32), "float32")
    jg, tg = _pair(rng.standard_normal(shape, np.float32), "float32")
    _, vjp = jax.vjp(lambda x, w: jref.rmsnorm_ref(x, w, 1e-5), jx, jw)
    jdx, jdw = vjp(jg)
    _, inv = tref.rmsnorm_fwd_ref(tx, tw, 1e-5)
    dx, dw = tref.rmsnorm_bwd_ref(tx, tw, inv, tg,
                                  compute_dtype=torch.float64)
    assert dx.dtype == dw.dtype == torch.float32
    np.testing.assert_allclose(_np(dx), _np(jdx), **_tol("float32"))
    np.testing.assert_allclose(_np(dw), _np(jdw), **_tol("float32"))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_lse_and_grads_match_jax_vjp(case, dtype):
    B, Sq, Sk, Hq, Hkv, D, causal, sw, qoff, kvl = case
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng.standard_normal(s, np.float32), dtype)
        for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                  (B, Sq, Hq, D)))
    kw = dict(causal=causal, sliding_window=sw, q_offset=qoff, kv_len=kvl)

    def ref(q, k, v, do):
        _, lse = jref._flash_fwd_inner(
            q, k, v, jnp.int32(qoff), jnp.int32(Sk if kvl is None else kvl),
            causal=causal, sliding_window=sw, block_k=48, scale=None,
            carry_constrain=None)
        out, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
            q, k, v, block_k=48, **kw), q, k, v)
        return lse, out, *vjp(do)

    jlse, out, jdq, jdk, jdv = jax.jit(ref)(jq, jk, jv, jdo)

    tout, tlse = tref.flash_attention_fwd_ref(tq, tk, tv, block_k=48, **kw)
    assert tlse.shape == (B, Sq, Hq) and tlse.dtype == torch.float32
    np.testing.assert_allclose(_np(tlse), _np(jlse).reshape(B, Sq, Hq),
                               rtol=3e-5, atol=3e-5)
    for t in (tq, tk, tv):
        t.requires_grad_()
    got = tops.flash_attention(tq, tk, tv, block_k=48, **kw)
    got.backward(tdo)
    np.testing.assert_allclose(_np(got), _np(out), **_tol(dtype))
    for name, a, b in (("dq", tq.grad, jdq), ("dk", tk.grad, jdk),
                       ("dv", tv.grad, jdv)):
        assert a.dtype == tq.dtype and a.shape == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name,
                                   **_tol(dtype))


def _ce_inputs(T, D, V, dtype, seed=2):
    rng = np.random.default_rng(seed)
    h = _pair(rng.standard_normal((T, D), np.float32), dtype)
    w = _pair(rng.standard_normal((V, D), np.float32) * 0.2, dtype)
    tg = rng.integers(0, V, (T,), dtype=np.int32)
    valid = (rng.random(T) > 0.25).astype(np.float32)
    return h, w, (jnp.asarray(tg), torch.from_numpy(tg).long()), valid


def test_ce_stats_match_pallas_interpret():
    T, D, V = 37, 48, 1000  # a ragged last token tile and vocab block
    (jh, th), (jw, tw), (jt, tt), valid = _ce_inputs(T, D, V, "float32")
    nll, lse = tref.cross_entropy_stats_ref(th, tw, tt, block_v=128)
    jnll, jlse = jax.jit(lambda h, w, t: jloss._ce_fwd_stats(
        h, w, t, 128, jnp.float32))(jh, jw, jt)
    np.testing.assert_allclose(_np(nll), _np(jnll), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=3e-5, atol=3e-5)
    pallas = jax.jit(lambda h, w, t, v: cross_entropy_pallas(
        h, w, t, v, block_t=32, block_v=128, interpret=True))
    for v in (None, valid):
        want = pallas(jh, jw, jt, None if v is None else jnp.asarray(v))
        tv = None if v is None else torch.from_numpy(v)
        got = tops.cross_entropy(th, tw, tt, tv, mode="blockwise",
                                 block_v=128)
        np.testing.assert_allclose(float(got), float(want), rtol=3e-5,
                                   atol=3e-5)
        direct = tops.cross_entropy(th, tw, tt, tv, mode="direct")
        np.testing.assert_allclose(
            float(direct), float(jref.cross_entropy_direct_ref(
                jh, jw, jt, None if v is None else jnp.asarray(v) > 0)),
            rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_ce_blockwise_loss_and_grads_match_jax(dtype, masked):
    T, D, V, bv = 48, 32, 500, 128
    (jh, th), (jw, tw), (jt, tt), valid = _ce_inputs(T, D, V, dtype)
    jvalid = jnp.asarray(valid) if masked else None
    tvalid = torch.from_numpy(valid) if masked else None
    def ref(h, w):
        loss, vjp = jax.vjp(lambda h, w: jloss.ce_blockwise(
            h, w, jt, jvalid, bv, jnp.bfloat16), h, w)
        return loss, *vjp(jnp.ones((), jnp.float32))

    loss, jdh, jdw = jax.jit(ref)(jh, jw)
    th.requires_grad_()
    tw.requires_grad_()
    got = tloss.ce_blockwise(th, tw, tt, tvalid, bv, torch.bfloat16)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=3e-5,
                               atol=3e-5)
    assert th.grad.dtype == th.dtype and tw.grad.dtype == tw.dtype
    # dlogits are rounded to bf16 (ce_dtype) in both, so an element can
    # land one bf16 rounding apart
    np.testing.assert_allclose(_np(th.grad), _np(jdh), rtol=2e-2, atol=2e-4)
    np.testing.assert_allclose(_np(tw.grad), _np(jdw), rtol=2e-2, atol=2e-4)


@pytest.mark.parametrize("state_dtype", DTYPES)
def test_adamw_update_matches_jax(state_dtype):
    rng = np.random.default_rng(4)
    shapes = {"w": (3, 16, 8), "b": (8,), "e": (40, 8)}
    p = {k: rng.standard_normal(s, np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jopt = j_adamw_init(jp, dtype=getattr(jnp, state_dtype))
    topt = adamw_init(tp, dtype=getattr(torch, state_dtype))
    j_update = jax.jit(lambda p, g, o, lr: j_adamw_update(
        p, g, o, lr=lr, weight_decay=0.1, max_grad_norm=1.0))
    for step in range(3):
        g = {k: rng.standard_normal(s, np.float32) * 2.0
             for k, s in shapes.items()}
        lr = cosine_schedule(step + 1, base_lr=1e-2, warmup_steps=2,
                             total_steps=10)
        jp, jopt, jm = j_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jopt, lr)
        # copies: the port clips the gradients in place, and JAX on the
        # CPU may still be reading the same numpy buffers (asynchronous
        # dispatch, no copy on the way in)
        tp, topt, tm = adamw_update(
            tp, {k: torch.from_numpy(v.copy()) for k, v in g.items()}, topt,
            lr=lr, weight_decay=0.1, max_grad_norm=1.0)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert topt["step"] == int(jopt["step"]) == step + 1
        tol = (dict(rtol=2 ** -7, atol=1e-6) if state_dtype == "bfloat16"
               else dict(rtol=1e-5, atol=1e-6))
        for k in shapes:
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(_np(topt["m"][k]),
                                       _np(jopt["m"][k]), err_msg=k, **tol)
            np.testing.assert_allclose(_np(topt["v"][k]),
                                       _np(jopt["v"][k]), err_msg=k, **tol)


def test_cosine_schedule_matches_jax():
    from repro.optim import cosine_schedule as j_cos
    for s in (0, 1, 2, 5, 9, 10, 30):
        kw = dict(base_lr=3e-4, warmup_steps=2, total_steps=10)
        np.testing.assert_allclose(cosine_schedule(s, **kw),
                                   float(j_cos(s, **kw)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

B, S = 4, 16


@pytest.fixture(scope="module")
def jax_params():
    defs = jreg.param_defs(j_smoke(ARCH))
    return jax.jit(lambda key: JP.materialize(key, defs))(
        jax.random.PRNGKey(0))


def _batch(i):
    rng = np.random.default_rng(100 + i)
    toks = rng.integers(0, 256, (B, S), dtype=np.int32)
    labels = rng.integers(0, 256, (B, S), dtype=np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
         "loss_mask": jnp.asarray(mask)}
    t = {"tokens": torch.from_numpy(toks).long(),
         "labels": torch.from_numpy(labels).long(),
         "loss_mask": torch.from_numpy(mask)}
    return j, t


def _leaf_pairs(jtree, ttree):
    for path, a in jax.tree_util.tree_leaves_with_path(jtree):
        t = ttree
        for k in path:
            t = t[k.key]
        yield jax.tree_util.keystr(path), a, t


# (param dtype, accum_steps, grad_compression): each knob takes each of
# its values in both dtypes
STEP_CASES = [("float32", 1, "none"), ("float32", 2, "bf16"),
              ("bfloat16", 1, "bf16"), ("bfloat16", 2, "none")]


@pytest.mark.parametrize("dtype,accum,compression", STEP_CASES)
def test_train_steps_match_jax(jax_params, dtype, accum, compression):
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    kw = dict(total_steps=10, warmup_steps=2, ce_block_v=64,
              accum_steps=accum, grad_compression=compression)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    jp = JP.cast_tree(jax_params, getattr(jnp, dtype))
    tp = TP.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    grad_tol = 1e-4 if dtype == "float32" else 3e-2

    def j_grads_and_step(state, b):  # one compile for both
        grads, _ = j_grads(state["params"], jcfg, jrun, b)
        return (grads,) + j_make_train_step(jcfg, jrun)(state, b)

    j_fn = jax.jit(j_grads_and_step)
    jstate = {"params": jp, "opt": j_adamw_init(jp)}
    tstate = {"params": tp, "opt": adamw_init(tp)}
    tstep_fn = tstep.make_train_step(tcfg, trun)
    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batch(i)
        jg, jstate, jmet = j_fn(jstate, jb)
        if i == 0:
            tg, tm = tstep.grads_and_metrics(tp, tcfg, trun, tb)
            np.testing.assert_allclose(
                float(tm["loss"]), float(jmet["loss"]),
                rtol=1e-4 if dtype == "float32" else 1e-3)
            for name, a, t in _leaf_pairs(jg, tg):
                assert tuple(t.shape) == a.shape, name
                assert t.dtype == (torch.float32 if accum > 1
                                   else getattr(torch, dtype)), name
                assert _rel_l2(t, a) <= grad_tol, (name, _rel_l2(t, a))
        tstate, tmet = tstep_fn(tstate, tb)
        assert tstate["params"] is tp  # updated in place
        lr_sum += tmet["lr"]
        np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4 if dtype == "float32" else 1e-3)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   rtol=1e-4 if dtype == "float32" else 3e-2)
        rtol = 2 ** -7 if dtype == "bfloat16" else 1e-5
        for name, a, t in _leaf_pairs(jstate["params"], tstate["params"]):
            np.testing.assert_allclose(
                _np(t), _np(a), rtol=rtol, atol=2 * lr_sum,
                err_msg=f"step {i + 1} {name}")


def test_remat_none_and_full_give_the_same_grads(jax_params):
    cfg = get_smoke_config(ARCH)
    tp = TP.cast_tree(TP.from_jax_params(
        jax.tree.map(np.asarray, jax_params), device="cpu"), torch.float32)
    _, tb = _batch(1)
    gf, mf = tstep.grads_and_metrics(tp, cfg, RunConfig(remat="full"), tb)
    gn, mn = tstep.grads_and_metrics(tp, cfg, RunConfig(remat="none"), tb)
    assert float(mf["loss"]) == float(mn["loss"])
    for a, b in zip(TP.tree_leaves(gf), TP.tree_leaves(gn)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_dots_matches_none_full_and_jax(jax_params):
    """``remat="dots"`` (selective checkpointing that keeps the
    projections' outputs) gives the gradients of "none" and "full", and
    those of the JAX package's ``dots_with_no_batch_dims_saveable``."""
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jp = JP.cast_tree(jax_params, jnp.float32)
    tp = TP.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    jb, tb = _batch(2)
    gd, md = tstep.grads_and_metrics(tp, cfg, RunConfig(remat="dots"), tb)
    for other in ("none", "full"):
        go, mo = tstep.grads_and_metrics(tp, cfg, RunConfig(remat=other), tb)
        assert float(md["loss"]) == float(mo["loss"]), other
        for a, b in zip(TP.tree_leaves(gd), TP.tree_leaves(go)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    jg, jm = jax.jit(lambda p, b: j_grads(p, jcfg, JRunConfig(remat="dots"),
                                          b))(jp, jb)
    np.testing.assert_allclose(float(md["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    for name, a, t in _leaf_pairs(jg, gd):
        assert _rel_l2(t, a) <= 1e-4, (name, _rel_l2(t, a))


def test_remat_dots_keeps_the_projections_and_recomputes_the_rest():
    """Under "dots" the backward runs no projection again (as many
    ``aten.mm`` calls as "none") but runs the norms and attention's
    batched products again (as many as "full")."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] += 1
            return func(*args, **(kwargs or {}))

    cfg = get_smoke_config(ARCH)
    params = TP.cast_tree(TP.materialize(
        treg.param_defs(cfg), torch.Generator().manual_seed(0), "cpu"),
        torch.float32)
    _, tb = _batch(0)
    seen = {}
    for remat in ("none", "full", "dots"):
        with Count() as c:
            tstep.grads_and_metrics(params, cfg, RunConfig(remat=remat), tb)
        seen[remat] = c.ops
    aten = torch.ops.aten
    assert seen["dots"][aten.mm.default] == seen["none"][aten.mm.default]
    assert seen["full"][aten.mm.default] > seen["none"][aten.mm.default]
    for op in (aten.rsqrt.default, aten.bmm.default):
        assert seen["dots"][op] == seen["full"][op] > seen["none"][op], op


# ---------------------------------------------------------------------------
# The training entry point
# ---------------------------------------------------------------------------

RESULT_KEYS = {"arch", "steps", "first_loss", "last_loss", "losses",
               "time_to_first_batch_s", "wall_s", "final_step", "state"}


def test_run_training_on_cpu():
    seen = []
    res = ttrain.run_training(ARCH, smoke=True, steps=3, seq_len=16,
                              global_batch=2, carousel=False, device="cpu",
                              on_step=lambda i, m: seen.append((i, m)))
    assert set(res) == RESULT_KEYS
    assert res["steps"] == res["final_step"] == 3
    assert [i for i, _ in seen] == [1, 2, 3]
    assert all(np.isfinite(res["losses"]))
    assert res["first_loss"] == res["losses"][0] == seen[0][1]["loss"]
    assert res["state"]["opt"]["step"] == 3
    again = ttrain.run_training(ARCH, smoke=True, steps=3, seq_len=16,
                                global_batch=2, carousel=False,
                                device="cpu")
    assert again["losses"] == res["losses"]  # seeded batches and weights


def test_run_training_without_cuda_raises(monkeypatch):
    """The entry point never moves to the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in (dict(carousel=False), dict(carousel=True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.run_training(ARCH, smoke=True, steps=1, **kw)


CAROUSEL_KEYS = {"time_to_first_batch_s", "next_wait_s", "reads",
                 "failed_reads", "hedges", "shards_landed", "rows_delivered",
                 "rows_received", "skipped_shards"}


def test_training_loss_decreases_with_carousel():
    """Twin of tests/test_integration.py's, on the CPU."""
    res = ttrain.run_training(ARCH, smoke=True, steps=30, seq_len=32,
                              global_batch=4, carousel=True, device="cpu")
    assert set(res) == RESULT_KEYS | {"carousel"}
    assert res["steps"] == res["final_step"] == 30
    first = np.mean(res["losses"][:5])
    last = np.mean(res["losses"][-5:])
    assert last < first, (first, last)
    car = res["carousel"]
    assert set(car) == CAROUSEL_KEYS
    assert len(car["next_wait_s"]) == 30
    assert car["rows_delivered"] >= 30 * 4
    assert car["rows_received"] >= car["rows_delivered"]
    assert car["reads"] >= car["shards_landed"] >= 1
    assert 0 <= car["time_to_first_batch_s"] <= res["time_to_first_batch_s"]


def test_training_fine_starts_before_coarse():
    """With a slow single-drive tape, fine granularity trains on shard 1
    while shards 2..8 are still staging; coarse waits for all of them.
    (The JAX twin trains qwen1.5-4b; this one trains ``ARCH`` at one
    layer: what is timed is the staging, not the model.)"""
    kw = dict(smoke=True, steps=6, seq_len=32, global_batch=2,
              carousel=True, tape_latency=0.4, drives=1, device="cpu",
              num_layers=1)
    # the process's first checkpointed step imports parts of torch for
    # seconds; pay that before the clocks that are compared start
    ttrain.run_training(ARCH, steps=1, carousel=False, device="cpu",
                        num_layers=1)
    fine = ttrain.run_training(ARCH, coarse=False, **kw)
    coarse = ttrain.run_training(ARCH, coarse=True, **kw)
    assert fine["steps"] == coarse["steps"] == 6
    assert fine["state"]["params"]["blocks"]["ln1"].shape[0] == 1
    # 8 shards x 0.4 s on one drive: coarse waits ~2.8 s longer
    assert (coarse["time_to_first_batch_s"]
            > fine["time_to_first_batch_s"] + 1.5)
    assert (coarse["carousel"]["time_to_first_batch_s"]
            > fine["carousel"]["time_to_first_batch_s"] + 1.5)


def test_resume_continues_from_checkpoint(tmp_path):
    """Twin of tests/test_integration.py's: mamba2-130m, carousel-fed,
    checkpointed every 5 steps, then resumed."""
    from repro_torch.ckpt import latest_step, load_checkpoint

    arch = "mamba2-130m"
    out = str(tmp_path / "run")
    kw = dict(smoke=True, seq_len=32, global_batch=2, out_dir=out,
              ckpt_every=5, device="cpu")
    r1 = ttrain.run_training(arch, steps=10, **kw)
    assert set(r1) == RESULT_KEYS | {"carousel", "checkpoint"}
    assert r1["final_step"] == 10 and latest_step(out) == 10
    # saves at 5 and 10, and the last save after the loop rewrites 10
    ck = r1["checkpoint"]
    assert len(ck["copy_s"]) == len(ck["write_s"]) == 3
    assert ck["bytes_written"] > 3 * sum(
        t.numel() * t.element_size()
        for t in TP.tree_leaves(r1["state"]["params"]))
    saved, meta = load_checkpoint(out)
    assert meta["step"] == 10 and int(saved["opt"]["step"]) == 10
    for a, b in zip(TP.tree_leaves(saved["params"]),
                    TP.tree_leaves(r1["state"]["params"])):
        assert torch.equal(a, b)
    r2 = ttrain.run_training(arch, steps=5, resume=True, **kw)
    assert r2["final_step"] == 15 and r2["steps"] == 5
    assert r2["state"]["opt"]["step"] == 15
    assert sorted(os.listdir(out)) == [f"step_{s:08d}" for s in (5, 10, 15)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_carousel_fed_steps_match_jax(jax_params, dtype):
    """Three steps of the port and of ``jax.jit(make_train_step)`` (outside
    ``use_rules``, ROADMAP C1) on the same carousel batches, recorded once
    from the port's pipeline (the stager's threads make the shard order
    differ from run to run)."""
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    stager, delivery = ttrain.make_carousel_pipeline(
        cfg, seq_len=S, batch_rows=B, n_shards=8)
    batches = []
    for b in delivery:
        batches.append(b)
        if len(batches) == 3:
            break
    stager.shutdown()
    assert all(b["tokens"].shape == (B, S) for b in batches)
    assert all(b["tokens"].dtype == np.int32 for b in batches)
    run = ttrain.default_run_config(cfg, 3)
    jrun = JRunConfig(total_steps=run.total_steps,
                      warmup_steps=run.warmup_steps,
                      ce_block_v=run.ce_block_v)
    jp = JP.cast_tree(jax_params, getattr(jnp, dtype))
    tp = TP.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    jstate = {"params": jp, "opt": j_adamw_init(jp)}
    tstate = {"params": tp, "opt": adamw_init(tp)}
    j_fn = jax.jit(j_make_train_step(jcfg, jrun))
    t_fn = tstep.make_train_step(cfg, run)
    for b in batches:
        jstate, jm = j_fn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = t_fn(tstate, device_put(b, torch.device("cpu")))
        np.testing.assert_allclose(
            float(tm["loss"]), float(jm["loss"]),
            rtol=1e-4 if dtype == "float32" else 1e-3)
def test_idds_orchestrated_hpo_over_port_training():
    """The iDDS HPO service driving the port's trainer as its payload,
    as tests/test_integration.py does with the JAX trainer."""
    from repro.core import payloads as reg
    from repro.core.hpo import HPOService, loguniform
    from repro.core.idds import IDDS

    def train_trial(params, inputs):
        run = RunConfig(learning_rate=float(params["lr"]), warmup_steps=1,
                        total_steps=8, ce_block_v=64)
        res = ttrain.run_training(ARCH, smoke=True, steps=8, seq_len=16,
                                  global_batch=2, carousel=False, run=run,
                                  device="cpu")
        return {"objective": res["last_loss"]}

    reg.register_payload("i_torch_train_trial", train_trial)
    svc = HPOService(IDDS(), {"lr": loguniform(1e-5, 1e-1)},
                     eval_payload="i_torch_train_trial", optimizer="halton",
                     points_per_round=2, max_points=4, seed=0)
    out = svc.run()
    assert len(out.trials) == 4
    assert np.isfinite(out.best_objective)
