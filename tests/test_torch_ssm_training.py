"""The port's SSM and hybrid training slice against the JAX reference, on
the CPU.

The same numpy inputs (and, for the models, the same weights carried over
with ``from_jax_params``) go through the JAX functions and through the
port's plain paths, which are what the port runs on CPU tensors:

- ``ssd_bwd_ref`` (the SSD backward's plain version, the formulas the CUDA
  kernel follows) against ``jax.vjp`` of ``repro.kernels.ref.ssd_ref`` on
  the SSD sweep of tests/test_kernels.py, with and without an initial
  state and a cotangent of the final state, and against torch autograd
  through the port's ``ssd_ref``;
- ``ops.ssd`` with grad on the CPU: ``SSDFn``'s plain path;
- remat "full" and "dots" of the mamba blocks against "none";
- three train steps of mamba2-130m-smoke and zamba2-1.2b-smoke (4 layers,
  the shared block every 2) against ``jax.jit(make_train_step)``, called
  outside ``use_rules`` (the JAX launch code fails on jax 0.9, ROADMAP C1).

Tolerances, with their reasons:

- ``ssd_bwd_ref`` in f32: relative L2 1e-5 (sums in another order).  dA
  alone 1e-4: each of its H entries sums B * S terms that cancel down to
  a small total, so both f32 results lie far from the exact one.  On the
  sweep's (2, 64, 2, 64, 1, 128, 32) case (seed 0, the four choices of
  initial state and final-state cotangent), against an f64 autograd of
  the same function, JAX's dA is 4.2e-5 to 5.6e-5 off and the port's
  2.6e-5 to 4.0e-5, and the two differ by 4.8e-5 to 7.1e-5;
- ``ssd_bwd_ref`` in bf16: 3e-2 elementwise (atol + rtol |ref|), as the
  SSD scan's bf16 sweep: both compute in f32 from the same bf16 inputs
  and round dx, dB, dC once;
- train steps: those of tests/test_torch_training.py's step tests (loss
  rtol 1e-4 in f32, 1e-3 in bf16; params rtol 1e-5 in f32, one bf16 ulp
  2^-7 in bf16, plus 2 lr summed over the steps: AdamW's first steps turn
  a gradient near zero whose sign differs between the frameworks into
  about +-lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.models import params as JP
from repro.models import registry as jreg
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.base import RunConfig, get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import train as ttrain
from repro_torch.models import hybrid as thybrid
from repro_torch.models import params as TP
from repro_torch.models import registry as treg
from repro_torch.optim import adamw_init
from repro_torch.train import step as tstep

SSD_CASES = [
    # B, S, H, P, G, N, chunk: tests/test_kernels.py
    (2, 96, 4, 16, 1, 32, 32),
    (1, 130, 6, 32, 2, 16, 64),   # ragged tail, G = 2
    (2, 64, 2, 64, 1, 128, 32),   # mamba2-130m-like dims
]
DTYPES = ["float32", "bfloat16"]
ARCHS = ["mamba2-130m", "zamba2-1.2b"]
GRADS = ("dx", "ddt", "dA", "dB", "dC", "d_init")
F32_REL_L2 = {"dA": 1e-4}  # the others 1e-5; see the module notes


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ssd_np(case, seed=0):
    """x, dt, A, B, C, the initial state, dy and the final state's
    cotangent, f32 numpy."""
    Bb, Ss, H, P, G, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, Ss, H, P), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((Bb, Ss, H), np.float32)))
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    Bm = rng.standard_normal((Bb, Ss, G, N), np.float32) * 0.3
    Cm = rng.standard_normal((Bb, Ss, G, N), np.float32) * 0.3
    h0 = rng.standard_normal((Bb, H, P, N), np.float32) * 0.1
    dy = rng.standard_normal((Bb, Ss, H, P), np.float32)
    dh = rng.standard_normal((Bb, H, P, N), np.float32) * 0.1
    return x, dt, A, Bm, Cm, h0, dy, dh


# ---------------------------------------------------------------------------
# The SSD backward's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("d_state", [False, True])
def test_ssd_bwd_ref_matches_jax_vjp(case, dtype, state, d_state):
    x, dt, A, Bm, Cm, h0, dy, dh = _ssd_np(case)
    chunk = case[-1]
    jd = getattr(jnp, dtype)

    def f(x, dt, A, Bm, Cm, h0):
        return jref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=h0 if state else None,
                            return_state=True)

    (_, h_out), vjp = jax.vjp(f, jnp.asarray(x, jd), jnp.asarray(dt),
                              jnp.asarray(A), jnp.asarray(Bm, jd),
                              jnp.asarray(Cm, jd), jnp.asarray(h0))
    want = vjp((jnp.asarray(dy, jd),
                jnp.asarray(dh) if d_state else jnp.zeros_like(h_out)))
    td = getattr(torch, dtype)
    got = tref.ssd_bwd_ref(
        torch.from_numpy(x).to(td), torch.from_numpy(dt),
        torch.from_numpy(A), torch.from_numpy(Bm).to(td),
        torch.from_numpy(Cm).to(td), torch.from_numpy(dy).to(td),
        chunk=chunk, init_state=torch.from_numpy(h0) if state else None,
        d_state=torch.from_numpy(dh) if d_state else None)
    for name, g, w in zip(GRADS, got, want):
        if name == "d_init" and not state:
            continue  # JAX's is the zero cotangent of an unused input
        assert tuple(g.shape) == w.shape, name
        assert g.dtype == (td if name in ("dx", "dB", "dC")
                           else torch.float32), name
        if dtype == "float32":
            tol = F32_REL_L2.get(name, 1e-5)
            assert _rel_l2(g, w) <= tol, (name, _rel_l2(g, w))
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=3e-2, atol=3e-2,
                                       err_msg=name)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_bwd_ref_matches_torch_autograd(case):
    x, dt, A, Bm, Cm, h0, dy, dh = _ssd_np(case, seed=1)
    chunk = case[-1]
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, dt, A, Bm, Cm, h0)]
    y, h = tref.ssd_ref(*leaves[:5], chunk=chunk, init_state=leaves[5],
                        return_state=True)
    want = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dy),
                                                torch.from_numpy(dh)))
    got = tref.ssd_bwd_ref(*(torch.from_numpy(a) for a in
                             (x, dt, A, Bm, Cm, dy)), chunk=chunk,
                           init_state=torch.from_numpy(h0),
                           d_state=torch.from_numpy(dh))
    for name, g, w in zip(GRADS, got, want):
        tol = F32_REL_L2.get(name, 1e-5)
        assert _rel_l2(g, w) <= tol, (name, _rel_l2(g, w))


@pytest.mark.parametrize("return_state", [False, True])
def test_ops_ssd_grad_takes_the_plain_function_on_cpu(return_state):
    """With grad on a CPU tensor ``ops.ssd`` runs ``SSDFn``'s plain path
    (no launch is counted), whose gradients are autograd's through
    ``ssd_ref``."""
    case = (2, 70, 4, 16, 2, 16, 32)
    x, dt, A, Bm, Cm, h0, dy, dh = _ssd_np(case, seed=2)
    grads = {}
    for path in ("ops", "autograd"):
        leaves = [torch.from_numpy(a).requires_grad_()
                  for a in (x, dt, A, Bm, Cm, h0)]
        fn = tops.ssd if path == "ops" else tref.ssd_ref
        n = (tssd.launches, tssd.bwd_launches)
        out = fn(*leaves[:5], chunk=32, init_state=leaves[5],
                 return_state=return_state)
        y, h = out if return_state else (out, None)
        if path == "ops":
            assert type(y.grad_fn).__name__ == "SSDFnBackward"
        outs = (y, h) if return_state else (y,)
        cots = (torch.from_numpy(dy), torch.from_numpy(dh))[:len(outs)]
        grads[path] = torch.autograd.grad(outs, leaves, cots)
        assert (tssd.launches, tssd.bwd_launches) == n
    for name, g, w in zip(GRADS, grads["ops"], grads["autograd"]):
        tol = F32_REL_L2.get(name, 1e-5)
        assert _rel_l2(g, w) <= tol, (name, _rel_l2(g, w))


# ---------------------------------------------------------------------------
# Remat of the mamba blocks
# ---------------------------------------------------------------------------

B, S = 2, 40  # two chunks of the smoke configs' 32, the second ragged


def _batch(i, vocab=256):
    rng = np.random.default_rng(200 + i)
    toks = rng.integers(0, vocab, (B, S), dtype=np.int32)
    labels = rng.integers(0, vocab, (B, S), dtype=np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
         "loss_mask": jnp.asarray(mask)}
    t = {"tokens": torch.from_numpy(toks).long(),
         "labels": torch.from_numpy(labels).long(),
         "loss_mask": torch.from_numpy(mask)}
    return j, t


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_grads_of_none(arch, remat, monkeypatch):
    """``mamba2.run_layers`` (mamba2) and ``hybrid._run`` (zamba2, through
    ``run_layers``) checkpoint each mamba block whole under "full" and
    "dots": the same loss and gradients, bit for bit, as "none"; and the
    backward runs each mamba block again (its two norms), not the shared
    block."""
    cfg = get_smoke_config(arch)
    params = TP.cast_tree(TP.materialize(
        treg.param_defs(cfg), torch.Generator().manual_seed(0), "cpu"),
        torch.float32)
    _, tb = _batch(0)
    norms = []
    real = tref.rmsnorm_fwd_ref
    monkeypatch.setattr(tref, "rmsnorm_fwd_ref",
                        lambda *a, **k: norms.append(1) or real(*a, **k))
    out, calls = {}, {}
    for key in ("none", remat):
        norms.clear()
        out[key] = tstep.grads_and_metrics(
            params, cfg, RunConfig(remat=key, ce_block_v=64), tb)
        calls[key] = len(norms)
    (gr, mr), (gn, mn) = out[remat], out["none"]
    assert float(mr["loss"]) == float(mn["loss"])
    for a, b in zip(TP.tree_leaves(gr), TP.tree_leaves(gn)):
        assert torch.equal(a, b)
    n_app = (thybrid.n_attn_applications(cfg) if cfg.family == "hybrid"
             else 0)
    assert calls["none"] == 2 * cfg.num_layers + 2 * n_app + 1
    assert calls[remat] == calls["none"] + 2 * cfg.num_layers


# ---------------------------------------------------------------------------
# Train steps against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return {arch: JP.materialize(jax.random.PRNGKey(0),
                                 jreg.param_defs(j_smoke(arch)))
            for arch in ARCHS}


def _cast_like_model(tree, dtype):
    """The bf16 leaves in ``dtype``; the f32 leaves (A_log, D, dt_bias)
    stay f32, as the models define them."""
    return jax.tree.map(
        lambda a: a.astype(getattr(jnp, dtype))
        if a.dtype == jnp.bfloat16 else a, tree)


def _leaf_pairs(jtree, ttree):
    for path, a in jax.tree_util.tree_leaves_with_path(jtree):
        t = ttree
        for k in path:
            t = t[k.key]
        yield jax.tree_util.keystr(path), a, t


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_train_steps_match_jax(jax_params, arch, dtype):
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    run = ttrain.default_run_config(cfg, 3)
    jrun = JRunConfig(total_steps=run.total_steps,
                      warmup_steps=run.warmup_steps,
                      ce_block_v=run.ce_block_v)
    jp = _cast_like_model(jax_params[arch], dtype)
    tp = TP.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    jstate = {"params": jp, "opt": j_adamw_init(jp)}
    tstate = {"params": tp, "opt": adamw_init(tp)}
    j_fn = jax.jit(j_make_train_step(jcfg, jrun))
    t_fn = tstep.make_train_step(cfg, run)
    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batch(i)
        jstate, jm = j_fn(jstate, jb)
        tstate, tm = t_fn(tstate, tb)
        lr_sum += tm["lr"]
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4 if dtype == "float32" else 1e-3)
        rtol = 2 ** -7 if dtype == "bfloat16" else 1e-5
        for name, a, t in _leaf_pairs(jstate["params"], tstate["params"]):
            assert t.dtype == getattr(torch, str(a.dtype)), name
            np.testing.assert_allclose(
                _np(t), _np(a), rtol=rtol, atol=2 * lr_sum,
                err_msg=f"{arch} step {i + 1} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_ssm_archs_on_cpu(arch):
    """The entry point trains both SSM archs on the CPU, synthetic and
    carousel-fed."""
    for carousel in (False, True):
        res = ttrain.run_training(arch, smoke=True, steps=2, seq_len=40,
                                  global_batch=2, carousel=carousel,
                                  device="cpu")
        assert res["steps"] == 2 and res["final_step"] == 2
        assert all(np.isfinite(res["losses"]))
