"""The port's Mamba2 / Zamba2 serving slice against the JAX reference, on
the CPU.

The same numpy inputs go through ``repro.kernels.ref`` (and the Pallas
SSD kernel in interpret mode) and through ``repro_torch.kernels.ref``; JAX
weights from ``repro.models.params.materialize`` are carried over with
``from_jax_params`` and the same numpy prompt and decode tokens go
through ``repro.models.registry.forward``/``prefill``/``decode`` (called
directly, outside ``use_rules``) and through the port.

Tolerances:
- the SSD references, those of tests/test_kernels.py: 3e-4 in f32 (sums in
  another order over up to 130 tokens), 3e-2 in bf16 (one output rounding
  apart); the decode/chaining oracles 2e-4, as there;
- the models with f32 weights, elementwise at 2e-3 as in
  tests/test_torch_serving.py (bf16 KV cache in both: one cached element
  may round one ulp apart);
- the models with bf16 weights: bf16 results round at other places in
  the two frameworks (JAX's eager bf16 silu and gelu round after every
  step, the port's once), and through 2-4 recurrent layers over 40 tokens
  both drift from the f32 result on the same weights by more than an
  elementwise 3e-2 allows.  So a bf16 result is held to JAX's bf16
  result within relative L2 3e-2, and to JAX's f32 result on the same
  weights at least as closely as JAX's own bf16 result is (relative L2
  within 1.5 times JAX's, plus 1e-3).  The single block and the conv
  hold the elementwise 3e-2.
The f32 leaves of the tree (A_log, D, dt_bias) stay f32 in every case, as
the models define them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_pallas
from repro.models import mamba2 as jmamba
from repro.models import params as JP
from repro.models import registry as jreg
from repro.serve import engine as jengine
from repro_torch.configs.base import RunConfig, get_config, get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import serve as tserve
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import params as TP
from repro_torch.models import registry as treg
from repro_torch.serve import engine as tengine

SSD_CASES = [
    # B, S, H, P, G, N, chunk: tests/test_kernels.py
    (2, 96, 4, 16, 1, 32, 32),
    (1, 130, 6, 32, 2, 16, 64),   # ragged tail
    (2, 64, 2, 64, 1, 128, 32),   # mamba2-130m-like dims
]
DTYPES = ["float32", "bfloat16"]
ARCHS = ["mamba2-130m", "zamba2-1.2b"]
B, S, MAX_LEN, N_DECODE = 2, 40, 56, 3
MODEL_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
BF16_REL_L2 = 3e-2


def _check(got, want, truth, dtype: str, what: str = "") -> None:
    """``got`` (port) against ``want`` (JAX) in ``dtype``; ``truth`` is
    JAX's f32 result on the same weights (read for bf16 only).  See the
    module notes."""
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3,
                                   atol=2e-3, err_msg=what)
        return
    g, w, t = _np(got), _np(want), _np(truth)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    assert rel(g, w) <= BF16_REL_L2, (what, rel(g, w))
    assert rel(g, t) <= 1.5 * rel(w, t) + 1e-3, (what, rel(g, t), rel(w, t))


def _ssd_tol(dtype):
    t = 3e-2 if dtype == "bfloat16" else 3e-4
    return dict(rtol=t, atol=t)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a: np.ndarray, dtype: str = "float32"):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _ssd_np(case, seed=0, state=False):
    Bb, Ss, H, P, G, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, Ss, H, P), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((Bb, Ss, H), np.float32)))
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    Bm = rng.standard_normal((Bb, Ss, G, N), np.float32) * 0.3
    Cm = rng.standard_normal((Bb, Ss, G, N), np.float32) * 0.3
    h0 = (rng.standard_normal((Bb, H, P, N), np.float32) * 0.1
          if state else None)
    return x, dt, A, Bm, Cm, h0


def _ssd_both(case, dtype, state=False, seed=0):
    """(jax args, torch args, jax h0, torch h0): x, B, C in ``dtype``; dt,
    A and the state f32."""
    x, dt, A, Bm, Cm, h0 = _ssd_np(case, seed, state)
    jx, tx = _pair(x, dtype)
    jb, tb = _pair(Bm, dtype)
    jc, tc = _pair(Cm, dtype)
    jargs = (jx, jnp.asarray(dt), jnp.asarray(A), jb, jc)
    targs = (tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc)
    jh = None if h0 is None else jnp.asarray(h0)
    th = None if h0 is None else torch.from_numpy(h0)
    return jargs, targs, jh, th


# ---------------------------------------------------------------------------
# SSD references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("state", [False, True])
def test_ssd_ref_matches_jax(case, dtype, state):
    jargs, targs, jh, th = _ssd_both(case, dtype, state)
    chunk = case[-1]
    jy, jhn = jref.ssd_ref(*jargs, chunk=chunk, init_state=jh,
                           return_state=True)
    ty, thn = tref.ssd_ref(*targs, chunk=chunk, init_state=th,
                           return_state=True)
    assert ty.dtype == getattr(torch, dtype) and thn.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), **_ssd_tol(dtype))
    np.testing.assert_allclose(_np(thn), _np(jhn), **_ssd_tol(dtype))
    # without return_state: y alone
    y_only = tref.ssd_ref(*targs, chunk=chunk, init_state=th)
    assert torch.equal(y_only, ty)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_ref_matches_pallas_interpret(case, dtype):
    """The Pallas kernel in interpret mode (which clamps the chunk to S)
    against the port's plain version (which does not): the same y."""
    jargs, targs, _, _ = _ssd_both(case, dtype, seed=1)
    jy = ssd_pallas(*jargs, chunk=case[-1])
    ty = tref.ssd_ref(*targs, chunk=case[-1])
    np.testing.assert_allclose(_np(ty), _np(jy), **_ssd_tol(dtype))


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("state", [False, True])
def test_ssd_sequential_and_decode_refs_match_jax(case, dtype, state):
    jargs, targs, jh, th = _ssd_both(case, dtype, state, seed=2)
    jy, jhn = jref.ssd_sequential_ref(*jargs, init_state=jh)
    ty, thn = tref.ssd_sequential_ref(*targs, init_state=th)
    np.testing.assert_allclose(_np(ty), _np(jy), **_ssd_tol(dtype))
    np.testing.assert_allclose(_np(thn), _np(jhn), **_ssd_tol(dtype))
    # one decode step from the final state
    Bb, _, H, P, G, N, _ = case
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((Bb, H, P), np.float32) * 0.5
    dt1 = np.log1p(np.exp(rng.standard_normal((Bb, H), np.float32)))
    b1 = rng.standard_normal((Bb, G, N), np.float32) * 0.3
    c1 = rng.standard_normal((Bb, G, N), np.float32) * 0.3
    jx1, tx1 = _pair(x1, dtype)
    jb1, tb1 = _pair(b1, dtype)
    jc1, tc1 = _pair(c1, dtype)
    jyd, jhd = jref.ssd_decode_ref(jx1, jnp.asarray(dt1), jargs[2], jb1,
                                   jc1, jhn)
    tyd, thd = tref.ssd_decode_ref(tx1, torch.from_numpy(dt1), targs[2],
                                   tb1, tc1, thn)
    assert tyd.dtype == getattr(torch, dtype) and thd.dtype == torch.float32
    np.testing.assert_allclose(_np(tyd), _np(jyd), **_ssd_tol(dtype))
    np.testing.assert_allclose(_np(thd), _np(jhd), **_ssd_tol(dtype))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_ref_matches_sequential(case):
    """The twin of tests/test_kernels.py's sweep: the chunked scan against
    the token-by-token recurrence, y and the final state."""
    _, targs, _, th = _ssd_both(case, "float32", state=True, seed=4)
    y, h = tref.ssd_ref(*targs, chunk=case[-1], init_state=th,
                        return_state=True)
    ys, hs = tref.ssd_sequential_ref(*targs, init_state=th)
    torch.testing.assert_close(y, ys, **_ssd_tol("float32"))
    torch.testing.assert_close(h, hs, **_ssd_tol("float32"))


def test_ssd_ref_chunk_invariance():
    """Twin of tests/test_kernels.py: the chunk size does not change the
    result (the SSD identity)."""
    _, targs, _, _ = _ssd_both((2, 120, 4, 16, 2, 32, 0), "float32", seed=3)
    outs = [tref.ssd_ref(*targs, chunk=c) for c in (16, 40, 120)]
    for o in outs[1:]:
        torch.testing.assert_close(outs[0], o, rtol=2e-4, atol=2e-4)


def test_ssd_state_chaining_equals_decode():
    """Twin of tests/test_kernels.py: prefill state + one decode step ==
    one longer prefill; and two chained scans == one scan."""
    _, (x, dt, A, Bm, Cm), _, _ = _ssd_both((1, 33, 2, 8, 1, 16, 0),
                                            "float32", seed=4)
    y_full, h_full = tref.ssd_ref(x, dt, A, Bm, Cm, chunk=16,
                                  return_state=True)
    _, h = tref.ssd_ref(x[:, :-1], dt[:, :-1], A, Bm[:, :-1], Cm[:, :-1],
                        chunk=16, return_state=True)
    y_dec, h_dec = tref.ssd_decode_ref(x[:, -1], dt[:, -1], A, Bm[:, -1],
                                       Cm[:, -1], h)
    torch.testing.assert_close(y_full[:, -1], y_dec, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h_full, h_dec, rtol=2e-4, atol=2e-4)
    y1, h1 = tref.ssd_ref(x[:, :20], dt[:, :20], A, Bm[:, :20], Cm[:, :20],
                          chunk=16, return_state=True)
    y2, h2 = tref.ssd_ref(x[:, 20:], dt[:, 20:], A, Bm[:, 20:], Cm[:, 20:],
                          chunk=16, init_state=h1, return_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(h2, h_full, rtol=2e-4, atol=2e-4)


def test_ops_ssd_dispatch_on_cpu():
    _, targs, _, th = _ssd_both(SSD_CASES[1], "float32", state=True)
    want = tref.ssd_ref(*targs, chunk=64, init_state=th, return_state=True)
    n = tssd.launches
    for use in (None, False):
        got = tops.ssd(*targs, chunk=64, init_state=th, return_state=True,
                       use_kernels=use)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        tops.ssd(*targs, chunk=64, use_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_cuda(*targs, chunk=64)
    assert tssd.launches == n
    # ssd_decode is the plain recurrence on every device
    x, dt, A, Bm, Cm = targs
    got = tops.ssd_decode(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], th)
    want = tref.ssd_decode_ref(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], th)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the plain path keeps gradients (autograd through ssd_ref)
    xg = x.clone().requires_grad_()
    tops.ssd(xg, dt, A, Bm, Cm, chunk=64).sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


# ---------------------------------------------------------------------------
# Mamba2 block pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(dtype, with_tail):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 24), np.float32)
    w = rng.standard_normal((4, 24), np.float32) * 0.5
    b = rng.standard_normal((24,), np.float32) * 0.1
    tail = rng.standard_normal((2, 3, 24), np.float32) if with_tail else None
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    jt, tt = _pair(tail, dtype) if with_tail else (None, None)
    jy, jtail = jmamba._causal_conv(jx, jw, jb, jt)
    ty, ttail = tmamba._causal_conv(tx, tw, tb, tt)
    assert ty.shape == (2, 9, 24) and ty.is_contiguous()
    tol = MODEL_TOL[dtype]
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)
    np.testing.assert_array_equal(_np(ttail), _np(jtail))
    # a 1-token step with the tail equals the last row of a longer conv
    y1, _ = tmamba._causal_conv(tx[:, -1:], tw, tb, tx[:, -4:-1])
    torch.testing.assert_close(y1[:, 0], ty[:, -1], rtol=tol, atol=tol)


def _cast_like_model(tree, dtype):
    """Casts the bf16 leaves to ``dtype``; f32 leaves (A_log, D, dt_bias)
    stay f32, as the model defines them."""
    return jax.tree.map(
        lambda a: a.astype(getattr(jnp, dtype))
        if a.dtype == jnp.bfloat16 else a, tree)


@pytest.fixture(scope="module")
def jax_params():
    return {arch: JP.materialize(jax.random.PRNGKey(0),
                                 jreg.param_defs(j_smoke(arch)))
            for arch in ARCHS}


def _both_params(jax_params, arch, dtype):
    """(JAX tree, port tree, JAX f32 tree with the same values)."""
    jp = _cast_like_model(jax_params[arch], dtype)
    tp = TP.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp, _cast_like_model(jp, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_block_fwd_matches_jax(jax_params, dtype, with_state):
    arch = "mamba2-130m"
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    jp, tp, _ = _both_params(jax_params, arch, dtype)
    jb = jax.tree.map(lambda a: a[0], jp["blocks"])
    tb = TP.tree_map(lambda a: a[0], tp["blocks"])
    x = np.random.default_rng(6).standard_normal((B, 37, tcfg.d_model),
                                                 np.float32)
    jx, tx = _pair(x, dtype)
    jstate = tstate = None
    if with_state:
        rng = np.random.default_rng(7)
        defs = tmamba.state_defs(tcfg, 0, B)
        # tails in the activations' dtype, the SSM state in f32
        pairs = {k: _pair(rng.standard_normal(d.shape, np.float32) * 0.1,
                          "float32" if k == "ssm" else dtype)
                 for k, d in defs.items()}
        jstate = {k: v[0] for k, v in pairs.items()}
        tstate = {k: v[1] for k, v in pairs.items()}
    jy, jns = jmamba.block_fwd(jb, jcfg, JRunConfig(), jx, jstate)
    ty = tmamba.block_fwd(tb, tcfg, RunConfig(), tx, tstate)
    tol = MODEL_TOL[dtype]
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)
    if with_state:  # updated in place
        for k in ("tail_x", "tail_B", "tail_C", "ssm"):
            np.testing.assert_allclose(_np(tstate[k]), _np(jns[k]),
                                       rtol=tol, atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(jax_params, arch):
    """Keys, shapes and dtypes of the port's defs against the JAX defs;
    ``from_jax_params`` keeps every leaf bit for bit, f32 leaves too."""
    jdefs = jreg.param_defs(j_smoke(arch))
    tdefs = treg.param_defs(get_smoke_config(arch))
    jl = jax.tree_util.tree_leaves_with_path(
        jdefs, is_leaf=lambda d: isinstance(d, JP.ParamDef))
    assert len(jl) == len(list(TP.tree_leaves(tdefs)))
    tp = TP.from_jax_params(jax.tree.map(np.asarray, jax_params[arch]),
                            device="cpu")
    n_f32 = 0
    for path, d in jl:
        td, t = tdefs, tp
        for k in path:
            td, t = td[k.key], t[k.key]
        assert td.shape == tuple(d.shape), path
        assert str(td.dtype)[6:] == jnp.dtype(d.dtype).name, path
        assert tuple(t.shape) == tuple(d.shape) and t.dtype == td.dtype
        leaf = jax_params[arch]
        for k in path:
            leaf = leaf[k.key]
        if t.dtype == torch.float32:
            n_f32 += 1
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
        else:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          np.asarray(leaf).view(np.int16))
    assert n_f32 == 3  # A_log, D, dt_bias
    assert TP.param_count(tdefs) == JP.param_count(jdefs)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_match_jax(arch):
    from repro.configs.base import get_config as j_config
    for mk_j, mk_t in ((j_config, get_config), (j_smoke, get_smoke_config)):
        j, t = mk_j(arch), mk_t(arch)
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "ssm_state", "ssm_expand", "ssm_head_dim", "ssm_chunk",
                  "ssm_conv", "attn_every", "gated_mlp", "act",
                  "rope_theta", "norm_eps", "tie_embeddings", "ssm_inner",
                  "ssm_heads"):
            assert getattr(t, f) == getattr(j, f), (arch, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_init_kinds(arch):
    """ssm_a: the log of U[1, 16]; ssm_dt: the inverse softplus of
    U[1e-3, 1e-1]; both f32."""
    cfg = get_smoke_config(arch).replace(num_layers=64)
    p = tserve.init_params(cfg, 0, torch.device("cpu"))["blocks"]
    a = torch.exp(p["A_log"])
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert p["A_log"].dtype == p["dt_bias"].dtype == torch.float32
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 0.1 + 1e-6
    assert float(a.std()) > 2.0  # spread over the interval
    assert torch.equal(p["D"], torch.ones_like(p["D"]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_hidden_states_match_jax(jax_params, arch, dtype):
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    jp, tp, jp32 = _both_params(jax_params, arch, dtype)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (B, S),
                                             dtype=np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    want = jreg.forward(jp, jcfg, JRunConfig(), batch)
    truth = jreg.forward(jp32, jcfg, JRunConfig(), batch)
    got = treg.forward(tp, tcfg, RunConfig(),
                       {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, S, tcfg.d_model)
    assert got.dtype == getattr(torch, dtype)
    _check(got, want, truth, dtype)


def _caches(jcfg, tcfg, dtype):
    """Fresh caches for both packages.  With f32 weights the conv tails
    are f32 in both: JAX returns them in the activations' dtype after a
    prefill, where the port writes into the cache's own dtype."""
    jc = jengine.init_cache(jcfg, B, MAX_LEN)
    tc = tengine.init_cache(tcfg, B, MAX_LEN, device="cpu")
    if dtype == "float32":
        jm = jc["mamba"] if "mamba" in jc else jc
        tm = tc["mamba"] if "mamba" in tc else tc
        for k in ("tail_x", "tail_B", "tail_C"):
            jm[k] = jm[k].astype(jnp.float32)
            tm[k] = tm[k].float()
    return jc, tc


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_jax(jax_params, arch, dtype):
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    jp, tp, jp32 = _both_params(jax_params, arch, dtype)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, tcfg.vocab_size, (B, S), dtype=np.int32)
    jrun, run = JRunConfig(), RunConfig()
    jcache, tcache = _caches(jcfg, tcfg, dtype)
    xcache, _ = _caches(jcfg, tcfg, "float32")  # JAX f32 (bf16 case)
    batch = {"tokens": jnp.asarray(prompt)}
    jlog, jcache = jreg.prefill(jp, jcfg, jrun, batch, jcache)
    xlog, xcache = jreg.prefill(jp32, jcfg, jrun, batch, xcache)
    tlog, tcache = treg.prefill(
        tp, tcfg, run, {"tokens": torch.from_numpy(prompt).long()}, tcache)
    assert tlog.shape == (B, 1, tcfg.vocab_size)
    assert tlog.dtype == torch.float32
    # logits of the prefill and each decode step; in bf16 checked together
    # at the end (one step's 2 x 256 logits give a noisy relative L2)
    logits = [(_np(tlog), _np(jlog), _np(xlog))]

    # the state (and KV cache) after the prefill
    def mamba(c):
        return c["mamba"] if "mamba" in c else c

    jm, tm, xm = mamba(jcache), mamba(tcache), mamba(xcache)
    assert tm["ssm"].dtype == torch.float32
    pairs = [(k, tm[k], jm[k], xm[k])
             for k in ("tail_x", "tail_B", "tail_C", "ssm")]
    if "kv" in tcache:
        assert tcache["kv"]["k"].dtype == torch.bfloat16
        pairs += [(k, tcache["kv"][k], jcache["kv"][k], xcache["kv"][k])
                  for k in ("k", "v")]
    for k, t, j, x in pairs:
        if dtype == "float32":  # one bf16 ulp of a cached K/V element
            tol = MODEL_TOL[dtype] if k not in ("k", "v") else 2.0 ** -7
            np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol,
                                       err_msg=k)
        else:
            _check(t, j, x, dtype, k)

    # greedy decode: the JAX tokens fed to all three
    tok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1)).astype(np.int32)
    for i in range(N_DECODE):
        pos = S + i
        step = tok[:, None]
        jpos = jnp.asarray(pos, jnp.int32)
        jlog, jcache = jreg.decode(jp, jcfg, jrun, jnp.asarray(step),
                                   jcache, jpos)
        xlog, xcache = jreg.decode(jp32, jcfg, jrun, jnp.asarray(step),
                                   xcache, jpos)
        tlog, tcache = treg.decode(tp, tcfg, run,
                                   torch.from_numpy(step).long(), tcache,
                                   pos)
        logits.append((_np(tlog), _np(jlog), _np(xlog)))
        tok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1)).astype(np.int32)
    if dtype == "float32":
        for i, (t, j, _) in enumerate(logits):
            _check(t, j, None, dtype, f"logits of step {i}")
    else:
        _check(*(np.concatenate(a) for a in zip(*logits)), dtype, "logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(jax_params, arch):
    """With f32 weights, the port's own greedy tokens (prefill, then its
    own argmax fed back) equal the JAX engine's."""
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    jp, tp, _ = _both_params(jax_params, arch, "float32")
    prompt = np.random.default_rng(8).integers(0, tcfg.vocab_size, (B, S),
                                               dtype=np.int32)
    jcache, tcache = _caches(jcfg, tcfg, "float32")
    run, jrun = RunConfig(), JRunConfig()
    jt, jcache = jengine.make_prefill_step(jcfg, jrun)(
        jp, {"tokens": jnp.asarray(prompt)}, jcache)
    tt, tcache = tengine.prefill_step(
        tp, {"tokens": torch.from_numpy(prompt).long()}, tcache, cfg=tcfg,
        run=run)
    jseq, tseq = [np.asarray(jt)], [tt.numpy()]
    dec = jengine.make_decode_step(jcfg, jrun)
    for i in range(N_DECODE):
        jt, jcache = dec(jp, jt, jcache, jnp.asarray(S + i, jnp.int32))
        tt, tcache = tengine.decode_step(tp, tt, tcache, S + i, cfg=tcfg,
                                         run=run)
        jseq.append(np.asarray(jt))
        tseq.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(tseq, 1),
                                  np.concatenate(jseq, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_longer_prefill(arch):
    """Twin of tests/test_models.py::test_decode_matches_prefill_logits:
    decode at position S after a prefill of S tokens equals the last
    logits of a prefill of S + 1 tokens, across a chunk boundary."""
    cfg = get_smoke_config(arch)
    run = RunConfig()
    params = TP.cast_tree(tserve.init_params(cfg, 0, torch.device("cpu")),
                          torch.float32)
    toks = torch.randint(2, cfg.vocab_size, (B, 33),
                         generator=torch.Generator().manual_seed(5))

    def cache():
        c = tengine.init_cache(cfg, B, 48, device="cpu")
        return TP.tree_map(lambda t: t.float(), c)

    la, _ = treg.prefill(params, cfg, run, {"tokens": toks}, cache())
    c = cache()
    _, c = treg.prefill(params, cfg, run, {"tokens": toks[:, :32]}, c)
    lb, _ = treg.decode(params, cfg, run, toks[:, 32:33], c, 32)
    torch.testing.assert_close(la[:, -1], lb[:, -1], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serving_on_cpu(arch):
    res = tserve.run_serving(arch, smoke=True, prompt_len=40, gen=3,
                             batch=2, device="cpu")
    assert res["generated"] == (2, 3) and res["device"] == "cpu"
    tok = res["tokens"]
    assert bool(((tok >= 0) & (tok < 256)).all())
    again = tserve.run_serving(arch, smoke=True, prompt_len=40, gen=3,
                               batch=2, device="cpu")
    assert torch.equal(again["tokens"], tok)
