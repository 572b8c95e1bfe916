"""The port's yi-6b serving slice against the JAX reference, on the CPU
(the other dense and the MoE archs: tests/test_torch_serving_archs.py).

JAX weights from ``repro.models.params.materialize`` are carried over with
``from_jax_params``; the same numpy prompt and decode tokens go through
``repro.models.registry.prefill``/``decode`` (called directly, outside
``use_rules``) and through the port.

Tolerances: 2e-3 with f32 params — the KV cache is bf16 in both, and a
cached element can round one bf16 ulp apart when the f32 projections sum
in another order; 3e-2 with bf16 params, as tests/test_models.py uses for
bf16 logits (bf16 matmul outputs round at other places in the two
frameworks).
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
from repro.serve import engine as jengine
from repro_torch.configs.base import RunConfig, get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import params as TP
from repro_torch.models import registry as treg
from repro_torch.serve import engine as tengine

ARCH = "yi-6b"
B, S, MAX_LEN, N_DECODE = 2, 12, 24, 4
TOL = {"float32": 2e-3, "bfloat16": 3e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def jax_params():
    cfg = j_smoke(ARCH)
    return JP.materialize(jax.random.PRNGKey(0), jreg.param_defs(cfg))


def _both_params(jax_params, dtype):
    jp = JP.cast_tree(jax_params, getattr(jnp, dtype))
    tp = TP.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def test_from_jax_params_keeps_keys_shapes_and_bits(jax_params):
    tp = TP.from_jax_params(jax.tree.map(np.asarray, jax_params),
                            device="cpu")
    cfg = get_smoke_config(ARCH)
    defs = treg.param_defs(cfg)
    j_leaves = jax.tree_util.tree_leaves_with_path(jax_params)
    assert len(j_leaves) == len(list(TP.tree_leaves(defs)))
    for path, leaf in j_leaves:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(leaf).view(np.int16))
    assert TP.param_count(defs) == JP.param_count(jreg.param_defs(
        j_smoke(ARCH)))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_params, dtype, use_pallas):
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jrun = JRunConfig(use_pallas=use_pallas)
    run = RunConfig()
    jp, tp = _both_params(jax_params, dtype)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, tcfg.vocab_size, (B, S), dtype=np.int32)
    steps = rng.integers(0, tcfg.vocab_size, (N_DECODE, B, 1),
                         dtype=np.int32)
    tol = TOL[dtype]

    jcache = jengine.init_cache(jcfg, B, MAX_LEN)
    jlog, jcache = jreg.prefill(jp, jcfg, jrun,
                                {"tokens": jnp.asarray(prompt)}, jcache)
    tcache = tengine.init_cache(tcfg, B, MAX_LEN, device="cpu")
    tlog, tcache = treg.prefill(
        tp, tcfg, run, {"tokens": torch.from_numpy(prompt).long()}, tcache)
    assert tlog.shape == (B, 1, tcfg.vocab_size)
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=tol, atol=tol)
    # a cached bf16 element may sit one bf16 ulp (2^-7 relative) apart
    cache_tol = max(tol, 2.0 ** -7)
    for name in ("k", "v"):
        assert tcache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   rtol=cache_tol, atol=cache_tol)

    for i in range(N_DECODE):
        pos = S + i
        jlog, jcache = jreg.decode(jp, jcfg, jrun, jnp.asarray(steps[i]),
                                   jcache, jnp.asarray(pos, jnp.int32))
        tlog, tcache = treg.decode(tp, tcfg, run,
                                   torch.from_numpy(steps[i]).long(),
                                   tcache, pos)
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=tol,
                                   atol=tol, err_msg=f"decode step {i}")


def test_decode_matches_longer_prefill():
    """Decode at position S after a prefill of S tokens equals the last
    logits of a prefill of S + 1 tokens (cache correctness)."""
    cfg = get_smoke_config(ARCH)
    run = RunConfig()
    params = TP.cast_tree(tserve.init_params(cfg, 0, torch.device("cpu")),
                          torch.float32)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(2, cfg.vocab_size, (B, 16), generator=g)
    la, _ = treg.prefill(params, cfg, run, {"tokens": toks},
                         tengine.init_cache(cfg, B, 32, device="cpu"))
    cache = tengine.init_cache(cfg, B, 32, device="cpu")
    _, cache = treg.prefill(params, cfg, run, {"tokens": toks[:, :15]},
                            cache)
    lb, _ = treg.decode(params, cfg, run, toks[:, 15:16], cache, 15)
    torch.testing.assert_close(la[:, -1], lb[:, -1], rtol=2e-3, atol=2e-3)


def test_run_serving_on_cpu():
    res = tserve.run_serving(ARCH, smoke=True, prompt_len=8, gen=3, batch=2,
                             device="cpu")
    assert res["generated"] == (2, 3) and res["device"] == "cpu"
    tok = res["tokens"]
    assert bool(((tok >= 0) & (tok < 256)).all())
    assert res["prefill_s"] > 0 and res["decode_s"] > 0
    # the same seed gives the same tokens
    again = tserve.run_serving(ARCH, smoke=True, prompt_len=8, gen=3,
                               batch=2, device="cpu")
    assert torch.equal(again["tokens"], tok)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.run_serving(ARCH, smoke=True, prompt_len=4, gen=2, batch=1)


def test_unported_configs_raise():
    """The families still to port (encoder-decoder, VLM) raise; a cache
    dtype other than bf16 and int8 raises; an int8 cache has the JAX
    structure (int8 K/V, f32 scales per (token, head))."""
    cfg = get_smoke_config(ARCH)
    for family in ("encdec", "vlm"):
        with pytest.raises(NotImplementedError):
            treg.param_defs(cfg.replace(family=family))
    with pytest.raises(NotImplementedError):
        tengine.init_cache(cfg.replace(kv_cache_dtype="float8"), 1, 4,
                           device="cpu")
    int8 = cfg.replace(kv_cache_dtype="int8")
    got = tengine.init_cache(int8, 1, 4, device="cpu")
    want = jengine.init_cache(j_smoke(ARCH).replace(kv_cache_dtype="int8"),
                              1, 4)
    assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape
        assert str(got[name].dtype)[6:] == jnp.dtype(leaf.dtype).name
        assert not bool(got[name].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_hidden_states_match_jax(jax_params, dtype):
    """ROADMAP A2: final hidden states of ``registry.forward`` (the
    training forward, ln_f applied) against the JAX ``registry.forward``
    on the same weights, with and without activation checkpointing."""
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jp, tp = _both_params(jax_params, dtype)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (B, S),
                                             dtype=np.int32)
    want = jreg.forward(jp, jcfg, JRunConfig(), {"tokens": jnp.asarray(toks)})
    for remat in ("full", "none"):
        got = treg.forward(tp, tcfg, RunConfig(remat=remat),
                           {"tokens": torch.from_numpy(toks).long()})
        assert got.shape == (B, S, tcfg.d_model)
        assert got.dtype == getattr(torch, dtype)
        tol = TOL[dtype]
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_kernel_ops_keep_gradients():
    """The norms and the attention of the model pass gradients on: their
    autograd Functions (on the CPU, the plain forward and the custom
    backward) give what autograd through the plain forward gives, and a
    model forward puts a gradient on every parameter."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 32, generator=g, requires_grad=True)
    w = torch.randn(32, generator=g, requires_grad=True)
    dy = torch.randn(6, 32, generator=g)
    gx, gw = torch.autograd.grad(ops.rmsnorm(x, w, eps=1e-5), (x, w), dy)
    rx, rw = torch.autograd.grad(ref.rmsnorm_ref(x, w, 1e-5), (x, w), dy)
    torch.testing.assert_close(gx, rx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gw, rw, rtol=1e-5, atol=1e-6)

    q = torch.randn(2, 12, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 12, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 12, 2, 16, generator=g, requires_grad=True)
    do = torch.randn(2, 12, 4, 16, generator=g)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, block_k=8),
                              (q, k, v), do)
    want = torch.autograd.grad(ref.attention_naive(q, k, v), (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)

    cfg = get_smoke_config(ARCH)
    params = TP.tree_map(lambda t: t.float().requires_grad_(),
                         tserve.init_params(cfg, 0, torch.device("cpu")))
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    treg.forward(params, cfg, RunConfig(), {"tokens": toks}).sum().backward()
    params["embed"].pop("lm_head")  # the LM head is not part of forward
    for leaf in TP.tree_leaves(params):
        assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
        assert float(leaf.grad.norm()) > 0
