"""The port's serving of qwen1.5-4b, qwen1.5-32b, starcoder2-15b,
mixtral-8x7b and qwen3-moe-235b-a22b against the JAX reference, on the
CPU, at their smoke configs.

JAX weights from ``repro.models.params.materialize`` are carried over with
``from_jax_params``; the same numpy prompts and decode tokens go through
``repro.models.registry.prefill``/``decode`` (outside ``use_rules``, so
the MoE block is ``_moe_block_gspmd``, the one-device path) and through
the port, with ``use_pallas`` False and True on the JAX side as its own
tests run it on the CPU.

Tolerances, as tests/test_torch_serving.py: logits 2e-3 with f32 params,
3e-2 with bf16 params.  The MoE block alone: 3e-5 in f32 (products summed
in another order) and 2e-2 in bf16 (one output rounding apart), as
tests/test_kernels.py.  The int8 cache: quantisation of the same inputs
is bit-equal; through a model, a cached int8 element may be 1 apart
where its value sits at a rounding midpoint (its f32 K/V differ in the
last bits), and the f32 scales agree to 1e-6 relative.  With bf16 params
that holds at layer 0; a later layer's K/V differ by a bf16 ulp or two
before quantisation, so there an element is within 3 steps (3e-2 of its
amax) and a scale within 3e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import registry as jreg
from repro.serve import engine as jengine
from repro_torch.configs.base import RunConfig, get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import params as TP
from repro_torch.models import registry as treg
from repro_torch.serve import engine as tengine

ARCHS = ["qwen1.5-4b", "qwen1.5-32b", "starcoder2-15b", "mixtral-8x7b",
         "qwen3-moe-235b-a22b"]
MOE_ARCHS = ["mixtral-8x7b", "qwen3-moe-235b-a22b"]
B, S, N_DECODE = 2, 12, 3
TOL = {"float32": 2e-3, "bfloat16": 3e-2}
MOE_TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.cache
def _jax_params(arch):
    return JP.materialize(jax.random.PRNGKey(0),
                          jreg.param_defs(j_smoke(arch)))


def _both_params(arch, dtype):
    jp = JP.cast_tree(_jax_params(arch), getattr(jnp, dtype))
    tp = TP.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _serve_both(arch, dtype, use_pallas, prompt_len, n_decode,
                kv_cache_dtype=None, seed=3):
    """Prefill and ``n_decode`` decode steps through both packages, the
    logits compared at each; returns both caches."""
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    if kv_cache_dtype:
        jcfg = jcfg.replace(kv_cache_dtype=kv_cache_dtype)
        tcfg = tcfg.replace(kv_cache_dtype=kv_cache_dtype)
    jrun, run = JRunConfig(use_pallas=use_pallas), RunConfig()
    jp, tp = _both_params(arch, dtype)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, tcfg.vocab_size, (B, prompt_len),
                          dtype=np.int32)
    steps = rng.integers(0, tcfg.vocab_size, (n_decode, B, 1),
                         dtype=np.int32)
    max_len = prompt_len + n_decode + 4
    tol = TOL[dtype]

    jcache = jengine.init_cache(jcfg, B, max_len)
    jlog, jcache = jreg.prefill(jp, jcfg, jrun,
                                {"tokens": jnp.asarray(prompt)}, jcache)
    tcache = tengine.init_cache(tcfg, B, max_len, device="cpu")
    tlog, tcache = treg.prefill(
        tp, tcfg, run, {"tokens": torch.from_numpy(prompt).long()}, tcache)
    assert tlog.shape == (B, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=tol, atol=tol,
                               err_msg="prefill")
    for i in range(n_decode):
        pos = prompt_len + i
        jlog, jcache = jreg.decode(jp, jcfg, jrun, jnp.asarray(steps[i]),
                                   jcache, jnp.asarray(pos, jnp.int32))
        tlog, tcache = treg.decode(tp, tcfg, run,
                                   torch.from_numpy(steps[i]).long(),
                                   tcache, pos)
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=tol,
                                   atol=tol, err_msg=f"decode step {i}")
    return jcache, tcache


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, use_pallas):
    jcache, tcache = _serve_both(arch, dtype, use_pallas, S, N_DECODE)
    cache_tol = max(TOL[dtype], 2.0 ** -7)  # one bf16 ulp of a cached K/V
    for name in ("k", "v"):
        assert tcache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   rtol=cache_tol, atol=cache_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixtral_prompt_longer_than_its_window(dtype):
    """The smoke config's window of 64 bites on the prompt's last 16
    queries in the prefill (the flash path) and on every decode step (the
    plain decode attention)."""
    cfg = get_smoke_config("mixtral-8x7b")
    assert cfg.sliding_window == 64
    _serve_both("mixtral-8x7b", dtype, False, 80, N_DECODE)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_cache_matches_jax(dtype, use_pallas):
    """qwen1.5-4b-smoke with the int8 KV cache of its full config: logits
    after prefill and decode, and the cache's leaves."""
    jcache, tcache = _serve_both("qwen1.5-4b", dtype, use_pallas, S,
                                 N_DECODE, kv_cache_dtype="int8")
    assert set(tcache) == set(jcache) == {"k", "v", "k_scale", "v_scale"}
    # the layers whose K/V reach the quantisation with the same bits in
    # both packages up to the products' last f32 bits: all with f32
    # params; with bf16 params only layer 0 (later layers' K/V sit a bf16
    # ulp or two apart, as the bf16 cache does in the other tests)
    strict = tcache["k"].shape[0] if dtype == "float32" else 1
    for name in ("k", "v"):
        assert tcache[name].dtype == torch.int8
        assert tcache[name + "_scale"].dtype == torch.float32
        got = tcache[name].numpy().astype(np.int32)
        want = np.asarray(jcache[name]).astype(np.int32)
        s_got = tcache[name + "_scale"].numpy()
        s_want = np.asarray(jcache[name + "_scale"])
        diff = np.abs(got - want)
        assert diff[:strict].max() <= 1, name
        # a midpoint is rare: at most a few elements of the cache
        assert (diff[:strict] > 0).mean() <= 1e-3, name
        np.testing.assert_allclose(s_got[:strict], s_want[:strict],
                                   rtol=1e-6, atol=0)
        # the rest: dequantized within 3e-2 of each (token, head)'s amax
        # (3 steps of amax / 127), scales within 3e-2
        assert diff[strict:].max(initial=0) <= 3, name
        np.testing.assert_allclose(s_got[strict:], s_want[strict:],
                                   rtol=TOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_kv_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16), np.float32) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero (token, head): scale 1e-6 / 127
    # amax 127 -> scale 1: values at midpoints round half to even
    x[1, 1, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] + [0.0] * 8
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = JL.quantize_kv(jx)
    tq, ts = TL.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert list(tq[1, 1, 1, :8]) == [127, 0, 2, 2, 0, -2, -2, 4]
    jd = JL.dequantize_kv(jq, js)
    td = TL.dequantize_kv(tq, ts)
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(td), _np(jd))


# B, S, capacity factor: decode (C = 1), the config's own factor, and a
# factor low enough that experts overflow and pairs drop
MOE_CASES = [(2, 1, None), (2, 24, None), (3, 40, 0.5)]


@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_jax_gspmd(arch, dtype, case):
    """``moe_block`` alone against ``_moe_block_gspmd`` on the same
    inputs and layer-0 weights, dropped pairs included."""
    Bm, Sm, factor = case
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    if factor is not None:
        jcfg = jcfg.replace(moe_capacity_factor=factor)
        tcfg = tcfg.replace(moe_capacity_factor=factor)
    jp, tp = _both_params(arch, dtype)
    jp = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tp = TP.layer(tp["blocks"]["moe"], 0)
    x = np.random.default_rng(1).standard_normal((Bm, Sm, tcfg.d_model),
                                                 np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = JL._moe_block_gspmd(jp, jcfg, JRunConfig(), jx)
    got = TL.moe_block(tp, tcfg, RunConfig(), tx)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    tol = MOE_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)

    route = TL.moe_route(tp, tcfg, tx)
    K = tcfg.num_experts_per_tok
    assert route.experts.shape == (Bm, Sm, K)
    assert bool((route.experts[..., 1:] > route.experts[..., :-1]).all())
    torch.testing.assert_close(route.weights.sum(-1),
                               torch.ones(Bm, Sm), rtol=1e-6, atol=1e-6)
    if factor is not None:
        # the test holds the drop order against JAX only if pairs drop
        assert not bool(route.keep.all())
        # the latest tokens of a row drop first: a kept pair's expert
        # has all its earlier pairs kept
        for b in range(Bm):
            for e in range(tcfg.num_experts):
                kept = route.keep[b][route.experts[b] == e]
                n = int(kept.sum())
                assert bool(kept[:n].all()) and not bool(kept[n:].any())
    if Sm == 1:
        assert route.capacity == 1 and bool(route.keep.all())


def test_moe_top_k_ties_take_the_lower_expert():
    """Equal gates: ``lax.top_k`` takes the lower index first; the port's
    stable descending sort does the same."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    p = {"router": torch.zeros(cfg.d_model, cfg.num_experts)}
    route = TL.moe_route(p, cfg, torch.randn(1, 3, cfg.d_model))
    K = cfg.num_experts_per_tok
    assert route.experts.tolist() == [[list(range(K))] * 3]
    torch.testing.assert_close(route.weights, torch.full((1, 3, K), 1 / K))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_longer_prefill(arch):
    """Decode at position S after a prefill of S tokens equals the last
    logits of a prefill of S + 1 tokens, with the capacity factor raised
    to E / K so that C >= S and no pair drops (at the config's own factor
    the longer prefill may drop its last token from an overflowing
    expert; decode, C = 1 a row, never does)."""
    cfg = get_smoke_config(arch)
    cfg = cfg.replace(
        moe_capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_hidden_states_match_jax(arch):
    """The training forward of an MoE arch (ln_f applied) against the JAX
    ``registry.forward`` on the same f32 weights."""
    jp, tp = _both_params(arch, "float32")
    toks = np.random.default_rng(4).integers(
        0, get_smoke_config(arch).vocab_size, (B, S), dtype=np.int32)
    want = jreg.forward(jp, j_smoke(arch), JRunConfig(),
                        {"tokens": jnp.asarray(toks)})
    got = treg.forward(tp, get_smoke_config(arch), RunConfig(remat="none"),
                       {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """Same keys, shapes and dtypes as the JAX defs (the MoE router in
    f32), so ``from_jax_params`` carries the weights across."""
    jdefs = jreg.param_defs(j_smoke(arch))
    tdefs = treg.param_defs(get_smoke_config(arch))
    j_leaves = jax.tree_util.tree_leaves_with_path(
        jdefs, is_leaf=JP.is_def)
    assert len(j_leaves) == len(list(TP.tree_leaves(tdefs)))
    for path, jd in j_leaves:
        td = tdefs
        for k in path:
            td = td[k.key]
        assert td.shape == tuple(jd.shape), path
        assert str(td.dtype)[6:] == jnp.dtype(jd.dtype).name, path


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "qwen3-moe-235b-a22b"])
def test_run_serving_cuts_depth_on_cpu(arch):
    res = tserve.run_serving(arch, smoke=True, prompt_len=8, gen=3, batch=2,
                             device="cpu", num_layers=1)
    assert res["layers"] == 1 and res["generated"] == (2, 3)
    tok = res["tokens"]
    assert bool(((tok >= 0) & (tok < 256)).all())
    full = tserve.run_serving(arch, smoke=True, prompt_len=8, gen=3,
                              batch=2, device="cpu")
    assert full["layers"] == get_smoke_config(arch).num_layers
