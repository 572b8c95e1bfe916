"""The hand-written CUDA kernels against their plain versions, on a GPU.

These need a CUDA card and nvcc (they build the kernels at first use) and
skip elsewhere.  They import no JAX, so they run on a machine with only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py: 2e-2 in bf16, 3e-5 in f32
(the SSD scan: 3e-2 in bf16, 3e-4 in f32).
"""
import math
import sys

import numpy as np
import pytest
import torch

from repro_torch.carousel.delivery import device_put
from repro_torch.ckpt import AsyncCheckpointer, load_checkpoint
from repro_torch.configs.base import (RunConfig, ShapeConfig, get_config,
                                      get_smoke_config)
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import cross_entropy as kce
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as krms
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.serve import engine
from repro_torch.train import loss as tloss
from repro_torch.train import step as tstep

pytestmark = pytest.mark.cuda

CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len
    (2, 128, 128, 4, 2, 64, True, 0, 0, None),
    (1, 100, 160, 6, 6, 64, True, 0, 0, None),
    (2, 1, 256, 8, 2, 128, True, 0, 200, 201),
    (2, 64, 256, 4, 4, 64, True, 48, 0, None),
    (1, 96, 160, 4, 2, 64, False, 0, 0, None),
    (1, 80, 80, 40, 40, 32, True, 0, 0, None),
    (2, 70, 90, 4, 2, 16, True, 0, 0, 60),          # yi-6b-smoke head_dim
    (1, 300, 1500, 6, 6, 64, False, 0, 0, None),    # whisper cross-attention
]
DTYPES = [torch.float32, torch.bfloat16]
# The backward's tensor-core tiles (64 keys x 32 q rows for dk/dv, 64 q
# rows x 64 keys for dq) against ragged Sq and Sk, G in {1, 8}, D in {64,
# 128}, q_offset with kv_len < Sk, and a sliding window; and the dk/dv
# cluster sizes (the largest divisor of G up to 8): 6 (slices of 11 rows)
# and 8 with two q heads a block (G = 16).
BWD_CASES = CASES + [
    (1, 203, 203, 8, 1, 128, True, 0, 0, None),     # ragged, G = 8
    (2, 77, 141, 4, 4, 64, False, 0, 0, None),      # ragged, G = 1
    (1, 45, 300, 8, 1, 64, True, 0, 230, 275),      # q_offset, kv_len < Sk
    (1, 150, 150, 8, 1, 128, True, 37, 0, None),    # sliding window, G = 8
    (2, 129, 97, 2, 2, 128, True, 0, 0, None),      # Sk < Sq, causal
    (1, 100, 100, 6, 1, 64, True, 0, 0, None),      # G = 6
    (1, 130, 130, 16, 1, 128, True, 0, 0, None),    # G = 16
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tol(dtype):
    t = 2e-2 if dtype == torch.bfloat16 else 3e-5
    return dict(rtol=t, atol=t)


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 384), (1, 513),
                                   (2048, 4096), (4, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w_dtype", DTYPES)  # w is read in its own dtype
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, w_dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(shape[-1:], generator=g, device=cuda).to(w_dtype)
    n = krms.launches
    got = ops.rmsnorm(x, w, eps=1e-5)
    torch.cuda.synchronize()
    assert krms.launches == n + 1
    torch.testing.assert_close(got.float(),
                               ref.rmsnorm_ref(x, w, 1e-5).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len = case
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, Sq, Hq, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, sliding_window=window, q_offset=q_off,
              kv_len=kv_len)
    n = kflash.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kflash.launches == n + 1
    want = ref.attention_naive(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_flash_kernel_reads_strided_cache_views(cuda):
    """K/V as a layer's slice of a stacked cache (non-contiguous in the
    batch axis) give the same answer as contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(2)
    cache = torch.randn((3, 2, 96, 2, 64), generator=g,
                        device=cuda).to(torch.bfloat16)
    k, v = cache[1], cache[2]
    q = torch.randn((2, 40, 4, 64), generator=g,
                    device=cuda).to(torch.bfloat16)
    a = kflash.flash_attention_cuda(q, k, v, kv_len=40)
    b = kflash.flash_attention_cuda(q, k.contiguous(), v.contiguous(),
                                    kv_len=40)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_fwd_tc_kernel_matches_plain_with_lse(cuda, case):
    """The bf16 tensor-core forward's output and lse against the plain
    forward on the backward's ragged cases (G 1 to 16, q_offset with
    kv_len < Sk, a sliding window, Sk < Sq)."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len = case
    g = torch.Generator(device=cuda).manual_seed(10)
    bf = torch.bfloat16
    q = torch.randn((B, Sq, Hq, D), generator=g, device=cuda).to(bf)
    k, v = (torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).to(bf)
            for _ in range(2))
    kw = dict(causal=causal, sliding_window=window, q_offset=q_off,
              kv_len=kv_len)
    n = kflash.launches
    o, lse = kflash.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert kflash.launches == n + 1
    o_ref, lse_ref = ref.flash_attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(o.float(), o_ref.float(), **_tol(bf))
    torch.testing.assert_close(lse, lse_ref, rtol=3e-5, atol=3e-5)


def _off_by_one(t):
    """The values of t in a contiguous view one element past a 16-byte
    aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_fwd_tc_kernel_reads_cache_views_and_copies_misaligned(cuda,
                                                                     D):
    """At every head_dim: K/V as a layer's slice of a stacked cache with
    kv_len < Sk give the bits of contiguous copies; q, k, v (and the
    backward's dout) one element off 16-byte alignment, which the
    wrappers copy, give the bits of aligned ones."""
    g = torch.Generator(device=cuda).manual_seed(11)
    bf = torch.bfloat16
    cache = torch.randn((3, 2, 150, 2, D), generator=g, device=cuda).to(bf)
    k, v = cache[1], cache[2]
    q = torch.randn((2, 70, 8, D), generator=g, device=cuda).to(bf)
    a = kflash.flash_attention_cuda(q, k, v, kv_len=130, q_offset=60)
    b = kflash.flash_attention_cuda(q, k.contiguous(), v.contiguous(),
                                    kv_len=130, q_offset=60)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = ref.flash_attention_ref(q, k, v, kv_len=130, q_offset=60)
    torch.testing.assert_close(a.float(), want.float(), **_tol(bf))
    c = kflash.flash_attention_cuda(_off_by_one(q), _off_by_one(k),
                                    _off_by_one(v), kv_len=130, q_offset=60)
    torch.testing.assert_close(c, b, rtol=0, atol=0)
    # the backward copies misaligned inputs the same way
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    o, lse = kflash.flash_attention_cuda(qc, kc, vc, return_lse=True)
    do = torch.randn(o.shape, generator=g, device=cuda).to(bf)
    want = kflash.flash_attention_bwd_cuda(qc, kc, vc, o, lse, do)
    got = kflash.flash_attention_bwd_cuda(
        *(_off_by_one(t) for t in (qc, kc, vc)), o, lse, _off_by_one(do))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(TypeError):
        krms.rmsnorm_cuda(x.half(), torch.ones(64, device=cuda).half())
    with pytest.raises(ValueError):
        krms.rmsnorm_cuda(x.t(), torch.ones(4, device=cuda))
    q = torch.randn(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kflash.flash_attention_cuda(q, q, q)
    q = torch.randn(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="kv_len"):
        kflash.flash_attention_cuda(q, q, q, kv_len=9)


def test_smoke_serving_kernels_match_plain(cuda):
    cfg = get_smoke_config("yi-6b")
    params = serve.init_params(cfg, 1, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                         device=cuda)
    out = {}
    for name, run in (("kernel", RunConfig()),
                      ("plain", RunConfig(use_kernels=False))):
        cache = engine.init_cache(cfg, 2, 40, cuda)
        lp, cache = registry.prefill(params, cfg, run,
                                     {"tokens": toks[:, :23]}, cache)
        ld, _ = registry.decode(params, cfg, run, toks[:, 23:], cache, 23)
        out[name] = (lp, ld)
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("arch,kv", [
    ("qwen1.5-4b", "int8"), ("qwen1.5-32b", None), ("starcoder2-15b", None),
    ("mixtral-8x7b", None), ("qwen3-moe-235b-a22b", None)])
def test_smoke_dense_and_moe_serving_kernels_match_plain(cuda, arch, kv):
    """A prefill past mixtral-smoke's window of 64, then a decode step,
    through the kernels against the plain versions (qwen1.5-4b with the
    int8 cache of its full config)."""
    cfg = get_smoke_config(arch)
    if kv:
        cfg = cfg.replace(kv_cache_dtype=kv)
    params = serve.init_params(cfg, 1, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 81), generator=g,
                         device=cuda)
    out = {}
    for name, run in (("kernel", RunConfig()),
                      ("plain", RunConfig(use_kernels=False))):
        cache = engine.init_cache(cfg, 2, 96, cuda)
        lp, cache = registry.prefill(params, cfg, run,
                                     {"tokens": toks[:, :80]}, cache)
        ld, _ = registry.decode(params, cfg, run, toks[:, 80:], cache, 80)
        out[name] = (lp, ld)
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("S", [1, 300])
def test_moe_block_is_bit_equal_across_runs(cuda, arch, S):
    """The MoE block at full width (one layer's experts) gives the same
    bits twice: no atomics in the dispatch or the combine."""
    from repro_torch.models import layers

    cfg = get_config(arch).replace(num_layers=1)
    g = torch.Generator(device=cuda).manual_seed(0)
    p = P.layer(P.materialize(layers.moe_defs(cfg, 1), g, cuda), 0)
    x = torch.randn((2, S, cfg.d_model), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    with torch.inference_mode():
        a = layers.moe_block(p, cfg, RunConfig(), x)
        b = layers.moe_block(p, cfg, RunConfig(), x)
    assert a.shape == x.shape and bool(torch.isfinite(a).all())
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_moe_grads_are_bit_equal_across_runs(cuda, arch):
    """Two ``grads_and_metrics`` of an MoE smoke model that drops pairs
    give the same gradient bits: the backward of the combine's gather
    (``index_put_`` with accumulate, atomic on the card) sums only the
    zeros of dropped pairs where its indices collide."""
    from repro_torch.models import layers

    # at half the capacity a token's pairs have, pairs drop in every row
    cfg = get_smoke_config(arch).replace(moe_capacity_factor=0.5)
    params = serve.init_params(cfg, 1, cuda)
    batch = registry.synth_inputs(torch.Generator(device=cuda).manual_seed(
        11), cfg, ShapeConfig("t", 96, 2, "train"), device=cuda)
    with torch.no_grad():
        x = params["embed"]["tok"][batch["tokens"]]
        p0 = {k: v[0] for k, v in params["blocks"]["moe"].items()}
        assert not bool(layers.moe_route(p0, cfg, x).keep.all())
    run = RunConfig(ce_block_v=64)
    ga, ma = tstep.grads_and_metrics(params, cfg, run, batch)
    gb, mb = tstep.grads_and_metrics(params, cfg, run, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        assert bool(torch.isfinite(a).all())
        bits = torch.int16 if a.element_size() == 2 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits))


def _launch_counts():
    return (krms.launches, krms.bwd_launches, kflash.launches,
            kflash.bwd_launches, kce.launches)


def _reset_launches():
    for mod in (krms, kflash, kce):
        mod.launches = 0
    krms.bwd_launches = kflash.bwd_launches = 0


@pytest.mark.parametrize("arch", ["whisper-tiny", "llava-next-mistral-7b"])
def test_smoke_encdec_and_vlm_serving_kernels_match_plain(cuda, arch):
    """A prefill (whisper: its encoder and the cross cache; llava: the
    patches in front of the prompt) and a decode step through the kernels
    against the plain versions, and ``run_serving`` on the card, counted:
    flash in the prefill only; whisper's encoder norms in the prefill
    only."""
    cfg = get_smoke_config(arch)
    params = serve.init_params(cfg, 1, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    inputs = registry.synth_inputs(g, cfg, ShapeConfig("t", 41, 2,
                                                       "prefill"),
                                   device=cuda)
    toks = inputs.pop("tokens")
    extra = cfg.num_img_patches if cfg.family == "vlm" else 0
    out = {}
    for name, run in (("kernel", RunConfig()),
                      ("plain", RunConfig(use_kernels=False))):
        cache = engine.init_cache(cfg, 2, 40 + extra + 8, cuda)
        with torch.inference_mode():
            lp, cache = registry.prefill(params, cfg, run,
                                         dict(inputs, tokens=toks[:, :40]),
                                         cache)
            ld, _ = registry.decode(params, cfg, run, toks[:, 40:], cache,
                                    40 + extra)
        out[name] = (lp, ld)
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, rtol=3e-2, atol=3e-2)
    _reset_launches()
    res = serve.run_serving(arch, smoke=True, prompt_len=40, gen=4,
                            batch=2, device="cuda")
    assert res["generated"] == (2, 4)
    L = cfg.num_layers
    if cfg.family == "encdec":
        Le = cfg.encoder_layers
        want = (2 * Le + 1 + 4 * (3 * L + 1), 0, Le + 2 * L, 0, 0)
    else:
        want = (4 * (2 * L + 1), 0, L, 0, 0)
    assert _launch_counts() == want


# a smoke model's bf16 gradient leaf through the kernels against the bf16
# plain path's distance from f32 (test below)
GRAD_SPREAD_RATIO, GRAD_SPREAD_FLOOR = 2.0, 1e-2


@pytest.mark.parametrize("arch", ["whisper-tiny", "llava-next-mistral-7b"])
def test_smoke_encdec_and_vlm_training_on_card(cuda, arch):
    """Smoke training on the card, synthetic and carousel-fed, launches
    what the code implies and gives finite losses; one step's loss agrees
    with the plain path's (1e-2), and each gradient leaf through the
    kernels lies no further from the f32 plain path's than
    GRAD_SPREAD_RATIO times the bf16 plain path's distance from it (or
    GRAD_SPREAD_FLOOR, where that is smaller), relative L2; whisper's key
    biases, whose gradients are zero but for rounding, over the norm of
    the value bias's.  At this smoke size bf16 rounding alone spreads the
    two bf16 paths: over twelve weight draws whisper's worst leaf lies
    0.042-0.115 from the plain path, and the plain path up to 0.095 from
    f32, so the bf16 plain path is the yardstick, not a fixed bound; the
    largest ratio over those draws was 1.71 (whisper) and 1.24 (llava)
    (``tools/grad_spread_over_draws.py``, PERF.md)."""
    cfg = get_smoke_config(arch)
    L = cfg.num_layers
    if cfg.family == "encdec":
        n, a = 2 * cfg.encoder_layers + 3 * L, cfg.encoder_layers + 2 * L
        want = (2 * n + 2, n + 2, 2 * a, a, 1)
    else:
        want = (4 * L + 1, 2 * L + 1, 2 * L, L, 1)
    for carousel in (False, True):
        _reset_launches()
        res = train.run_training(arch, smoke=True, steps=2, seq_len=48,
                                 global_batch=2, carousel=carousel,
                                 device="cuda")
        assert res["steps"] == 2
        assert all(torch.isfinite(torch.tensor(res["losses"])))
        assert _launch_counts() == tuple(2 * w for w in want)

    params = serve.init_params(cfg, 1, cuda)
    batch = registry.synth_inputs(torch.Generator(device=cuda).manual_seed(
        8), cfg, ShapeConfig("t", 48, 2, "train"), device=cuda)
    run = RunConfig(ce_block_v=64)
    gk, mk = tstep.grads_and_metrics(params, cfg, run, batch)
    gp, mp = tstep.grads_and_metrics(
        params, cfg, run.replace(use_kernels=False), batch)
    gf, _ = tstep.grads_and_metrics(
        P.cast_tree(params, torch.float32), cfg,
        run.replace(use_kernels=False, ce_dtype="float32"), batch)
    torch.testing.assert_close(mk["loss"], mp["loss"], rtol=1e-2, atol=0)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", v

    grads_p, grads_f = dict(leaves(gp)), dict(leaves(gf))
    for name, a in leaves(gk):
        f = grads_f[name].float()
        ref_norm = (grads_f[name[:-2] + "bv"] if name.endswith("/bk")
                    else f).float().norm()
        err_k = float((a.float() - f).norm() / ref_norm)
        err_p = float((grads_p[name].float() - f).norm() / ref_norm)
        assert bool(torch.isfinite(a).all()), name
        assert err_k <= GRAD_SPREAD_RATIO * max(err_p, GRAD_SPREAD_FLOOR), \
            (name, err_k, err_p)


# ---------------------------------------------------------------------------
# Training: backward kernels, the CE kernel, the autograd Functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 384), (1, 513),
                                   (2048, 4096), (20, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w_dtype", DTYPES)
def test_rmsnorm_bwd_kernel_matches_plain(cuda, shape, dtype, w_dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(shape[-1:], generator=g, device=cuda).to(w_dtype)
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    y, inv = krms.rmsnorm_cuda(x, w, 1e-5, return_inv=True)
    y_ref, inv_ref = ref.rmsnorm_fwd_ref(x, w, 1e-5)
    n = krms.bwd_launches
    dx, dw = krms.rmsnorm_bwd_cuda(x, w, inv, dy)
    torch.cuda.synchronize()
    assert krms.bwd_launches == n + 1
    assert dx.dtype == dtype and dw.dtype == w_dtype
    torch.testing.assert_close(inv, inv_ref, rtol=3e-5, atol=3e-5)
    rdx, rdw = ref.rmsnorm_bwd_ref(x, w, inv_ref, dy)
    torch.testing.assert_close(dx.float(), rdx.float(), **_tol(dtype))
    torch.testing.assert_close(dw.float(), rdw.float(),
                               **_tol(torch.bfloat16 if torch.bfloat16 in
                                      (dtype, w_dtype) else dtype))


def _bwd_grid(cuda, D, dtype):
    """The RMSNorm backward's grid (its partial rows) for many rows."""
    from repro_torch.kernels import build
    x = torch.empty((1, D), dtype=dtype, device=cuda).expand(1 << 16, D)
    w = torch.empty((D,), dtype=dtype, device=cuda)
    return build.extension().rmsnorm_bwd_parts(x, w, x, x)


@pytest.mark.parametrize("D", [4096, 2048, 768, 1536, 384, 513])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows_of", ["below", "at", "ragged"])
def test_rmsnorm_bwd_kernel_rows_against_grid(cuda, D, dtype, rows_of):
    """Row counts below, at and not a multiple of the backward's fixed
    grid, at the models' widths and two that take the scalar path or
    leave threads idle: dx and dw against the plain backward."""
    grid = _bwd_grid(cuda, D, dtype)
    assert grid > 0
    rows = {"below": grid // 2 + 1, "at": grid,
            "ragged": 2 * grid + 37}[rows_of]
    g = torch.Generator(device=cuda).manual_seed(12)
    x, dy = (torch.randn((rows, D), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    w = torch.randn((D,), generator=g, device=cuda).to(dtype)
    _, inv = ref.rmsnorm_fwd_ref(x, w, 1e-5)
    n = krms.bwd_launches
    dx, dw = krms.rmsnorm_bwd_cuda(x, w, inv, dy)
    torch.cuda.synchronize()
    assert krms.bwd_launches == n + 1
    rdx, rdw = ref.rmsnorm_bwd_ref(x, w, inv, dy)
    torch.testing.assert_close(dx.float(), rdx.float(), **_tol(dtype))
    torch.testing.assert_close(dw.float(), rdw.float(), **_tol(dtype))


@pytest.mark.parametrize("D", [8192, 16384, 5001])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("misaligned", ["none", "x", "w"])
def test_rmsnorm_bwd_kernel_any_width_and_alignment(cuda, D, dtype,
                                                    misaligned):
    """Widths past the vector path's registers (8192 in f32, 16384), one
    with no 16-byte vectors (5001) and contiguous x and g, or w, one
    element off alignment all launch (the scalar path where the vector
    one does not fit) and agree with the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x, dy = (torch.randn((300, D), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    w = torch.randn((D,), generator=g, device=cuda).to(dtype)
    _, inv = ref.rmsnorm_fwd_ref(x, w, 1e-5)
    rdx, rdw = ref.rmsnorm_bwd_ref(x, w, inv, dy)
    if misaligned == "x":
        x, dy = _off_by_one(x), _off_by_one(dy)
    elif misaligned == "w":
        w = _off_by_one(w)
    n = krms.bwd_launches
    dx, dw = krms.rmsnorm_bwd_cuda(x, w, inv, dy)
    torch.cuda.synchronize()
    assert krms.bwd_launches == n + 1
    torch.testing.assert_close(dx.float(), rdx.float(), **_tol(dtype))
    torch.testing.assert_close(dw.float(), rdw.float(), **_tol(dtype))


RMS_FWD_WIDTHS = [384, 513, 768, 1536, 2048, 4096, 8192, 16384]


def _fwd_plan(cuda, D, dtype, w_dtype=None):
    """(threads a row, rows a block takes at once, grid) of the forward
    for aligned (rows, D) operands, with rows enough to fill the grid."""
    from repro_torch.kernels import build
    x = torch.empty((1 << 16, D), dtype=dtype, device=cuda)
    w = torch.empty((D,), dtype=w_dtype or dtype, device=cuda)
    return build.extension().rmsnorm_fwd_plan(x, w, x)


@pytest.mark.parametrize("D", RMS_FWD_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w_dtype", DTYPES)
@pytest.mark.parametrize("rows_of", ["below", "at", "ragged"])
def test_rmsnorm_fwd_kernel_rows_against_grid(cuda, D, dtype, w_dtype,
                                              rows_of):
    """Row counts below, at and not a multiple of the forward's fixed
    grid (times the rows a block takes at once), at the models' widths
    and at widths that leave lanes idle (384), take the scalar path (513,
    16384; 8192 in f32): y and inv against the plain forward."""
    _, group, grid = _fwd_plan(cuda, D, dtype, w_dtype)
    assert grid > 0 and group > 0
    rows = {"below": grid * group // 2 + 1, "at": grid * group,
            "ragged": 2 * grid * group + 37}[rows_of]
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn((rows, D), generator=g, device=cuda).to(dtype)
    w = torch.randn((D,), generator=g, device=cuda).to(w_dtype)
    n = krms.launches
    y, inv = krms.rmsnorm_cuda(x, w, 1e-5, return_inv=True)
    torch.cuda.synchronize()
    assert krms.launches == n + 1 and y.dtype == dtype
    ry, rinv = ref.rmsnorm_fwd_ref(x, w, 1e-5)
    torch.testing.assert_close(y.float(), ry.float(), **_tol(dtype))
    torch.testing.assert_close(inv, rinv, rtol=3e-5, atol=3e-5)


def test_rmsnorm_fwd_splits_rows_evenly(cuda):
    """The vector path's threads a row at the models' widths: D = 768 in
    bf16 is 96 vectors, 3 a lane of one warp (8 rows a block); 1536,
    2048, 4096 and 8192 fill 64, 64, 128 and 256 threads."""
    bf = torch.bfloat16
    for D, T in ((768, 32), (1536, 64), (2048, 64), (4096, 128),
                 (8192, 256)):
        assert _fwd_plan(cuda, D, bf)[0] == T, D
    assert _fwd_plan(cuda, 768, bf)[1] == 8


@pytest.mark.parametrize("D", [768, 1536, 2048, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 4, 77])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_fwd_kernel_few_rows(cuda, D, rows, dtype):
    """Fewer rows than SMs (decode): the same threads a row and rows a
    block as a full batch, so the rows come out with the bits they have
    inside a call of 8192 rows; y and inv against the plain forward."""
    from repro_torch.kernels import build
    g = torch.Generator(device=cuda).manual_seed(16)
    big = torch.randn((8192, D), generator=g, device=cuda).to(dtype)
    x = big[:rows].clone()
    w = torch.randn((D,), generator=g, device=cuda).to(dtype)
    plan = build.extension().rmsnorm_fwd_plan
    assert plan(x, w, x)[:2] == plan(big, w, big)[:2]
    y, inv = krms.rmsnorm_cuda(x, w, 1e-5, return_inv=True)
    y_big, inv_big = krms.rmsnorm_cuda(big, w, 1e-5, return_inv=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y_big[:rows]) and torch.equal(inv, inv_big[:rows])
    ry, rinv = ref.rmsnorm_fwd_ref(x, w, 1e-5)
    torch.testing.assert_close(y.float(), ry.float(), **_tol(dtype))
    torch.testing.assert_close(inv, rinv, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("D", [768, 4096, 5001])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("misaligned", ["x", "y", "w"])
def test_rmsnorm_fwd_kernel_takes_misaligned_operands(cuda, D, dtype,
                                                      misaligned):
    """x, y or w one element off a 16-byte aligned address: the forward
    takes its scalar path and agrees with the plain forward."""
    from repro_torch.kernels import build
    g = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn((300, D), generator=g, device=cuda).to(dtype)
    w = torch.randn((D,), generator=g, device=cuda).to(dtype)
    ry, rinv = ref.rmsnorm_fwd_ref(x, w, 1e-5)
    y = torch.empty_like(x)
    if misaligned == "x":
        x = _off_by_one(x)
    elif misaligned == "w":
        w = _off_by_one(w)
    else:
        y = _off_by_one(y)
    inv = torch.empty((300,), device=cuda)
    build.extension().rmsnorm_fwd(x, w, y, 1e-5, inv)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), ry.float(), **_tol(dtype))
    torch.testing.assert_close(inv, rinv, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_lse_and_bwd_kernels_match_plain(cuda, case, dtype):
    B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len = case
    g = torch.Generator(device=cuda).manual_seed(5)
    q, do = (torch.randn((B, Sq, Hq, D), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, sliding_window=window, q_offset=q_off,
              kv_len=kv_len)
    o, lse = kflash.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    o_ref, lse_ref = ref.flash_attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_ref, rtol=3e-5, atol=3e-5)
    n = kflash.bwd_launches
    got = kflash.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert kflash.bwd_launches == n + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == dtype, name
        torch.testing.assert_close(a.float(), b.float(), msg=name,
                                   **_tol(dtype))


# (128 tokens x 256 vocab tiles, 64 deep, in bf16): ragged T, V and D,
# and a D that is no multiple of 8 (the wrapper pads it)
@pytest.mark.parametrize("T,D,V", [(37, 48, 1000), (256, 64, 4099),
                                   (300, 128, 513), (2048, 4096, 64000),
                                   (300, 136, 4099), (129, 64, 64000),
                                   (70, 4099, 300)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ce_kernel_matches_plain(cuda, T, D, V, dtype):
    g = torch.Generator(device=cuda).manual_seed(6)
    h = torch.randn((T, D), generator=g, device=cuda).to(dtype)
    w = (torch.randn((V, D), generator=g, device=cuda) * D ** -0.5).to(dtype)
    t = torch.randint(0, V, (T,), generator=g, device=cuda)
    n = kce.launches
    nll, lse = kce.cross_entropy_cuda(h, w, t)
    torch.cuda.synchronize()
    assert kce.launches == n + 1
    rnll, rlse = ref.cross_entropy_stats_ref(h, w, t, block_v=8192)
    tol = dict(rtol=3e-5, atol=3e-5) if dtype == torch.float32 else _tol(
        dtype)
    torch.testing.assert_close(nll, rnll, **tol)
    torch.testing.assert_close(lse, rlse, **tol)


@pytest.mark.parametrize("T,D,V", [(300, 128, 4000), (129, 64, 64000),
                                   (37, 48, 1000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ce_kernel_on_vocab_shards_merges_to_the_whole(cuda, T, D, V, dtype):
    """The CE kernel on 4 vocab shards (targets shifted by each shard's
    first id: a target in another shard adds nothing), the shards'
    (m, l, target logit) triples merged by ``ce_merge_kernel``, against
    the whole-vocab kernel and the plain version; targets on the shard
    boundaries included."""
    g = torch.Generator(device=cuda).manual_seed(7)
    h = torch.randn((T, D), generator=g, device=cuda).to(dtype)
    w = (torch.randn((V, D), generator=g, device=cuda) * D ** -0.5).to(dtype)
    t = torch.randint(0, V, (T,), generator=g, device=cuda)
    vs = V // 4
    t[:4] = torch.tensor([0, vs - 1, vs, V - 1])
    n, m = kce.launches, kce.merge_launches
    parts = torch.stack([kce.cross_entropy_stats_cuda(
        h, w[i * vs:(i + 1) * vs].contiguous(), t - i * vs)
        for i in range(4)])
    nll, lse = kce.ce_merge_cuda(parts)
    torch.cuda.synchronize()
    assert (kce.launches, kce.merge_launches) == (n + 4, m + 1)
    assert int((parts[:, :, 2] != 0).sum(0).max()) == 1
    tol = dict(rtol=3e-5, atol=3e-5) if dtype == torch.float32 else _tol(
        dtype)
    for want in (kce.cross_entropy_cuda(h, w, t),
                 ref.cross_entropy_stats_ref(h, w, t, block_v=8192)):
        torch.testing.assert_close(nll, want[0], **tol)
        torch.testing.assert_close(lse, want[1], **tol)
    plain = torch.stack([ref.cross_entropy_partial_ref(
        h, w[i * vs:(i + 1) * vs], t - i * vs) for i in range(4)])
    torch.testing.assert_close(parts, plain, **tol)


def test_tensor_core_kernels_are_deterministic(cuda):
    """No atomics: two calls of the bf16 flash backward (G = 8, dk and dv
    summed over a cluster), of the bf16 CE forward, of the bf16 flash
    forward, of the RMSNorm backward (dw summed over partial rows) and
    forward, of the bf16 SSD scan, and of the bf16 SSD backward at a group
    of 64 heads (dB and dC summed over them) give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(9)
    bf = torch.bfloat16
    q, do = (torch.randn((2, 200, 16, 128), generator=g, device=cuda).to(bf)
             for _ in range(2))
    k, v = (torch.randn((2, 200, 2, 128), generator=g, device=cuda).to(bf)
            for _ in range(2))
    o, lse = kflash.flash_attention_cuda(q, k, v, return_lse=True)
    a = kflash.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    b = kflash.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    h = torch.randn((300, 512), generator=g, device=cuda).to(bf)
    w = (torch.randn((5000, 512), generator=g, device=cuda) * 0.05).to(bf)
    t = torch.randint(0, 5000, (300,), generator=g, device=cuda)
    for x, y in zip(kce.cross_entropy_cuda(h, w, t),
                    kce.cross_entropy_cuda(h, w, t)):
        assert torch.equal(x, y)
    o2, lse2 = kflash.flash_attention_cuda(q, k, v, return_lse=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    # the RMSNorm backward's dw: partial rows summed in a fixed order
    x, dy = (torch.randn((3000, 4096), generator=g, device=cuda).to(bf)
             for _ in range(2))
    w = torch.randn((4096,), generator=g, device=cuda).to(bf)
    _, inv = krms.rmsnorm_cuda(x, w, 1e-5, return_inv=True)
    for a, b in zip(krms.rmsnorm_bwd_cuda(x, w, inv, dy),
                    krms.rmsnorm_bwd_cuda(x, w, inv, dy)):
        assert torch.equal(a, b)
    # the RMSNorm forward: rows spanning warps (4096) and a warp a row
    # (768)
    for D in (4096, 768):
        xr = torch.randn((3000, D), generator=g, device=cuda).to(bf)
        wr = torch.randn((D,), generator=g, device=cuda).to(bf)
        for a, b in zip(krms.rmsnorm_cuda(xr, wr, 1e-5, return_inv=True),
                        krms.rmsnorm_cuda(xr, wr, 1e-5, return_inv=True)):
            assert torch.equal(a, b)
    # the bf16 SSD scan (tensor cores), with an initial state
    xs, dt, A, Bm, Cm, h0 = _ssd_inputs((2, 300, 8, 64, 1, 128, 128), bf,
                                        cuda, seed=9, state=True)
    for a, b in zip(kssd.ssd_cuda(xs, dt, A, Bm, Cm, init_state=h0,
                                  return_state=True),
                    kssd.ssd_cuda(xs, dt, A, Bm, Cm, init_state=h0,
                                  return_state=True)):
        assert torch.equal(a, b)
    # the bf16 SSD backward, 64 heads a group (zamba2-1.2b's H / G), with
    # an initial state and a final-state cotangent
    xs, dt, A, Bm, Cm, h0 = _ssd_inputs((1, 300, 64, 64, 1, 64, 128), bf,
                                        cuda, seed=10, state=True)
    dy = torch.randn(xs.shape, generator=g, device=cuda).to(bf)
    dh = torch.randn(h0.shape, generator=g, device=cuda) * 0.1
    kw = dict(init_state=h0, d_state=dh)
    for a, b in zip(kssd.ssd_bwd_cuda(xs, dt, A, Bm, Cm, dy, **kw),
                    kssd.ssd_bwd_cuda(xs, dt, A, Bm, Cm, dy, **kw)):
        assert torch.equal(a, b)


def test_tensor_core_kernels_fit_without_spills(cuda):
    """Every redesigned kernel (tensor-core flash forward and backward, CE
    forward, RMSNorm backward and forward, tensor-core SSD scan and SSD
    backward) and the f32 SSD backward's kernels keep their state in
    registers (no local memory) and fit at least one block a SM at their
    launch size."""
    from repro_torch.kernels import build
    rows = build.extension().kernel_info()
    names = [name for name, _ in rows]
    assert "ce_fwd_wgmma_kernel" in names
    assert "flash_bwd_dkdv_tc_kernel<128>" in names
    for D in (16, 32, 64, 128):
        assert f"flash_fwd_tc_kernel<{D}>" in names
    for name in ("rmsnorm_bwd_kernel<bf16,2>", "rmsnorm_bwd_kernel<f32,4>",
                 "rmsnorm_bwd_any_kernel<bf16>",
                 "rmsnorm_bwd_any_kernel<f32>",
                 "rmsnorm_dw_kernel<bf16>", "rmsnorm_dw_kernel<f32>"):
        assert name in names
    for p in ("bf16", "f32"):
        for g in ("bf16", "f32"):
            for mv in ("bf16", "f32"):
                assert f"adamw_update_kernel<{p},{g},{mv}>" in names
        assert f"adamw_norm_kernel<{p}>" in names
    assert "adamw_norm_final_kernel" in names
    for dtype in ("bf16", "f32"):
        assert f"rmsnorm_fwd_any_kernel<{dtype}>" in names
        for nv in (1, 2, 3, 4):
            assert f"rmsnorm_fwd_kernel<{dtype},{nv}>" in names
    for n in (32, 64, 128):
        assert f"ssd_scan_tc_kernel<{n}>" in names
    # the f32 SSD backward
    assert "ssd_bwd_chunk_kernel<f32>" in names
    for way in ("fwd", "rev"):
        for nj in (2, 4):
            assert f"ssd_state_pass_kernel<f32,{way},{nj}>" in names
    for dtype in ("bf16", "f32"):
        assert f"ssd_bwd_reduce_kernel<{dtype}>" in names
    # the bf16 SSD backward at each padding of N
    for n in (32, 64, 128):
        for name in (f"ssd_bwd_state_tc_kernel<{n},fwd>",
                     f"ssd_bwd_state_tc_kernel<{n},rev>",
                     f"ssd_bwd_row_tc_kernel<{n}>",
                     f"ssd_bwd_col_tc_kernel<{n}>"):
            assert name in names
    info = dict(rows)
    # the SSD scan's design point at zamba2-1.2b's shape: two blocks a SM
    assert info["ssd_scan_tc_kernel<64>"][5] >= 2
    # the bf16 SSD backward's: at zamba2-1.2b's N 64 two blocks a SM of
    # every kernel (the state passes' 256 blocks fill the card twice); at
    # mamba2-130m's N 128 the chunk kernels' tiles take 138 KB of shared
    # memory, one block a SM (and the state passes' 96 blocks take one SM
    # each)
    for name in ("state_tc_kernel<64,fwd>", "state_tc_kernel<64,rev>",
                 "row_tc_kernel<64>", "col_tc_kernel<64>"):
        assert info[f"ssd_bwd_{name}"][5] >= 2, name
    for name in ("row", "col"):
        assert info[f"ssd_bwd_{name}_tc_kernel<128>"][3] > 113 * 1024
    # the flash forward's design point: two blocks of 4 warps a SM
    assert dict(rows)["flash_fwd_tc_kernel<128>"][5] >= 2
    for name, (regs, local, _, _, _, blocks) in rows:
        assert local == 0, name
        assert 0 < regs <= 255 and blocks >= 1, name


@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_functions_match_plain(cuda, dtype):
    """ops.rmsnorm, ops.flash_attention and ce_blockwise with inputs that
    require grad: the kernel Functions against the plain Functions."""
    g = torch.Generator(device=cuda).manual_seed(7)

    def both(fn, *shapes):
        xs = [torch.randn(s, generator=g, device=cuda).to(dtype)
              for s in shapes]
        out = []
        for use in (None, False):
            leaves = [x.clone().requires_grad_() for x in xs]
            y = fn(use, *leaves)
            y.backward(torch.ones_like(y))
            out.append([y] + [x.grad for x in leaves])
        for a, b in zip(*out):
            torch.testing.assert_close(a.float(), b.float(), **_tol(dtype))

    both(lambda u, x, w: ops.rmsnorm(x, w, eps=1e-5, use_kernels=u),
         (4, 33, 256), (256,))
    both(lambda u, q, k, v: ops.flash_attention(q, k, v, use_kernels=u),
         (2, 96, 8, 64), (2, 96, 2, 64), (2, 96, 2, 64))
    t = torch.randint(0, 700, (96,), generator=g, device=cuda)
    both(lambda u, h, w: tloss.ce_blockwise(h, w * 0.1, t, None, 256,
                                            torch.bfloat16, use_kernels=u),
         (96, 64), (700, 64))


def test_smoke_training_on_card(cuda):
    """Smoke training on the card runs every kernel, gives finite losses,
    and one step's gradients agree with the plain path's."""
    for mod in (krms, kflash, kce):
        mod.launches = 0
    krms.bwd_launches = kflash.bwd_launches = 0
    res = train.run_training("yi-6b", smoke=True, steps=3, seq_len=64,
                             global_batch=2, carousel=False, device="cuda")
    assert res["steps"] == 3
    assert all(torch.isfinite(torch.tensor(res["losses"])))
    L = get_smoke_config("yi-6b").num_layers
    assert (krms.launches, krms.bwd_launches) == (3 * (4 * L + 1),
                                                  3 * (2 * L + 1))
    assert (kflash.launches, kflash.bwd_launches) == (3 * 2 * L, 3 * L)
    assert kce.launches == 3

    cfg = get_smoke_config("yi-6b")
    params = serve.init_params(cfg, 1, cuda)
    batch = registry.synth_inputs(torch.Generator(device=cuda).manual_seed(
        8), cfg, ShapeConfig("t", 64, 2, "train"), device=cuda)
    gk, mk = tstep.grads_and_metrics(params, cfg, RunConfig(ce_block_v=64),
                                     batch)
    gp, mp = tstep.grads_and_metrics(
        params, cfg, RunConfig(ce_block_v=64, use_kernels=False), batch)
    torch.testing.assert_close(mk["loss"], mp["loss"], rtol=1e-2, atol=0)
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert float((a.float() - b.float()).norm()
                     / b.float().norm()) <= 5e-2


def test_smoke_carousel_training_and_remat_dots_on_card(cuda):
    """Carousel-fed smoke training on the card launches the kernels as
    synthetic batches do; remat "dots" launches them as "full" does and
    gives its gradients."""
    def reset():
        for mod in (krms, kflash, kce):
            mod.launches = 0
        krms.bwd_launches = kflash.bwd_launches = 0

    def counts():
        return (krms.launches, krms.bwd_launches, kflash.launches,
                kflash.bwd_launches, kce.launches)

    cfg = get_smoke_config("yi-6b")
    L = cfg.num_layers
    reset()
    res = train.run_training("yi-6b", smoke=True, steps=3, seq_len=64,
                             global_batch=2, device="cuda")
    assert res["steps"] == 3 and res["carousel"]["rows_delivered"] >= 6
    assert all(torch.isfinite(torch.tensor(res["losses"])))
    assert counts() == (3 * (4 * L + 1), 3 * (2 * L + 1), 3 * 2 * L, 3 * L,
                        3)

    params = serve.init_params(cfg, 1, cuda)
    batch = registry.synth_inputs(torch.Generator(device=cuda).manual_seed(
        9), cfg, ShapeConfig("t", 64, 2, "train"), device=cuda)
    out = {}
    for remat in ("full", "dots"):
        reset()
        out[remat] = tstep.grads_and_metrics(
            params, cfg, RunConfig(ce_block_v=64, remat=remat), batch)
        out[remat + "_launches"] = counts()
    assert out["dots_launches"] == out["full_launches"] == (
        4 * L + 1, 2 * L + 1, 2 * L, L, 1)
    (gd, md), (gf, mf) = out["dots"], out["full"]
    torch.testing.assert_close(md["loss"], mf["loss"], rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(gd), tree_leaves(gf)):
        assert float((a.float() - b.float()).norm()
                     / b.float().norm()) <= 1e-6


def test_device_put_pinned_copies_survive_queued_work(cuda):
    """``device_put`` copies from pinned staging buffers with
    ``non_blocking``; with the copies queued behind device work, the host
    drops each buffer and pins the next batch at once: none of the
    buffers may be reused before its copy has run."""
    x = torch.randn((4096, 4096), device=cuda)
    for _ in range(30):  # tens of ms of queued work ahead of the copies
        x = torch.tanh(x @ x)
    got = [device_put({"t": np.full((256, 1024), i, np.int32),
                       "m": np.full((256,), i, np.float32)}, cuda)
           for i in range(64)]
    torch.cuda.synchronize()
    for i, b in enumerate(got):
        assert b["t"].dtype == torch.int32 and b["m"].dtype == torch.float32
        assert bool((b["t"] == i).all()) and bool((b["m"] == i).all()), i


def test_async_save_of_cuda_tensors_updated_in_place(cuda, tmp_path):
    """The train step updates the state in place right after a save: the
    checkpoint holds the leaves as they were at the save, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"p": torch.randn((4096, 4096), generator=g,
                             device=cuda).bfloat16(),
            "m": torch.randn((4096, 4096), generator=g, device=cuda),
            "step": 7}
    want = {k: v.cpu() for k, v in tree.items() if k != "step"}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(tree, 7)
    # queued right behind the copy, as the next train step's update is
    tree["p"].add_(1.0)
    tree["m"].mul_(-3.0)
    ck.close()
    got, meta = load_checkpoint(str(tmp_path), device=cuda)
    assert meta["step"] == 7 and int(got["step"]) == 7
    for k, v in want.items():
        assert got[k].is_cuda and torch.equal(got[k].cpu(), v), k


# ---------------------------------------------------------------------------
# Mamba2 / Zamba2 serving: the SSD scan kernel
# ---------------------------------------------------------------------------

SSD_CASES = [
    # B, S, H, P, G, N, chunk: the SSD_CASES of tests/test_kernels.py,
    # then S < chunk, and the smoke configs' P = N = 16
    (2, 96, 4, 16, 1, 32, 32),
    (1, 130, 6, 32, 2, 16, 64),
    (2, 64, 2, 64, 1, 128, 32),
    (2, 50, 4, 64, 1, 64, 128),
    (2, 77, 8, 16, 1, 16, 32),
]


def _ssd_tol(dtype):
    t = 3e-2 if dtype == torch.bfloat16 else 3e-4
    return dict(rtol=t, atol=t)


def _ssd_inputs(case, dtype, device, seed=0, state=False):
    B, S, H, P, G, N, _ = case
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = (rn(B, S, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -torch.exp(rn(H) * 0.3)
    Bm = (rn(B, S, G, N) * 0.3).to(dtype)
    Cm = (rn(B, S, G, N) * 0.3).to(dtype)
    h0 = rn(B, H, P, N) * 0.1 if state else None
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("state", [False, True])
def test_ssd_kernel_matches_plain(cuda, case, dtype, state):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(case, dtype, cuda, state=state)
    chunk = case[-1]
    n = kssd.launches
    y, h = ops.ssd(x, dt, A, Bm, Cm, chunk=chunk, init_state=h0,
                   return_state=True)
    torch.cuda.synchronize()
    assert kssd.launches == n + 1 and y.dtype == dtype
    ry, rh = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, init_state=h0,
                         return_state=True)
    torch.testing.assert_close(y.float(), ry.float(), **_ssd_tol(dtype))
    torch.testing.assert_close(h, rh, **_ssd_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_state_chain_and_strided_views(cuda, dtype):
    """Two calls chained through the state equal one call over the whole
    sequence; x as a view of (B, S, H * P) and B/C as slices of a wider
    tensor give the same answer as contiguous copies."""
    B, S, H, P, N, Q = 2, 200, 4, 32, 64, 64
    g = torch.Generator(device=cuda).manual_seed(4)
    xs = (torch.randn((B, S, H * P + 8), generator=g, device=cuda)
          * 0.5).to(dtype)
    bc = (torch.randn((B, S, 2 * N), generator=g, device=cuda)
          * 0.3).to(dtype)
    x = xs[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = bc[..., :N].unsqueeze(2), bc[..., N:].unsqueeze(2)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * 0.3)
    y, h = kssd.ssd_cuda(x, dt, A, Bm, Cm, chunk=Q, return_state=True)
    yc, hc = kssd.ssd_cuda(x.contiguous(), dt, A, Bm.contiguous(),
                           Cm.contiguous(), chunk=Q, return_state=True)
    torch.testing.assert_close(y, yc, rtol=0, atol=0)
    torch.testing.assert_close(h, hc, rtol=0, atol=0)
    cut = 137
    y1, h1 = kssd.ssd_cuda(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                           Cm[:, :cut], chunk=Q, return_state=True)
    y2, h2 = kssd.ssd_cuda(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                           Cm[:, cut:], chunk=Q, init_state=h1,
                           return_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], 1).float(), y.float(),
                               **_ssd_tol(dtype))
    torch.testing.assert_close(h2, h, **_ssd_tol(dtype))


def test_ssd_kernel_rejects_bad_inputs_and_gradients(cuda):
    x, dt, A, Bm, Cm, _ = _ssd_inputs((1, 8, 2, 16, 1, 16, 8),
                                      torch.float32, cuda)
    with pytest.raises(TypeError):
        kssd.ssd_cuda(x, dt.to(torch.bfloat16), A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        kssd.ssd_cuda(x, dt, A, Bm, Cm, chunk=256)
    with pytest.raises(ValueError, match="last axis"):
        kssd.ssd_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                      A, Bm, Cm, chunk=8)
    # with a gradient the kernel path runs SSDFn: the forward kernel, then
    # the backward kernels (no plain fallback)
    n = (kssd.launches, kssd.bwd_launches)
    xg = x.clone().requires_grad_()
    y = ops.ssd(xg, dt, A, Bm, Cm, chunk=8)
    assert type(y.grad_fn).__name__ == "SSDFnBackward"
    y.sum().backward()
    torch.cuda.synchronize()
    assert (kssd.launches, kssd.bwd_launches) == (n[0] + 1, n[1] + 1)
    want = ref.ssd_bwd_ref(x, dt, A, Bm, Cm, torch.ones_like(x), chunk=8)[0]
    torch.testing.assert_close(xg.grad, want, **_ssd_tol(torch.float32))
    with pytest.raises(ValueError, match="dy"):
        kssd.ssd_bwd_cuda(x, dt, A, Bm, Cm, torch.ones_like(x)[:, :4],
                          chunk=8)


def _ssd_bwd_check(got, want, dtype):
    """dx, ddt, dB, dC, d_init elementwise; dA, a sum over B * S terms,
    at relative L2 (chip_smoke.py's phase "ssd_bwd")."""
    t = _ssd_tol(dtype)["rtol"]
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "d_init"), got,
                          want):
        if name == "dA":
            rel = float((a - b).norm() / b.norm())
            assert rel <= t, (name, rel)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            torch.testing.assert_close(a.float(), b.float(), rtol=t, atol=t,
                                       msg=name)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("d_state", [False, True])
def test_ssd_bwd_kernel_matches_plain(cuda, case, dtype, state, d_state):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(case, dtype, cuda, seed=5,
                                       state=state)
    B, S, H, P, _, N, chunk = case
    g = torch.Generator(device=cuda).manual_seed(6)
    dy = torch.randn(x.shape, generator=g, device=cuda).to(dtype)
    dh = (torch.randn((B, H, P, N), generator=g, device=cuda) * 0.1
          if d_state else None)
    n = kssd.bwd_launches
    got = kssd.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=chunk,
                            init_state=h0, d_state=dh)
    torch.cuda.synchronize()
    assert kssd.bwd_launches == n + 1
    want = ref.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, chunk=chunk, init_state=h0,
                           d_state=dh)
    _ssd_bwd_check(got, want, dtype)


@pytest.mark.parametrize("P", [4, 12, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernels_take_a_rank_block_of_the_head_dim(cuda, P, dtype):
    """A rank's block of the SSD head dim under a "model" split (mamba2 at
    16 ranks: P 4), forward and backward: a P that is no multiple of 8 is
    zero-padded by the wrapper and the results cut back, against the plain
    versions; x as the model's view of its contiguous (B, S, H * P) conv
    output reaches the bf16 kernel without a copy where P is a multiple
    of 8."""
    case = (2, 96, 3, P, 1, 32, 32)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(case, dtype, cuda, seed=7,
                                       state=True)
    g = torch.Generator(device=cuda).manual_seed(8)
    dy = torch.randn(x.shape, generator=g, device=cuda).to(dtype)
    dh = torch.randn(h0.shape, generator=g, device=cuda) * 0.1
    n = (kssd.launches, kssd.bwd_launches)
    y, h = kssd.ssd_cuda(x, dt, A, Bm, Cm, chunk=32, init_state=h0,
                         return_state=True)
    got = kssd.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=32, init_state=h0,
                            d_state=dh)
    torch.cuda.synchronize()
    assert (kssd.launches, kssd.bwd_launches) == (n[0] + 1, n[1] + 1)
    assert y.shape == x.shape and h.shape == h0.shape
    ry, rh = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=32, init_state=h0,
                         return_state=True)
    torch.testing.assert_close(y.float(), ry.float(), **_ssd_tol(dtype))
    torch.testing.assert_close(h, rh, **_ssd_tol(dtype))
    _ssd_bwd_check(got, ref.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, chunk=32,
                                        init_state=h0, d_state=dh), dtype)
    view = x.reshape(2, 96, 3 * P).contiguous().view(2, 96, 3, P)
    from repro_torch.kernels.flash_attention import _chunk_aligned
    assert (_chunk_aligned(view) is view) == (P % 8 == 0
                                              or dtype == torch.float32)


@pytest.mark.parametrize("D", [384, 1024, 100])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w_dtype", DTYPES)
def test_rmsnorm_split_rows_match_plain_and_the_whole_row(cuda, D, dtype,
                                                          w_dtype):
    """The gated norm's row split over 4 ranks (D columns a rank; 100 takes
    the scalar paths): each shard's statistic launch, the statistics
    summed, then its rows' launch, forward and backward, against the plain
    twins on the same shards and the whole-row kernels on the gathered
    row; with one shard, bit for bit the whole-row kernels (forward,
    backward, and ``ops.rmsnorm_split`` with its autograd against
    ``ops.rmsnorm``)."""
    n, rows, eps = 4, 77, 1e-5
    g = torch.Generator(device=cuda).manual_seed(9)
    x, gy = (torch.randn((rows, n * D), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    w = (1 + 0.1 * torch.randn((n * D,), generator=g, device=cuda)
         ).to(w_dtype)
    cols = [slice(i * D, (i + 1) * D) for i in range(n)]
    xs, gs = ([t[:, c].contiguous() for c in cols] for t in (x, gy))
    ws = [w[c].contiguous() for c in cols]
    launches = (krms.split_launches, krms.split_bwd_launches)
    stat = sum(krms.rmsnorm_stat_cuda(a, b) for a, b in zip(xs, ws))
    fwd = [krms.rmsnorm_split_cuda(a, b, stat, n * D, eps)
           for a, b in zip(xs, ws)]
    bstat = sum(krms.rmsnorm_bwd_stat_cuda(a, b, f[1], c)
                for a, b, c, f in zip(xs, ws, gs, fwd))
    bwd = [krms.rmsnorm_split_bwd_cuda(a, b, f[1], c, bstat, n * D)
           for a, b, c, f in zip(xs, ws, gs, fwd)]
    torch.cuda.synchronize()
    assert (krms.split_launches, krms.split_bwd_launches) == (
        launches[0] + 2 * n, launches[1] + 2 * n)
    pstat = sum(ref.rmsnorm_stat_ref(a) for a in xs)
    pfwd = [ref.rmsnorm_split_fwd_ref(a, b, pstat, n * D, eps)
            for a, b in zip(xs, ws)]
    pbstat = sum(ref.rmsnorm_bwd_stat_ref(a, b, f[1], c)
                 for a, b, c, f in zip(xs, ws, gs, pfwd))
    pbwd = [ref.rmsnorm_split_bwd_ref(a, b, f[1], c, pbstat, n * D)
            for a, b, c, f in zip(xs, ws, gs, pfwd)]
    y_w, inv_w = krms.rmsnorm_cuda(x, w, eps, return_inv=True)
    dx_w, dw_w = krms.rmsnorm_bwd_cuda(x, w, inv_w, gy)
    got = (torch.cat([f[0] for f in fwd], 1), fwd[0][1],
           torch.cat([b[0] for b in bwd], 1), torch.cat([b[1] for b in bwd]))
    plain = (torch.cat([f[0] for f in pfwd], 1), pfwd[0][1],
             torch.cat([b[0] for b in pbwd], 1),
             torch.cat([b[1] for b in pbwd]))
    for a, b, c in zip(got, plain, (y_w, inv_w, dx_w, dw_w)):
        tol = _tol(a.dtype)
        torch.testing.assert_close(a.float(), b.float(), **tol)
        torch.testing.assert_close(a.float(), c.float(), **tol)
    # one shard: the whole-row kernels' bits
    s1 = krms.rmsnorm_stat_cuda(x, w)
    y1, inv1 = krms.rmsnorm_split_cuda(x, w, s1, n * D, eps)
    dx1, dw1 = krms.rmsnorm_split_bwd_cuda(
        x, w, inv1, gy, krms.rmsnorm_bwd_stat_cuda(x, w, inv1, gy), n * D)
    for a, b in zip((y1, inv1, dx1, dw1), (y_w, inv_w, dx_w, dw_w)):
        assert torch.equal(a, b)
    xa, wa, xb, wb = (t.clone().requires_grad_() for t in (x, w, x, w))
    ya = ops.rmsnorm_split(xa, wa, d_whole=n * D, reduce=lambda t: t,
                           eps=eps)
    yb = ops.rmsnorm(xb, wb, eps=eps)
    ya.backward(gy)
    yb.backward(gy)
    assert torch.equal(ya, yb) and torch.equal(xa.grad, xb.grad) \
        and torch.equal(wa.grad, wb.grad)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_bwd_kernel_reads_views_and_is_deterministic(cuda, dtype):
    """x as the model's view of (B, S, H * P) and B/C as slices of one
    (B, S, 2N + 1) tensor (B one element off a 16-byte boundary) give the
    bits of contiguous copies; two calls give the same bits; and SSDFn
    through ``ops.ssd`` gives every gradient of the kernels."""
    B, S, H, P, N, Q = 2, 300, 4, 64, 64, 128
    g = torch.Generator(device=cuda).manual_seed(9)
    xs = (torch.randn((B, S, H * P + 8), generator=g, device=cuda)
          * 0.5).to(dtype)
    bc = (torch.randn((B, S, 2 * N + 1), generator=g, device=cuda)
          * 0.3).to(dtype)
    x = xs[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = bc[..., 1:N + 1].unsqueeze(2), bc[..., N + 1:].unsqueeze(2)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * 0.3)
    dy = torch.randn((B, S, H, P), generator=g, device=cuda).to(dtype)
    got = kssd.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=Q)
    again = kssd.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, chunk=Q)
    flat = kssd.ssd_bwd_cuda(x.contiguous(), dt, A, Bm.contiguous(),
                             Cm.contiguous(), dy, chunk=Q)
    for a, b, c in zip(got, again, flat):
        assert torch.equal(a, b) and torch.equal(a, c)
    _ssd_bwd_check(got, ref.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, chunk=Q),
                   dtype)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm,
                                                            Cm)]
    y = ops.ssd(*leaves, chunk=Q)
    y.backward(dy)
    for leaf, a in zip(leaves, got[:5]):
        assert torch.equal(leaf.grad, a)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_smoke_ssm_training_kernels_match_plain(cuda, arch):
    """One smoke-config ``grads_and_metrics`` over two chunks and a ragged
    tail through the kernels against the plain path: the loss within
    1e-2, every gradient leaf within relative L2 5e-2; the SSD scan runs
    twice a layer (remat "full") and its backward once."""
    cfg = get_smoke_config(arch)
    params = serve.init_params(cfg, 1, cuda)
    batch = registry.synth_inputs(torch.Generator(device=cuda).manual_seed(
        10), cfg, ShapeConfig("t", 72, 2, "train"), device=cuda)
    n = (kssd.launches, kssd.bwd_launches)
    gk, mk = tstep.grads_and_metrics(params, cfg, RunConfig(ce_block_v=64),
                                     batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (kssd.launches, kssd.bwd_launches) == (n[0] + 2 * L, n[1] + L)
    gp, mp = tstep.grads_and_metrics(
        params, cfg, RunConfig(ce_block_v=64, use_kernels=False), batch)
    assert (kssd.launches, kssd.bwd_launches) == (n[0] + 2 * L, n[1] + L)
    torch.testing.assert_close(mk["loss"], mp["loss"], rtol=1e-2, atol=0)
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).norm()
                     / b.float().norm()) <= 5e-2


# --- AdamW -------------------------------------------------------------------
# Leaves below one vector of 8 elements (a 1-D one: no decay), ragged past
# it, and large enough that a leaf's norm runs hundreds of blocks.
ADAMW_SHAPES = {"b": (5,), "s": (1,), "w": (37, 129), "e": (3, 1000),
                "big": (1000, 1001)}
ADAMW_COMBOS = [(p, g, mv) for p in DTYPES for g in DTYPES for mv in DTYPES]


def _adamw_tree(cuda, dtype, seed, exact=False):
    """A tree of ADAMW_SHAPES leaves.  ``exact``: multiples of 1/16 in
    [-3/16, 3/16], whose squares add up exactly in f32 in any order, so
    the kernels' norm and the plain version's agree to the bit."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    out = {}
    for k, shape in ADAMW_SHAPES.items():
        if exact:
            t = torch.randint(-3, 4, shape, generator=g, device=cuda) / 16
        else:
            t = torch.randn(shape, generator=g, device=cuda)
        out[k] = t.to(dtype)
    return out


def _adamw_steps(cuda, p_dtype, g_dtype, mv_dtype, kernel, grads,
                 max_grad_norm=1.0):
    params = _adamw_tree(cuda, p_dtype, 0)
    opt = adamw_init(params, dtype=mv_dtype)
    norms = []
    for i, gs in enumerate(grads):
        _, _, met = adamw_update(
            params, gs, opt, lr=1e-2 * (i + 1), max_grad_norm=max_grad_norm,
            use_kernels=kernel)
        norms.append(met["grad_norm"])
    torch.cuda.synchronize()
    return params, opt, norms


def _bits_equal(a, b) -> bool:
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


@pytest.mark.parametrize("p_dtype,g_dtype,mv_dtype", ADAMW_COMBOS)
@pytest.mark.parametrize("clip", ["active", "inactive", "zero_grads"])
def test_adamw_kernels_match_plain(cuda, p_dtype, g_dtype, mv_dtype, clip):
    """Three steps through the kernels (``use_kernels`` None on CUDA)
    against the plain version on the card, every dtype combination, the
    clip active, inactive, and all-zero gradients (norm 0, scale 1):
    params, moments and the norm BIT-EQUAL.  Both round where the JAX
    reference does and the kernel spells out the plain version's order,
    so there is nothing to tolerate; the gradients are multiples of 1/16
    whose squares sum exactly in any order, so the two norms (and the
    clip scales) agree too.  The gradients are left as they were, and a
    step launches 2 x leaves + 1 kernels."""
    if clip == "zero_grads":
        grads = [{k: torch.zeros(s, dtype=g_dtype, device=cuda)
                  for k, s in ADAMW_SHAPES.items()} for _ in range(3)]
    else:
        grads = [_adamw_tree(cuda, g_dtype, 10 + i, exact=True)
                 for i in range(3)]
    kept = [{k: t.clone() for k, t in gs.items()} for gs in grads]
    max_norm = 1e4 if clip == "inactive" else 1.0
    n = (kadamw.launches, kadamw.norm_launches)
    pk, ok_, nk = _adamw_steps(cuda, p_dtype, g_dtype, mv_dtype, None, grads,
                               max_norm)
    L = len(ADAMW_SHAPES)
    assert (kadamw.launches, kadamw.norm_launches) == (n[0] + 3 * L,
                                                       n[1] + 3 * (L + 1))
    pp, op, npl = _adamw_steps(cuda, p_dtype, g_dtype, mv_dtype, False,
                               grads, max_norm)
    assert (kadamw.launches, kadamw.norm_launches) == (n[0] + 3 * L,
                                                       n[1] + 3 * (L + 1))
    for gs, ks in zip(grads, kept):
        assert all(torch.equal(gs[k], ks[k]) for k in gs)
    for a, b in zip(nk, npl):
        assert a.shape == () and a.is_cuda and _bits_equal(a, b)
    if clip == "zero_grads":
        assert all(float(a) == 0.0 for a in nk)
    else:
        want = math.sqrt(sum(float(t.double().pow(2).sum())
                             for t in grads[-1].values()))
        assert float(nk[-1]) == pytest.approx(want, rel=1e-6)
        assert (float(nk[-1]) > max_norm) == (clip == "active")
    for k in ADAMW_SHAPES:
        assert _bits_equal(pk[k], pp[k]), k
        assert _bits_equal(ok_["m"][k], op["m"][k]), k
        assert _bits_equal(ok_["v"][k], op["v"][k]), k
        assert bool(torch.isfinite(pk[k]).all())
    # the 1-D leaves take no decay: with zero gradients they do not move
    if clip == "zero_grads":
        start = _adamw_tree(cuda, p_dtype, 0)
        assert torch.equal(pk["b"], start["b"])
        assert not torch.equal(pk["w"], start["w"])


def test_adamw_kernels_random_grads_and_misaligned_leaves(cuda):
    """Gaussian gradients (the norm summed in another order than the plain
    version's): the norm within 1e-5 of the f64 one and of the plain
    version's (f32 sums of a million squares in other orders), and with
    the clip inactive every leaf bit-equal; leaves
    that are misaligned views (the scalar path) give the bits of aligned
    copies."""
    grads = [_adamw_tree(cuda, torch.bfloat16, 20 + i) for i in range(3)]
    pk, ok_, nk = _adamw_steps(cuda, torch.bfloat16, torch.bfloat16,
                               torch.float32, None, grads, 1e6)
    pp, op, npl = _adamw_steps(cuda, torch.bfloat16, torch.bfloat16,
                               torch.float32, False, grads, 1e6)
    want = math.sqrt(sum(float(t.double().pow(2).sum())
                         for t in grads[-1].values()))
    assert float(nk[-1]) == pytest.approx(want, rel=1e-5)
    assert float(nk[-1]) == pytest.approx(float(npl[-1]), rel=1e-5)
    for k in ADAMW_SHAPES:
        for a, b in ((pk, pp), (ok_["m"], op["m"]), (ok_["v"], op["v"])):
            assert _bits_equal(a[k], b[k]), k

    def shifted(t):  # a contiguous view one element past a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    params = _adamw_tree(cuda, torch.bfloat16, 0)
    opt = adamw_init(params)
    views = {k: shifted(t) for k, t in params.items()}
    vopt = {"m": {k: shifted(t) for k, t in opt["m"].items()},
            "v": {k: shifted(t) for k, t in opt["v"].items()}, "step": 0}
    vgrads = [{k: shifted(t) for k, t in gs.items()} for gs in grads]
    for gs, vgs in zip(grads, vgrads):
        adamw_update(params, gs, opt, lr=1e-2)
        adamw_update(views, vgs, vopt, lr=1e-2)
    torch.cuda.synchronize()
    for k in ADAMW_SHAPES:
        assert views[k].data_ptr() % 16 != 0
        for a, b in ((params, views), (opt["m"], vopt["m"]),
                     (opt["v"], vopt["v"])):
            assert _bits_equal(a[k], b[k]), k


def test_adamw_norm_is_fixed_order_and_wrapper_checks(cuda):
    """Two steps on the same gradients report the same bits of
    ``grad_norm`` (a fixed grid, fixed trees, no atomics), over several
    blocks of a leaf, within 1e-5 of the plain version's; the wrapper
    raises on a non-contiguous leaf, an unsupported dtype, mixed moment
    dtypes and CPU leaves."""
    grads = _adamw_tree(cuda, torch.float32, 30)
    params = _adamw_tree(cuda, torch.float32, 0)
    opt = adamw_init(params)
    a, b, plain = (adamw_update(params, grads, opt, lr=1e-2,
                                use_kernels=k)[2]["grad_norm"]
                   for k in (None, None, False))
    assert kadamw.norm_blocks(grads["big"].numel()) > 100
    assert _bits_equal(a, b)
    assert float(a) == pytest.approx(float(plain), rel=1e-5)
    p = torch.zeros((8, 16), device=cuda)
    ok_args = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                   c1=0.1, c2=0.05, decay=True)
    with pytest.raises(ValueError, match="contiguous"):
        kadamw.update_cuda(p, p.t(), p, p, None, **ok_args)
    with pytest.raises(TypeError):
        h = p.half()
        kadamw.update_cuda(h, h, h, h, None, **ok_args)
    with pytest.raises(TypeError):
        kadamw.update_cuda(p, p, p, p.bfloat16(), None, **ok_args)
    with pytest.raises(ValueError, match="CUDA"):
        kadamw.update_cuda(p, p.cpu(), p, p, None, **ok_args)


# The bf16 tensor-core scan: N = 128 with P = 64 (mamba2-130m's head),
# ragged S over several chunks, G > 1, N no multiple of 8 (padded by the
# wrapper), and P narrower than the 64-column P-tile.
SSD_TC_CASES = [
    (2, 300, 4, 64, 1, 128, 128),
    (1, 517, 6, 64, 2, 64, 128),
    (2, 333, 4, 32, 1, 20, 64),
    (1, 200, 3, 24, 1, 48, 96),
    (1, 9, 2, 8, 1, 8, 16),
]


@pytest.mark.parametrize("case", SSD_TC_CASES)
def test_ssd_tc_kernel_matches_plain(cuda, case):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(case, torch.bfloat16, cuda, seed=7,
                                       state=True)
    chunk = case[-1]
    n = kssd.launches
    y, h = kssd.ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk, init_state=h0,
                         return_state=True)
    torch.cuda.synchronize()
    assert kssd.launches == n + 1 and h.shape == h0.shape
    ry, rh = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, init_state=h0,
                         return_state=True)
    torch.testing.assert_close(y.float(), ry.float(),
                               **_ssd_tol(torch.bfloat16))
    torch.testing.assert_close(h, rh, **_ssd_tol(torch.bfloat16))


def test_ssd_tc_kernel_reads_views_and_copies_misaligned(cuda):
    """x as the model's view of (B, S, H * P) and B/C as slices of one
    (B, S, 2N) tensor are read in place; B and C one element off a
    16-byte boundary, and x with a row stride that is no multiple of 8,
    are copied to new memory: all give the bits of contiguous inputs."""
    B, S, H, P, N, Q = 2, 260, 4, 64, 64, 128
    bf = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(8)
    xs = (torch.randn((B, S, H * P + 8), generator=g, device=cuda)
          * 0.5).to(bf)
    bc = (torch.randn((B, S, 2 * N + 1), generator=g, device=cuda)
          * 0.3).to(bf)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * 0.3)
    x = xs[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = bc[..., :N].unsqueeze(2), bc[..., N:2 * N].unsqueeze(2)
    want = kssd.ssd_cuda(x.contiguous(), dt, A, Bm.contiguous(),
                         Cm.contiguous(), chunk=Q, return_state=True)
    got = kssd.ssd_cuda(x, dt, A, Bm, Cm, chunk=Q, return_state=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # B, C one element past an aligned address: a misaligned view
    Bo, Co = bc[..., 1:N + 1].unsqueeze(2), bc[..., N + 1:].unsqueeze(2)
    assert Bo.data_ptr() % 16 and Co.data_ptr() % 16
    want = kssd.ssd_cuda(x, dt, A, Bo.contiguous(), Co.contiguous(),
                         chunk=Q, return_state=True)
    got = kssd.ssd_cuda(x, dt, A, Bo, Co, chunk=Q, return_state=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # x with a row stride of H * P + 1 elements
    xo = (torch.randn((B, S, H * P + 1), generator=g, device=cuda)
          * 0.5).to(bf)[..., :H * P].reshape(B, S, H, P)
    want = kssd.ssd_cuda(xo.contiguous(), dt, A, Bm, Cm, chunk=Q,
                         return_state=True)
    got = kssd.ssd_cuda(xo, dt, A, Bm, Cm, chunk=Q, return_state=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ry, rh = ref.ssd_ref(xo, dt, A, Bm, Cm, chunk=Q, return_state=True)
    torch.testing.assert_close(got[0].float(), ry.float(),
                               **_ssd_tol(bf))
    torch.testing.assert_close(got[1], rh, **_ssd_tol(bf))


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_smoke_ssm_serving_kernels_match_plain(cuda, arch):
    """Prefill over two chunks and a ragged tail, then two decode steps,
    through the kernels against the plain versions."""
    cfg = get_smoke_config(arch)
    params = serve.init_params(cfg, 1, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 72), generator=g,
                         device=cuda)
    out = {}
    n = kssd.launches
    for name, run in (("kernel", RunConfig()),
                      ("plain", RunConfig(use_kernels=False))):
        cache = engine.init_cache(cfg, 2, 80, cuda)
        lp, cache = registry.prefill(params, cfg, run,
                                     {"tokens": toks[:, :70]}, cache)
        ld, cache = registry.decode(params, cfg, run, toks[:, 70:71], cache,
                                    70)
        ld2, _ = registry.decode(params, cfg, run, toks[:, 71:], cache, 71)
        out[name] = (lp, ld, ld2)
    assert kssd.launches == n + cfg.num_layers
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------------------
# Two ranks over NCCL (torchrun): the entry points on a (data, model) mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices: NCCL takes one rank a card")


def _torchrun(module: str, *args: str):
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", module, *args],
        capture_output=True, text=True, timeout=900, env=env)


@pytest.mark.parametrize("arch,model", [("yi-6b", "1"), ("yi-6b", "2"),
                                        ("mixtral-8x7b", "2"),
                                        ("qwen3-moe-235b-a22b", "2")])
def test_torchrun_two_ranks_serve(two_cards, arch, model):
    """Smoke serving over 2 ranks: data parallel (model 1) or one model
    group of 2 (the MoE archs' experts split over it)."""
    r = _torchrun("repro_torch.launch.serve", "--arch", arch, "--model",
                  model, "--batch", "4", "--gen", "4", "--prompt-len", "24")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "'generated': (4, 4)" in r.stdout, r.stdout


@pytest.mark.parametrize("arch,model,carousel", [
    ("yi-6b", "1", False), ("yi-6b", "2", False), ("yi-6b", "1", True),
    ("mixtral-8x7b", "2", False)])
def test_torchrun_two_ranks_train(two_cards, arch, model, carousel):
    """Smoke training over 2 ranks; with the carousel, rank 0 stages and
    broadcasts each batch."""
    args = ["--arch", arch, "--model", model, "--steps", "2",
            "--global-batch", "4", "--seq-len", "24"]
    if not carousel:
        args.append("--no-carousel")
    r = _torchrun("repro_torch.launch.train", *args)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "'final_step': 2" in r.stdout, r.stdout


# ---------------------------------------------------------------------------
# Four ranks (torchrun): the dense compute split over "model"
# ---------------------------------------------------------------------------


def _split_worker(arch: str, shape: str, device: str = "cuda") -> None:
    """One rank of ``test_torchrun_four_ranks_split``: smoke ``arch`` at
    mesh ``shape`` ("1x4" or "2x2") with its weights in f32, its prefill,
    three decode steps fed fixed tokens and the first batch's gradients
    (CE products in f32) through the kernels under the split, against the
    same path at one rank on rank 0: logits and gradient leaves relative
    L2 1e-3, loss 1e-5 (sums in another order; in bf16 a smoke model's
    leaves move more than 5e-2 with the rounding alone, and MoE routing
    flips).  NCCL with a card a rank; gloo, every rank on one card, below
    4 cards."""
    import torch.distributed as dist

    from repro_torch.launch import mesh
    from repro_torch.sharding import (ShardingRules, batch_split,
                                      gather_params, use_rules)
    n = 4
    mesh.init_distributed(None if device == "cuda"
                          and torch.cuda.device_count() >= n else "gloo")
    dev = mesh.local_device(device)
    data, model = (int(x) for x in shape.split("x"))
    cfg = get_smoke_config(arch)
    B, S, ML = 4, 24, 32
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = registry.synth_inputs(g, cfg, ShapeConfig("s", S, B, "prefill"),
                                   device=dev)
    feed = torch.randint(0, cfg.vocab_size, (B, 3), generator=g, device=dev)
    batch = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(4), cfg,
        ShapeConfig("t", S, B, "train"), "train", device=dev)
    run = train.default_run_config(cfg, 3).replace(ce_dtype="float32")

    def path(rules):
        rows = rules.rows(B) if rules.mesh.shape["data"] > 1 else \
            torch.arange(B)
        axes = rules.batch_axes(B) if rules.mesh.shape["data"] > 1 else ()
        rows = rows.to(dev)
        with use_rules(rules):
            params = P.cast_tree(serve.init_params(cfg, 1, dev),
                                 torch.float32)
            with torch.inference_mode(), batch_split(len(rows), axes):
                cache = engine.init_cache(cfg, len(rows), ML, dev)
                lg, cache = registry.prefill(
                    params, cfg, RunConfig(),
                    {k: v[rows] for k, v in prompt.items()}, cache)
                outs = [lg]
                for i in range(3):
                    lg, cache = registry.decode(params, cfg, RunConfig(),
                                                feed[rows, i:i + 1], cache,
                                                S + i)
                    outs.append(lg)
                logits = rules.all_gather(torch.cat(outs, 1).float(), 0,
                                          axes)
            grads, m = tstep.grads_and_metrics(params, cfg, run, batch)
            with torch.no_grad():
                grads = gather_params(grads, registry.param_defs(cfg))
        return logits, float(m["loss"]), grads

    split = path(ShardingRules(mesh.make_host_mesh(model, dev.type)))
    if dist.get_rank() == 0:
        from repro_torch.launch.mesh import Mesh
        one = path(ShardingRules(Mesh((1, 1), ("data", "model"))))
        rel = lambda a, b: float((a.float() - b.float()).norm()
                                 / b.float().norm().clamp(min=1e-30))
        print("SPLIT", arch, shape, "logits", rel(split[0], one[0]),
              "loss", split[1], one[1], "leaves", {
                  k: rel(a, one_g) for (k, a), one_g in zip(
                      sorted(_flat(split[2]).items()),
                      (v for _, v in sorted(_flat(one[2]).items())))},
              flush=True)
        assert rel(split[0], one[0]) <= 1e-3, rel(split[0], one[0])
        assert abs(split[1] - one[1]) <= 1e-5 * abs(one[1])
        for (k, a), (_, b) in zip(sorted(_flat(split[2]).items()),
                                  sorted(_flat(one[2]).items())):
            if k.endswith("/bk") and cfg.rope_theta <= 0:
                # unrotated keys: the softmax drops q . bk, so the gradient
                # is zero but for rounding
                assert max(float(a.abs().max()), float(b.abs().max())) \
                    <= 1e-6, k
                continue
            assert rel(a, b) <= 1e-3, (k, rel(a, b))
        print("SPLIT OK", arch, shape, rel(split[0], one[0]), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch,shape", [
    ("yi-6b", "1x4"), ("yi-6b", "2x2"), ("qwen1.5-4b", "1x4"),
    ("mixtral-8x7b", "1x4"), ("whisper-tiny", "1x4"),
    ("mamba2-130m", "1x4"), ("zamba2-1.2b", "1x4")])
def test_torchrun_four_ranks_split(two_cards, arch, shape):
    """Four ranks at (1, 4) or (2, 2), the compute split over "model"
    (qwen1.5-4b's 3 heads: the query rows; the mamba blocks by SSM heads,
    their gated norm on the split-row kernels; MoE decode's experts where
    they lie), held against one rank by ``_split_worker``."""
    import os
    import subprocess
    import sys
    here = os.path.abspath(__file__)
    src = os.path.join(os.path.dirname(os.path.dirname(here)), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", here, "split", arch, shape],
        capture_output=True, text=True, timeout=900, env=env)
    errors = [ln for ln in r.stderr.splitlines() if "Error" in ln]
    assert r.returncode == 0, (r.stdout[-3000:], errors[-10:])
    assert f"SPLIT OK {arch} {shape}" in r.stdout, r.stdout


if __name__ == "__main__" and sys.argv[1:2] == ["split"]:
    _split_worker(*sys.argv[2:])
