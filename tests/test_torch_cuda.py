"""The hand-written CUDA kernels against their plain versions, on a GPU.

These need a CUDA card and nvcc (they build the kernels at first use) and
skip elsewhere.  They import no JAX, so they run on a machine with only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py: 2e-2 in bf16, 3e-5 in f32.
"""
import pytest
import torch

from repro_torch.configs.base import RunConfig, get_smoke_config
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as krms
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.serve import engine

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
]
DTYPES = [torch.float32, torch.bfloat16]


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
