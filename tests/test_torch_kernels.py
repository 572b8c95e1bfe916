"""The port's plain kernel versions against the JAX references, on the CPU.

The same numpy inputs go through ``repro.kernels.ref`` (and the Pallas
kernel in interpret mode) and through ``repro_torch.kernels.ref``.
Tolerances are those of tests/test_kernels.py: 3e-5 in f32 (the sums run
in another order) and 2e-2 in bf16 (one output rounding apart).
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms

REPO = Path(__file__).resolve().parent.parent

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
    """One f32 numpy array as a JAX and a torch array of ``dtype``; both
    round f32 -> bf16 to nearest even, so the bits agree."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(case, dtype, seed=0):
    B, Sq, Sk, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D), np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D), np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D), np.float32)
    return _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 384), (1, 513),
                                   (4, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_ref_matches_jax(shape, dtype):
    rng = np.random.default_rng(0)
    (jx, tx) = _pair(rng.standard_normal(shape, np.float32), dtype)
    (jw, tw) = _pair(rng.standard_normal(shape[-1:], np.float32), dtype)
    a = tref.rmsnorm_ref(tx, tw, 1e-5)
    b = jref.rmsnorm_ref(jx, jw, 1e-5)
    assert a.dtype == tx.dtype
    np.testing.assert_allclose(_np(a), _np(b), **_tol(dtype))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_ref_matches_jax_ref_and_pallas(case, dtype):
    causal, sw, qoff, kvl = case[6:]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, dtype)
    kw = dict(causal=causal, sliding_window=sw, q_offset=qoff, kv_len=kvl)
    a = tref.flash_attention_ref(tq, tk, tv, block_k=48, **kw)
    assert a.dtype == tq.dtype and a.shape == tq.shape
    b = jref.flash_attention_ref(jq, jk, jv, block_k=48, **kw)
    c = flash_attention_pallas(jq, jk, jv, block_k=64, interpret=True,
                               **kw)
    np.testing.assert_allclose(_np(a), _np(b), **_tol(dtype))
    np.testing.assert_allclose(_np(a), _np(c), **_tol(dtype))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_naive_matches_jax(case, dtype):
    causal, sw, qoff, kvl = case[6:]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, dtype, seed=1)
    kw = dict(causal=causal, sliding_window=sw, q_offset=qoff, kv_len=kvl)
    a = tref.attention_naive(tq, tk, tv, **kw)
    b = jref.attention_naive(jq, jk, jv, **kw)
    np.testing.assert_allclose(_np(a), _np(b), **_tol(dtype))
    # the chunked reference against the naive one, both in the port
    c = tref.flash_attention_ref(tq, tk, tv, block_k=64, **kw)
    np.testing.assert_allclose(_np(c), _np(a), **_tol(dtype))


def test_fully_masked_rows_average_v_like_jax():
    """A row with no valid key (kv_len=0) is the mean over V including
    the zero padding of the last KV chunk, in both references."""
    case = (1, 4, 40, 2, 1, 16, False, 0, 0, 0)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, "float32", seed=2)
    a = tref.flash_attention_ref(tq, tk, tv, causal=False, kv_len=0,
                                 block_k=16)
    b = jref.flash_attention_ref(jq, jk, jv, causal=False, kv_len=0,
                                 block_k=16)
    np.testing.assert_allclose(_np(a), _np(b), rtol=3e-5, atol=3e-5)


def test_ops_dispatch_on_cpu():
    x = torch.randn(3, 8)
    w = torch.ones(8)
    ref = tref.rmsnorm_ref(x, w, 1e-6)
    torch.testing.assert_close(tops.rmsnorm(x, w), ref)
    torch.testing.assert_close(tops.rmsnorm(x, w, use_kernels=False), ref)
    with pytest.raises(ValueError, match="CUDA"):
        tops.rmsnorm(x, w, use_kernels=True)
    q = torch.randn(1, 4, 2, 16)
    k = torch.randn(1, 4, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, k, k, use_kernels=True)
    torch.testing.assert_close(tops.flash_attention(q, k, k),
                               tref.flash_attention_ref(q, k, k))


def test_kernel_wrappers_refuse_cpu_tensors():
    n_rms, n_flash = trms.launches, tflash.launches
    x = torch.randn(3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        trms.rmsnorm_cuda(x, torch.ones(8))
    q = torch.randn(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_cuda(q, q[:, :, :1], q[:, :, :1])
    assert (trms.launches, tflash.launches) == (n_rms, n_flash)


def test_chunk_aligned_copies_misaligned_views():
    """The bf16 flash kernels copy 16-byte chunks: an input whose address
    or strides are not a multiple of 16 bytes is copied to new memory,
    a contiguous view one element past an aligned address included."""
    base = torch.randn(2 * 5 * 3 * 16 + 1).bfloat16()
    off = base[1:].view(2, 5, 3, 16)
    assert off.is_contiguous() and off.data_ptr() % 16
    got = tflash._chunk_aligned(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)
    odd = torch.randn(2, 5, 3, 17).bfloat16()[..., :16]  # row stride 17
    got = tflash._chunk_aligned(odd)
    assert got.is_contiguous() and torch.equal(got, odd)
    fine = torch.randn(2, 5, 3, 16).bfloat16()
    assert tflash._chunk_aligned(fine) is fine
    view = fine[:, 1:]
    assert tflash._chunk_aligned(view) is view


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert "__import__(" not in text and "import_module(" not in text, \
            path
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
