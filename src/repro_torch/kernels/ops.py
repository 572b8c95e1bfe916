"""Dispatch between the hand-written CUDA kernels and the plain versions,
as ``repro/kernels/ops.py`` dispatches between Pallas and ``ref.py``.

``use_kernels`` (from ``RunConfig``): None takes the kernel exactly when
the tensor lies on CUDA; True on a CPU tensor raises; False takes the
plain version.  A CUDA tensor sent to a kernel launches it or raises:
there is no fallback.

Where a gradient is needed (grad mode on and an input that requires
grad), ``rmsnorm``, ``flash_attention`` and ``ssd`` go through their
autograd Functions, whose backward is a kernel too (or the plain
backward); the forward then also writes or saves what the backward
reads.  Otherwise they call the forward alone, so serving pays nothing
for training.  On the plain path ``ssd``'s Function takes its gradients
from ``ref.ssd_bwd_ref``, the hand-derived formulas the kernel follows
(tests hold them against ``jax.vjp`` and torch autograd of ``ssd_ref``).

Each entry that has a kernel reports its call to an active cost counter
(``kernels/meter.py``) with the work of the function it computes, on the
kernel path and the plain path alike.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cross_entropy as _ce
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import meter
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd_scan as _ssd


def _kernel_path(x: torch.Tensor, use_kernels: Optional[bool]) -> bool:
    if use_kernels is None:
        return x.is_cuda
    if use_kernels and not x.is_cuda:
        raise ValueError(f"use_kernels=True needs CUDA tensors, got a tensor "
                         f"on {x.device}")
    return bool(use_kernels)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rmsnorm(x, w, *, eps: float = 1e-6,
            use_kernels: Optional[bool] = None) -> torch.Tensor:
    kernel = _kernel_path(x, use_kernels)
    grad = _needs_grad(x, w)
    with meter.charge("rmsnorm", lambda: _rmsnorm.work(x, w, inv=grad)):
        if grad:
            return _rmsnorm.RMSNormFn.apply(x, w, eps, kernel)
        if kernel:
            return _rmsnorm.rmsnorm_cuda(x, w, eps)
        return _ref.rmsnorm_ref(x, w, eps)


def rmsnorm_split(x, w, *, d_whole: int, reduce, eps: float = 1e-6,
                  use_kernels: Optional[bool] = None) -> torch.Tensor:
    """RMSNorm of rows ``d_whole`` wide whose columns lie on several
    ranks: x and w hold this rank's columns, and ``reduce`` sums a (rows,)
    f32 statistic over the ranks in place (``_rmsnorm.RMSNormSplitFn``:
    two launches and a sum each way; each launch charged on its own)."""
    return _rmsnorm.RMSNormSplitFn.apply(x, w, eps, d_whole, reduce,
                                         _kernel_path(x, use_kernels))


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None, sliding_window: int = 0,
                    block_k: int = 512,
                    use_kernels: Optional[bool] = None) -> torch.Tensor:
    kernel = _kernel_path(q, use_kernels)
    opts = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                sliding_window=sliding_window)
    grad = _needs_grad(q, k, v)
    with meter.charge("flash_attention",
                      lambda: _flash.work(q, k, lse=grad, **opts)):
        if grad:
            return _flash.FlashAttentionFn.apply(q, k, v, kernel,
                                                 dict(opts, block_k=block_k))
        if kernel:
            return _flash.flash_attention_cuda(q, k, v, **opts)
        return _ref.flash_attention_ref(q, k, v, block_k=block_k, **opts)


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128, init_state=None,
        return_state: bool = False, use_kernels: Optional[bool] = None):
    """The chunked SSD scan (Mamba2 prefill and training): the CUDA kernel
    or ``ssd_ref``."""
    kernel = _kernel_path(x, use_kernels)
    with meter.charge("ssd_scan", lambda: _ssd.work(
            x, Bm, chunk=chunk, init_state=init_state is not None)):
        if _needs_grad(*(t for t in (x, dt, A, Bm, Cm, init_state)
                         if t is not None)):
            y, h = _ssd.SSDFn.apply(x, dt, A, Bm, Cm, init_state, chunk,
                                    kernel)
            return (y, h) if return_state else y
        if kernel:
            return _ssd.ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk,
                                 init_state=init_state,
                                 return_state=return_state)
        return _ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state, return_state=return_state)


def ssd_decode(x, dt, A, Bm, Cm, h):
    """Single-token SSD recurrence (decode), plain torch on every device:
    the JAX package has no kernel there either."""
    return _ref.ssd_decode_ref(x, dt, A, Bm, Cm, h)


def cross_entropy(hidden, w_vocab, targets, valid=None, *,
                  mode: str = "direct", block_v: int = 4096,
                  use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Mean NLL over the valid tokens (forward only, as the Pallas
    kernel).  The kernel multiplies in f32 whatever ``mode`` says, as
    ``cross_entropy_pallas`` does; the plain path takes ``mode``."""
    if _kernel_path(hidden, use_kernels):
        with meter.charge("cross_entropy",
                          lambda: _ce.work(hidden, w_vocab)):
            nll, _ = _ce.cross_entropy_cuda(hidden, w_vocab, targets)
        if valid is None:
            return nll.mean()
        vf = valid.float()
        return (nll * vf).sum() / torch.clamp(vf.sum(), min=1.0)
    if mode == "blockwise":
        return _ref.cross_entropy_blockwise_ref(hidden, w_vocab, targets,
                                                valid, block_v=block_v)
    return _ref.cross_entropy_direct_ref(hidden, w_vocab, targets, valid)
