"""Dispatch between the hand-written CUDA kernels and the plain versions,
as ``repro/kernels/ops.py`` dispatches between Pallas and ``ref.py``.

``use_kernels`` (from ``RunConfig``): None takes the kernel exactly when
the tensor lies on CUDA; True on a CPU tensor raises; False takes the
plain version.  A CUDA tensor sent to a kernel launches it or raises:
there is no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rmsnorm


def _kernel_path(x: torch.Tensor, use_kernels: Optional[bool]) -> bool:
    if use_kernels is None:
        return x.is_cuda
    if use_kernels and not x.is_cuda:
        raise ValueError(f"use_kernels=True needs CUDA tensors, got a tensor "
                         f"on {x.device}")
    return bool(use_kernels)


def rmsnorm(x, w, *, eps: float = 1e-6,
            use_kernels: Optional[bool] = None) -> torch.Tensor:
    if _kernel_path(x, use_kernels):
        return _rmsnorm.rmsnorm_cuda(x, w, eps)
    return _ref.rmsnorm_ref(x, w, eps)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None, sliding_window: int = 0,
                    block_k: int = 512,
                    use_kernels: Optional[bool] = None) -> torch.Tensor:
    if _kernel_path(q, use_kernels):
        return _flash.flash_attention_cuda(
            q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
            sliding_window=sliding_window)
    return _ref.flash_attention_ref(
        q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
        sliding_window=sliding_window, block_k=block_k)
