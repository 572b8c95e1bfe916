"""RMSNorm: wrappers of the hand-written CUDA kernels ``csrc/rmsnorm.cu``
(bound in ``csrc/bindings.cpp``) and the autograd Function around them.

The forward replaces ``repro/kernels/rmsnorm.py::rmsnorm_pallas`` (body
``_rmsnorm_kernel``); the backward is the twin of
``repro/kernels/ref.py::_rmsnorm_vjp_bwd``, which the JAX package runs in
jnp.  Both are bound by bytes: the least time is the bytes each element
needs read and written once over HBM bandwidth.  Both run a fixed grid
of a few blocks a SM over the rows, each row read once into registers
as 16-byte vectors, the next rows loading while one is reduced (a
scalar path takes any other width or alignment).  The forward splits a
row evenly over a team of threads sized to D and keeps w in f32
registers; the backward sums dw into one f32 partial row a block and
the partials in a fixed order by a second kernel (see the source
notes).

The plain versions are :func:`repro_torch.kernels.ref.rmsnorm_fwd_ref`
and :func:`~repro_torch.kernels.ref.rmsnorm_bwd_ref`; ``kernels/ops.py``
sends CPU tensors there.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meter
from repro_torch.kernels import ref

# kernel launches since the last reset (set to 0 to reset)
launches = 0  # forward
bwd_launches = 0  # backward

_DTYPES = (torch.float32, torch.bfloat16)


def work(x: torch.Tensor, w: torch.Tensor, *,
         inv: bool = False) -> Tuple[float, int]:
    """(FLOPs, bytes) of one forward at x's and w's shapes and dtypes:
    3 FLOPs an element; x and w read once, y (and with ``inv`` the f32
    per-row statistic) written once."""
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    n_bytes = 2 * x.numel() * x.element_size() + D * w.element_size()
    return 3.0 * x.numel(), n_bytes + (4 * rows if inv else 0)


def bwd_work(x: torch.Tensor, w: torch.Tensor) -> Tuple[float, int]:
    """(FLOPs, bytes) of one backward: 8 FLOPs an element; x, g, w and
    the f32 ``inv`` read once, dx and dw written once."""
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    return 8.0 * x.numel(), (3 * x.numel() * x.element_size()
                             + 2 * D * w.element_size() + 4 * rows)


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> int:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"{name} needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"{name} takes bf16/f32, got {x.dtype}, {w.dtype}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w must have shape ({D},), got {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} needs contiguous x and w")
    return D


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
                 return_inv: bool = False):
    """Launches the forward kernel.  x: (..., D) contiguous CUDA tensor,
    bf16 or f32; w: (D,) bf16 or f32 on the same device.  Output in x's
    dtype; with ``return_inv`` also the per-row f32 ``inv`` of shape
    ``x.shape[:-1]`` that the backward reads."""
    global launches
    D = _check(x, w, "rmsnorm_cuda")
    y = torch.empty_like(x)
    inv = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
           if return_inv else None)
    if x.numel():
        build.extension().rmsnorm_fwd(x, w, y, float(eps), inv)
        launches += 1
    return (y, inv) if return_inv else y


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                     g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches the backward kernels.  x, g: (..., D) contiguous, one
    dtype; w: (D,); inv: the forward's f32 per-row statistic.  Returns
    (dx in x's dtype, dw in w's dtype)."""
    global bwd_launches
    D = _check(x, w, "rmsnorm_bwd_cuda")
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"g must be contiguous {tuple(x.shape)} {x.dtype}, "
                         f"got {tuple(g.shape)} {g.dtype}")
    if (inv.dtype != torch.float32 or inv.shape != x.shape[:-1]
            or not inv.is_contiguous() or g.device != x.device
            or inv.device != x.device):
        raise ValueError("inv must be the forward's contiguous f32 "
                         f"{tuple(x.shape[:-1])} on {x.device}")
    dx = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return dx, torch.zeros_like(w)
    ext = build.extension()
    part = torch.empty((ext.rmsnorm_bwd_parts(x, w, g, dx), D),
                       dtype=torch.float32, device=x.device)
    dw = torch.empty_like(w)
    ext.rmsnorm_bwd(x, w, inv, g, dx, dw, part)
    bwd_launches += 1
    return dx, dw


class RMSNormFn(torch.autograd.Function):
    """y = rmsnorm(x, w) with the custom backward of
    ``repro/kernels/ref.py::_rmsnorm_vjp``: the forward saves x, w and the
    per-row ``inv``; the backward returns dx in x's dtype and dw in w's.
    ``kernel`` selects the CUDA kernels, else the plain versions."""

    @staticmethod
    def forward(ctx, x, w, eps: float, kernel: bool):
        if kernel:
            y, inv = rmsnorm_cuda(x, w, eps, return_inv=True)
        else:
            y, inv = ref.rmsnorm_fwd_ref(x, w, eps)
        ctx.kernel = kernel
        ctx.save_for_backward(x, w, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, inv = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        with meter.charge("rmsnorm_bwd", lambda: bwd_work(x, w)):
            if ctx.kernel:
                dx, dw = rmsnorm_bwd_cuda(x, w, inv, g)
            else:
                dx, dw = ref.rmsnorm_bwd_ref(x, w, inv, g)
        return dx, dw, None, None
