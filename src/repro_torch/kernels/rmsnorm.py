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

A split row (the Mamba2 block's gated norm under a ``model`` split: each
rank holds ``din / n`` of a row's columns) runs the same kernels in two
launches each way, with a sum over the ranks between them: the forward's
first launch writes each row's f32 partial sum of squares, the caller
sums the partials over the ranks (``reduce``), and the second launch
normalises the local columns by ``rsqrt(sum / d_whole + eps)`` and saves
that ``inv``; the backward does the same with each row's partial
``sum(g * w * xhat)``, and its second launch writes dx and the local
columns' dw.  :class:`RMSNormSplitFn` holds the collective between the
launches; with one rank it gives the whole-row results bit for bit.

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
split_launches = 0  # split-row forward: the statistic's and the rows'
split_bwd_launches = 0  # split-row backward: the same two

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


def stat_work(x: torch.Tensor, g: bool = False) -> Tuple[float, int]:
    """(FLOPs, bytes) of a split row's statistic launch: x (and in the
    backward g and the f32 ``inv``) read once, the (rows,) f32 partial
    written once; 2 FLOPs an element (4 with ``g``)."""
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    reads = x.numel() * x.element_size() * (2 if g else 1)
    return (4.0 if g else 2.0) * x.numel(), reads + 4 * rows * (
        2 if g else 1)


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


def _stat_out(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)


def _check_stat(x: torch.Tensor, stat: torch.Tensor, d_whole: int) -> None:
    if (stat.dtype != torch.float32 or stat.shape != x.shape[:-1]
            or not stat.is_contiguous() or stat.device != x.device):
        raise ValueError("stat must be contiguous f32 "
                         f"{tuple(x.shape[:-1])} on {x.device}")
    if not 0 < x.shape[-1] <= d_whole:
        raise ValueError(f"a row of {x.shape[-1]} columns of {d_whole}")


def rmsnorm_stat_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The split-row forward's first launch: each row's f32 sum of squares
    over x's columns, shape ``x.shape[:-1]`` (w: this call's columns of
    the weight, which pick the path as in the second launch)."""
    global split_launches
    _check(x, w, "rmsnorm_stat_cuda")
    stat = _stat_out(x)
    if x.numel():
        build.extension().rmsnorm_fwd(x, w, None, 0.0, None, stat, True, 0)
        split_launches += 1
    return stat


def rmsnorm_split_cuda(x: torch.Tensor, w: torch.Tensor, stat: torch.Tensor,
                       d_whole: int, eps: float = 1e-6
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-row forward's second launch: x's columns normalised by
    ``rsqrt(stat / d_whole + eps)``, ``stat`` the rows' sums of squares
    over all ``d_whole`` columns.  Returns (y in x's dtype, f32 inv)."""
    global split_launches
    _check(x, w, "rmsnorm_split_cuda")
    _check_stat(x, stat, d_whole)
    y, inv = torch.empty_like(x), _stat_out(x)
    if x.numel():
        build.extension().rmsnorm_fwd(x, w, y, float(eps), inv, stat, False,
                                      int(d_whole))
        split_launches += 1
    return y, inv


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                     g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches the backward kernels.  x, g: (..., D) contiguous, one
    dtype; w: (D,); inv: the forward's f32 per-row statistic.  Returns
    (dx in x's dtype, dw in w's dtype)."""
    global bwd_launches
    _check_bwd(x, w, inv, g, "rmsnorm_bwd_cuda")
    if x.numel() == 0:
        return torch.empty_like(x), torch.zeros_like(w)
    bwd_launches += 1
    return _bwd_launch(x, w, inv, g)


def _check_bwd(x, w, inv, g, name: str) -> None:
    _check(x, w, name)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"g must be contiguous {tuple(x.shape)} {x.dtype}, "
                         f"got {tuple(g.shape)} {g.dtype}")
    if (inv.dtype != torch.float32 or inv.shape != x.shape[:-1]
            or not inv.is_contiguous() or g.device != x.device
            or inv.device != x.device):
        raise ValueError("inv must be the forward's contiguous f32 "
                         f"{tuple(x.shape[:-1])} on {x.device}")


def _bwd_launch(x, w, inv, g, stat=None, d_whole: int = 0):
    """(dx, dw) from the backward's kernels on rows of x (``stat``: the
    summed split statistic)."""
    dx = torch.empty_like(x)
    ext = build.extension()
    part = torch.empty((ext.rmsnorm_bwd_parts(x, w, g, dx), x.shape[-1]),
                       dtype=torch.float32, device=x.device)
    dw = torch.empty_like(w)
    ext.rmsnorm_bwd(x, w, inv, g, dx, dw, part, stat, False, int(d_whole))
    return dx, dw


def rmsnorm_bwd_stat_cuda(x: torch.Tensor, w: torch.Tensor,
                          inv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The split-row backward's first launch: each row's f32 partial sum
    of ``g * w * xhat`` over x's columns."""
    global split_bwd_launches
    _check_bwd(x, w, inv, g, "rmsnorm_bwd_stat_cuda")
    stat = _stat_out(x)
    if x.numel():
        build.extension().rmsnorm_bwd(x, w, inv, g, None, None, None, stat,
                                      True, 0)
        split_bwd_launches += 1
    return stat


def rmsnorm_split_bwd_cuda(x: torch.Tensor, w: torch.Tensor,
                           inv: torch.Tensor, g: torch.Tensor,
                           stat: torch.Tensor, d_whole: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-row backward's second launch (and its dw pass): dx of x's
    columns and dw of w's, ``stat`` the rows' sums of ``g * w * xhat``
    over all ``d_whole`` columns."""
    global split_bwd_launches
    _check_bwd(x, w, inv, g, "rmsnorm_split_bwd_cuda")
    _check_stat(x, stat, d_whole)
    if x.numel() == 0:
        return torch.empty_like(x), torch.zeros_like(w)
    split_bwd_launches += 1
    return _bwd_launch(x, w, inv, g, stat, d_whole)


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


class RMSNormSplitFn(torch.autograd.Function):
    """The forward on a split row's columns, x (..., D_local) and w's
    columns, rows ``d_whole`` wide: the statistic launch, ``reduce(stat)``
    (sums the (rows,) f32 partials over the ranks holding the row's other
    columns, in place), the normalising launch; the backward the same way
    round.  Each launch is charged its own work.  ``kernel`` selects the
    CUDA kernels, else the plain versions (``ref.rmsnorm_stat_ref`` and
    its kin)."""

    @staticmethod
    def forward(ctx, x, w, eps: float, d_whole: int, reduce, kernel: bool):
        with meter.charge("rmsnorm_split", lambda: stat_work(x)):
            stat = rmsnorm_stat_cuda(x, w) if kernel \
                else ref.rmsnorm_stat_ref(x)
        reduce(stat)
        with meter.charge("rmsnorm_split", lambda: work(x, w, inv=True)):
            y, inv = (rmsnorm_split_cuda if kernel
                      else ref.rmsnorm_split_fwd_ref)(x, w, stat, d_whole,
                                                      eps)
        ctx.d_whole, ctx.reduce, ctx.kernel = d_whole, reduce, kernel
        ctx.save_for_backward(x, w, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, inv = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        with meter.charge("rmsnorm_split_bwd",
                          lambda: stat_work(x, g=True)):
            stat = (rmsnorm_bwd_stat_cuda if ctx.kernel
                    else ref.rmsnorm_bwd_stat_ref)(x, w, inv, g)
        ctx.reduce(stat)
        with meter.charge("rmsnorm_split_bwd", lambda: bwd_work(x, w)):
            dx, dw = (rmsnorm_split_bwd_cuda if ctx.kernel
                      else ref.rmsnorm_split_bwd_ref)(x, w, inv, g, stat,
                                                      ctx.d_whole)
        return dx, dw, None, None, None, None
