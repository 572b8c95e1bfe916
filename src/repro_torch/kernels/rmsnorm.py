"""RMSNorm: wrapper of the hand-written CUDA kernel ``csrc/rmsnorm.cu``
(bound in ``csrc/bindings.cpp``).

Replaces ``repro/kernels/rmsnorm.py::rmsnorm_pallas`` (body
``_rmsnorm_kernel``).  Bound on the card: bytes — each of the rows*D
elements is read once and written once, so the least time is
``rows * D * (in + out itemsize)`` over HBM bandwidth.  One thread block
per row, 16-byte vector loads, an f32 sum of squares reduced with warp
shuffles (see the source note in the .cu file).

The plain version is :func:`repro_torch.kernels.ref.rmsnorm_ref`;
``kernels/ops.py`` sends CPU tensors there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last reset (set to 0 to reset)

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launches the kernel.  x: (..., D) contiguous CUDA tensor, bf16 or
    f32; w: (D,) bf16 or f32 on the same device.  Output in x's dtype."""
    global launches
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"rmsnorm_cuda needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_cuda takes bf16/f32, got {x.dtype}, "
                        f"{w.dtype}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w must have shape ({D},), got {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and w")
    y = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    build.extension().rmsnorm_fwd(x, w, y, float(eps))
    launches += 1
    return y

