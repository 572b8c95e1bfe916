"""Mamba2 SSD chunked scan: the wrapper of the hand-written CUDA kernel
``csrc/ssd_scan.cu`` (bound in ``csrc/bindings.cpp``).

It replaces ``repro/kernels/ssd_scan.py::ssd_pallas`` (body
``_ssd_kernel``).  Bound on the card: bytes (x, dt, B and C read once, y
and the final state written once); this first version computes in f32
FMAs on the CUDA cores, so it is bound by that arithmetic instead (see
the source notes).  One block owns a (batch, head, P-tile) and walks the
chunks in order, holding its slice of the (P, N) state; a small first
kernel computes C Bᵀ once per (batch, group, chunk).

x, B and C keep the JAX layout and are read through their strides (the
last axis contiguous), so the model's ``xh`` view of (B, S, H * P) is not
copied.  The tail past S is masked, not padded.

The plain version is :func:`repro_torch.kernels.ref.ssd_ref`;
``kernels/ops.py`` sends CPU tensors there.  The JAX package has no SSD
backward kernel (training autodiffs ``ssd_ref``), so there is no autograd
Function here: ``ops.ssd`` refuses the kernel path where a gradient is
needed.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

# kernel launches since the last reset (set to 0 to reset)
launches = 0

MAX_CHUNK = 128
MAX_STATE = 128
_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, dt, A, Bm, Cm, init_state, chunk: int) -> None:
    ts = (x, dt, A, Bm, Cm) + (() if init_state is None else (init_state,))
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError("ssd_cuda needs every input on one CUDA device, got "
                         + ", ".join(str(t.device) for t in ts))
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_cuda takes x, B, C in one dtype, bf16 or f32; "
                        f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    for name, t in (("dt", dt), ("A", A), ("init_state", init_state)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be f32, got {t.dtype}")
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"bad shapes x{tuple(x.shape)} B{tuple(Bm.shape)} "
                         f"C{tuple(Cm.shape)}")
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (Bm.shape[:2] != (B_, S) or dt.shape != (B_, S, H)
            or A.shape != (H,) or G == 0 or H % G):
        raise ValueError(f"incompatible x{tuple(x.shape)} dt{tuple(dt.shape)}"
                         f" A{tuple(A.shape)} B{tuple(Bm.shape)}")
    if P % 8 or not 0 < N <= MAX_STATE or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_cuda takes P a multiple of 8, N <= "
                         f"{MAX_STATE} and chunk <= {MAX_CHUNK}; got P={P}, "
                         f"N={N}, chunk={chunk}")
    if any(t.stride(-1) != 1 for t in (x, dt, Bm, Cm)) or \
            not A.is_contiguous():
        raise ValueError("ssd_cuda needs a contiguous last axis")
    if init_state is not None and (init_state.shape != (B_, H, P, N)
                                   or not init_state.is_contiguous()):
        raise ValueError(f"init_state must be contiguous {(B_, H, P, N)}, "
                         f"got {tuple(init_state.shape)}")


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """Launches the SSD kernels.  x: (B, S, H, P); dt: (B, S, H) f32
    (post-softplus); A: (H,) f32 (negative); Bm, Cm: (B, S, G, N); x, Bm,
    Cm one dtype (bf16 or f32) on one CUDA device; init_state: (B, H, P,
    N) f32 or None (zeros).  Returns y (B, S, H, P) in x's dtype and, with
    ``return_state``, the f32 (B, H, P, N) state after the last token."""
    global launches
    chunk = int(chunk)
    _check(x, dt, A, Bm, Cm, init_state, chunk)
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((B_, S, H, P), dtype=x.dtype, device=x.device)
    h_out = torch.empty((B_, H, P, N), dtype=torch.float32, device=x.device)
    n_c = -(-S // chunk)
    cb = torch.empty((B_, G, n_c, chunk, chunk), dtype=torch.float32,
                     device=x.device)
    build.extension().ssd_fwd(x, dt, A, Bm, Cm, init_state, cb, y, h_out,
                              chunk)
    launches += 1
    return (y, h_out) if return_state else y
