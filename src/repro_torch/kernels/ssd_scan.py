"""Mamba2 SSD chunked scan: the wrapper of the hand-written CUDA kernel
``csrc/ssd_scan.cu`` (bound in ``csrc/bindings.cpp``).

It replaces ``repro/kernels/ssd_scan.py::ssd_pallas`` (body
``_ssd_kernel``).  Bound on the card: bytes (x, dt, B and C read once, y
and the final state written once).  One block owns a (batch, head,
P-tile) and walks the chunks in order, holding its slice of the (P, N)
f32 state in registers.  bf16 (the models' path) runs its four products
on the tensor cores (``mma.sync``), with the next chunk loading while
one computes and C Bᵀ recomputed in the block: one launch.  f32 runs on
the CUDA cores, with a first small kernel computing C Bᵀ once per
(batch, group, chunk) into an f32 scratch (see the source notes).

x, B and C keep the JAX layout and are read through their strides (the
last axis contiguous), so the model's ``xh`` view of (B, S, H * P) is not
copied.  The bf16 kernel copies 16-byte chunks, so an x, B or C whose
address or strides are not a multiple of 16 bytes is copied to new
memory first, and a state size N that is no multiple of 8 is zero-padded
(the model's never are).  The tail past S is masked, not padded.

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
from repro_torch.kernels.flash_attention import _chunk_aligned

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
    """Launches the SSD kernel.  x: (B, S, H, P); dt: (B, S, H) f32
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
    cb = None
    pad = 0
    if x.dtype == torch.bfloat16:
        pad = -N % 8
        if pad:  # zero columns of B, C and the state add nothing
            Bm, Cm = (torch.nn.functional.pad(t, (0, pad)) for t in (Bm, Cm))
            if init_state is not None:
                init_state = torch.nn.functional.pad(init_state, (0, pad))
        x, Bm, Cm = (_chunk_aligned(t) for t in (x, Bm, Cm))
    else:
        cb = torch.empty((B_, G, -(-S // chunk), chunk, chunk),
                         dtype=torch.float32, device=x.device)
    h_out = torch.empty((B_, H, P, N + pad), dtype=torch.float32,
                        device=x.device)
    build.extension().ssd_fwd(x, dt, A, Bm, Cm, init_state, cb, y, h_out,
                              chunk)
    launches += 1
    if pad:
        h_out = h_out[..., :N].contiguous()
    return (y, h_out) if return_state else y
