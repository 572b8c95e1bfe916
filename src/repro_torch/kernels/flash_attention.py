"""Flash-attention forward: wrapper of ``csrc/flash_attention.cu`` (bound
in ``csrc/bindings.cpp``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(body ``_flash_kernel``).  Bound on the card: the larger of
``4 * B * Hq * Sq * Sk_valid * D`` FLOPs (about half under a causal mask)
over the tensor-core peak and the bytes of q, out and the K/V rows some
query can see over HBM rate;
at the yi-6b prefill shape the two are close (8.7 us and 11.3 us).  This
first kernel computes in f32 FMAs on the CUDA cores, far from either:
one thread block per (batch, q head, 64-row q tile), K/V tiles staged in
shared memory, GQA inside the kernel (kv head = h // G), and tiles that
no row of the q tile can see skipped.

q, k and v keep the JAX layout ``(B, S, H, D)`` and are read through
their strides (each needs a contiguous D axis), so the caller neither
transposes nor repeats K/V.

The plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`;
``kernels/ops.py`` sends CPU tensors there.  A row with no valid key
differs between the two (see the .cu source note); the serving path
never makes one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last reset (set to 0 to reset)

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         kv_len: Optional[int] = None,
                         sliding_window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launches the kernel.  q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D);
    one CUDA device, one dtype (bf16 or f32).  Returns (B, Sq, Hq, D)."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda takes one dtype, bf16 or "
                        f"f32; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"incompatible q{tuple(q.shape)} k{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention_cuda needs a contiguous D axis")
    kv_len = Sk if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    if not 0 <= kv_len <= Sk or q_offset < 0:
        raise ValueError(f"need 0 <= kv_len <= Sk and q_offset >= 0, got "
                         f"kv_len={kv_len}, Sk={Sk}, q_offset={q_offset}")
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    build.extension().flash_fwd(q, k, v, o, float(scale), bool(causal),
                                q_offset, kv_len, int(sliding_window))
    launches += 1
    return o

