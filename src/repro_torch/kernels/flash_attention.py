"""Flash attention: wrappers of the hand-written CUDA kernels
``csrc/flash_attention.cu`` (bound in ``csrc/bindings.cpp``) and the
autograd Function around them.

The forward replaces ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (body ``_flash_kernel``); the backward is the twin
of ``repro/kernels/ref.py::_flash_bwd_inner``, which the JAX package runs
in jnp.  Bound on the card: the larger of the FLOPs of the visible
(query, key) pairs over the tensor-core peak and the bytes of the inputs
and outputs over HBM rate; at the yi-6b shapes the two are close.  The
bf16 forward runs S = Q K^T and O += P V on the tensor cores
(``mma.sync`` from swizzled bf16 tiles that a double-buffered
``cp.async`` ring fills, the online softmax on the f32 fragments, P
rounded to bf16 in registers): one block of 4 warps per (batch, q head,
64-row q tile), GQA inside the kernel (kv head = h // G), key steps that
no row can see skipped.  The f32 forward computes in f32 FMAs on the
CUDA cores with the same split.  The bf16 backward runs its five
products on the tensor cores (``mma.sync`` from swizzled bf16 tiles, f32
sums): for dk and dv a cluster of blocks per (batch, kv head, 64-key
tile), one block per q head where G <= 8, summed through distributed
shared memory; for dq one block per (batch, q head, 64-row q tile).  The
f32 backward runs f32 FMAs on the CUDA cores (the f32 sweeps' 3e-5
tolerance rules out TF32).

q, k and v keep the JAX layout ``(B, S, H, D)`` and are read through
their strides (each needs a contiguous D axis), so the caller neither
transposes nor repeats K/V.  The bf16 kernels copy their tensors by
16-byte chunks, so they take a contiguous copy of any input whose address
or strides are not a multiple of 16 bytes (the model's never are).

The plain versions are :func:`repro_torch.kernels.ref.
flash_attention_fwd_ref` and :func:`~repro_torch.kernels.ref.
flash_attention_bwd_ref`; ``kernels/ops.py`` sends CPU tensors there.  A
row with no valid key differs between kernel and plain version (see the
.cu source note); the serving and training paths never make one.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meter
from repro_torch.kernels import ref

# kernel launches since the last reset (set to 0 to reset)
launches = 0  # forward
bwd_launches = 0  # backward (one count per call of its kernels)

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=256)
def visible(Sq: int, Sk: int, *, causal: bool = True, q_offset: int = 0,
            kv_len: Optional[int] = None,
            sliding_window: int = 0) -> Tuple[int, int]:
    """(pairs, keys): the (query, key) pairs the masks leave visible, and
    the key rows at least one query sees.  Query i sits at position
    ``q_offset + i``; key j is visible when j < kv_len, j <= that position
    (causal) and j > that position - window (sliding window).  Plain
    Python, so that a cost counter sees no tensor op of its own."""
    kv_len = Sk if kv_len is None else int(kv_len)
    pairs = keys = 0
    top = -1  # the last key row counted
    for pos in range(int(q_offset), int(q_offset) + Sq):
        lo = max(pos - sliding_window + 1, 0) if sliding_window else 0
        hi = min(pos, kv_len - 1) if causal else kv_len - 1
        if hi < lo:
            continue
        pairs += hi - lo + 1
        # lo and hi never fall as pos grows: the rows' union grows at the top
        keys += max(hi - max(lo, top + 1) + 1, 0)
        top = max(top, hi)
    return pairs, keys


def _work(q, k, mask: dict, reads: int, flops_per_pair: float,
          lse: bool) -> Tuple[float, int]:
    B, Sq, Hq, D = q.shape
    pairs, keys = visible(Sq, k.shape[1], **mask)
    n_bytes = (reads * q.numel() + reads * B * keys * k.shape[2] * D) \
        * q.element_size() + (4 * B * Sq * Hq if lse else 0)
    return flops_per_pair * B * Hq * pairs * D, n_bytes


def work(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
         q_offset: int = 0, kv_len: Optional[int] = None,
         sliding_window: int = 0, lse: bool = False) -> Tuple[float, int]:
    """(FLOPs, bytes) of one forward: 4 FLOPs a visible (query, key) pair
    and head dimension (Q Kᵀ and P V); q read and o written once, K and V
    read once over the key rows some query sees, and with ``lse`` the f32
    statistic written."""
    return _work(q, k, dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                            sliding_window=sliding_window), 2, 4.0, lse)


def bwd_work(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
             q_offset: int = 0, kv_len: Optional[int] = None,
             sliding_window: int = 0) -> Tuple[float, int]:
    """(FLOPs, bytes) of one backward: 10 FLOPs a visible pair and head
    dimension (Q Kᵀ recomputed, dP, dV, dQ, dK); q, o, dout read and dq
    written, K, V read and dk, dv written over the key rows some query
    sees, and the f32 ``lse`` read once."""
    return _work(q, k, dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                            sliding_window=sliding_window), 4, 10.0, True)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str,
           kv_len: Optional[int], q_offset: int) -> int:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes one dtype, bf16 or f32; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
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
        raise ValueError(f"{name} needs a contiguous D axis")
    kv_len = Sk if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Sk or q_offset < 0:
        raise ValueError(f"need 0 <= kv_len <= Sk and q_offset >= 0, got "
                         f"kv_len={kv_len}, Sk={Sk}, q_offset={q_offset}")
    return kv_len


def _chunk_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its address and its strides but the last are
    multiples of 16 bytes, else a contiguous copy in new memory (which is:
    ``contiguous()`` would hand back a contiguous view that is not)."""
    step = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(s % step == 0
                                      for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         kv_len: Optional[int] = None,
                         sliding_window: int = 0,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launches the forward kernel.  q: (B, Sq, Hq, D); k, v: (B, Sk,
    Hkv, D); one CUDA device, one dtype (bf16 or f32).  Returns the
    (B, Sq, Hq, D) output and, with ``return_lse``, the f32 (B, Sq, Hq)
    statistic ``lse = m + log(max(l, 1e-30))`` the backward reads."""
    global launches
    q_offset = int(q_offset)
    kv_len = _check(q, k, v, "flash_attention_cuda", kv_len, q_offset)
    B, Sq, Hq, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.dtype == torch.bfloat16:
        q, k, v = (_chunk_aligned(t) for t in (q, k, v))
    if o.numel():
        build.extension().flash_fwd(q, k, v, o, lse, float(scale),
                                    bool(causal), q_offset, kv_len,
                                    int(sliding_window))
        launches += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, q_offset: int = 0,
                             kv_len: Optional[int] = None,
                             sliding_window: int = 0,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launches the backward kernels.  q, k, v as for the forward; o and
    lse the forward's outputs (contiguous); dout the cotangent of o
    (contiguous, q's dtype).  Returns (dq, dk, dv), contiguous, in q's
    dtype; dk and dv are summed over the G q heads of each kv head."""
    global bwd_launches
    q_offset = int(q_offset)
    kv_len = _check(q, k, v, "flash_attention_bwd_cuda", kv_len, q_offset)
    B, Sq, Hq, D = q.shape
    for name, t, dt, shape in (("o", o, q.dtype, q.shape),
                               ("dout", dout, q.dtype, q.shape),
                               ("lse", lse, torch.float32, q.shape[:3])):
        if (t.shape != shape or t.dtype != dt or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name} must be contiguous {tuple(shape)} {dt} "
                             f"on {q.device}, got {tuple(t.shape)} {t.dtype}")
    scale = scale if scale is not None else D ** -0.5
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if q.dtype == torch.bfloat16:
        q, k, v, dout = (_chunk_aligned(t) for t in (q, k, v, dout))
    delta = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    build.extension().flash_bwd(q, k, v, o, lse, dout, delta, dq, dk, dv,
                                float(scale), bool(causal), q_offset, kv_len,
                                int(sliding_window))
    bwd_launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the O(S) custom backward of
    ``repro/kernels/ref.py::_flash_vjp_factory``: the forward saves q, k,
    v, out and the f32 ``lse``; the backward recomputes p from them.
    Under activation checkpointing the recomputed forward saves the
    recomputed ``lse``.  ``kernel`` selects the CUDA kernels, else the
    plain versions (``opts`` carries ``block_k`` for those)."""

    @staticmethod
    def forward(ctx, q, k, v, kernel: bool, opts: dict):
        if kernel:
            out, lse = flash_attention_cuda(
                q, k, v, causal=opts["causal"], q_offset=opts["q_offset"],
                kv_len=opts["kv_len"],
                sliding_window=opts["sliding_window"],
                scale=opts.get("scale"), return_lse=True)
        else:
            out, lse = ref.flash_attention_fwd_ref(q, k, v, **opts)
        ctx.kernel, ctx.opts = kernel, opts
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        opts = ctx.opts
        mask = {key: opts[key] for key in ("causal", "q_offset", "kv_len",
                                           "sliding_window")}
        with meter.charge("flash_attention_bwd",
                          lambda: bwd_work(q, k, **mask)):
            if ctx.kernel:
                dq, dk, dv = flash_attention_bwd_cuda(
                    q, k, v, out, lse, dout, scale=opts.get("scale"), **mask)
            else:
                dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse,
                                                         dout, **opts)
        return dq, dk, dv, None, None
