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
(the model's never are).  A head dim P that is no multiple of 8 (a rank's
block of the SSD head dim under a ``model`` split: mamba2-130m's P 64 over
16 ranks is 4) is zero-padded to one, forward and backward, and the
results cut back: the channels of P are independent, so the padding adds
exact zeros.  The tail past S is masked, not padded.

The backward, :func:`ssd_bwd_cuda`, is the twin of autodiff of
``repro/kernels/ref.py::ssd_ref`` (the JAX package trains through jnp, no
Pallas).  bf16 (the models' path) runs on the tensor cores in five
launches: two state passes of the forward's tiling write the state
before each chunk and the cotangent after it (as hi and lo bf16 copies),
a row kernel and a column kernel over (chunk, block of heads, batch)
form the chunk's causal products and dx, dC, dB and ddt, summing dB and
dC over the block's heads in registers, and a last kernel sums the few
partials of a group and dA in a fixed order.  It takes x, B, C and dy
as the forward does (16-byte copies: misaligned ones are copied, N is
zero-padded to a multiple of 8) and P <= 64.  f32 runs on the CUDA
cores in four launches (per-head partials of dB and dC), element by
element through the strides, so it takes any N, P and alignment.  No
float atomics: every output's bits are fixed (see the source notes).

:class:`SSDFn` is the autograd Function around the scan: its backward
is the kernel on the kernel path, :func:`repro_torch.kernels.ref.
ssd_bwd_ref` on the plain path.  The plain forward is
:func:`repro_torch.kernels.ref.ssd_ref`; ``kernels/ops.py`` sends CPU
tensors to the plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import meter
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import _chunk_aligned

# kernel launches since the last reset (set to 0 to reset)
launches = 0  # forward
bwd_launches = 0  # backward (one count per call of its kernels)

MAX_CHUNK = 128
MAX_STATE = 128
_DTYPES = (torch.float32, torch.bfloat16)


def _causal_pairs(S: int, chunk: int) -> int:
    """The causal (i, j) pairs inside the chunks of a sequence of S."""
    return sum(q * (q + 1) // 2 for q in
               [chunk] * (S // chunk) + ([S % chunk] if S % chunk else []))


def work(x: torch.Tensor, Bm: torch.Tensor, *, chunk: int = 128,
         init_state: bool = False) -> Tuple[float, int]:
    """(FLOPs, bytes) of one scan: x, dt, B and C read once, y and the
    final state written once (and with ``init_state`` the initial state
    read); C Bᵀ once per group over the causal (i, j) pairs of each
    chunk, the intra-chunk product over those pairs, the inter-chunk
    output and the state update."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xb = x.element_size()
    pairs = _causal_pairs(S, chunk)
    n_bytes = (2 * B * S * H * P * xb + 4 * B * S * H + 2 * B * S * G * N * xb
               + 4 * B * H * P * N * (2 if init_state else 1))
    flops = (2.0 * B * G * pairs * N + 2.0 * B * H * pairs * P
             + 4.0 * B * H * S * N * P)
    return flops, n_bytes


def bwd_work(x: torch.Tensor, Bm: torch.Tensor, *,
             chunk: int = 128) -> Tuple[float, int]:
    """(FLOPs, bytes) of one backward, counted as :func:`work` counts: x,
    dy, dt, B and C read once, dx, ddt, dB and dC written once (no initial
    state, as in training); C Bᵀ once per group and dy xᵀ per head over
    the causal pairs, the three products of the pairs with dy, B and C
    (dx, dC, dB), and five of S x N x P per head: the states recomputed
    forward and backward and the inter-chunk terms of dx, dC and dB."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    xb = x.element_size()
    pairs = _causal_pairs(S, chunk)
    n_bytes = (3 * B * S * H * P * xb + 2 * 4 * B * S * H
               + 4 * B * S * G * N * xb)
    flops = (2.0 * B * G * pairs * N + 2.0 * B * H * pairs * (2 * P + 2 * N)
             + 10.0 * B * H * S * N * P)
    return flops, n_bytes


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
    if not P or not 0 < N <= MAX_STATE or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_cuda takes P > 0, N <= {MAX_STATE} and "
                         f"chunk <= {MAX_CHUNK}; got P={P}, N={N}, "
                         f"chunk={chunk}")
    if any(t.stride(-1) != 1 for t in (x, dt, Bm, Cm)) or \
            not A.is_contiguous():
        raise ValueError("ssd_cuda needs a contiguous last axis")
    if init_state is not None and (init_state.shape != (B_, H, P, N)
                                   or not init_state.is_contiguous()):
        raise ValueError(f"init_state must be contiguous {(B_, H, P, N)}, "
                         f"got {tuple(init_state.shape)}")


def _pad_p(t: Optional[torch.Tensor], pad: int, dim: int
           ) -> Optional[torch.Tensor]:
    """``t`` zero-padded by ``pad`` along its P axis ``dim`` (a copy)."""
    if t is None or not pad:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 1 - dim % t.dim()) + (0, pad))


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
    P = x.shape[3]
    pad_p = -P % 8
    x, init_state = _pad_p(x, pad_p, 3), _pad_p(init_state, pad_p, 2)
    B_, S, H, Pp = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((B_, S, H, Pp), dtype=x.dtype, device=x.device)
    cb = None
    pad = 0
    if x.dtype == torch.bfloat16:
        pad = -N % 8
        if pad:  # zero columns of B, C and the state add nothing
            Bm, Cm = (F.pad(t, (0, pad)) for t in (Bm, Cm))
            if init_state is not None:
                init_state = F.pad(init_state, (0, pad))
        x, Bm, Cm = (_chunk_aligned(t) for t in (x, Bm, Cm))
    else:
        cb = torch.empty((B_, G, -(-S // chunk), chunk, chunk),
                         dtype=torch.float32, device=x.device)
    h_out = torch.empty((B_, H, Pp, N + pad), dtype=torch.float32,
                        device=x.device)
    build.extension().ssd_fwd(x, dt, A, Bm, Cm, init_state, cb, y, h_out,
                              chunk)
    launches += 1
    if pad or pad_p:
        h_out = h_out[:, :, :P, :N].contiguous()
    if pad_p:
        y = y[..., :P].contiguous()
    return (y, h_out) if return_state else y


def _bwd_scratch(B_: int, S: int, H: int, P: int, G: int, N: int,
                 chunk: int, dtype: torch.dtype, device):
    """The backward's scratch, in the order ``ssd_bwd`` takes it: hs, gs,
    db_part, dc_part, da_part, wpart, rvec, dvec.  bf16 (N padded to a
    multiple of 8): the states before each chunk and the cotangents after
    it as hi and lo bf16 copies, the partials of dB and dC one a block of
    heads (``ssd_bwd_slots`` a group), dA's a chunk, w a chunk and the row
    kernel's two vectors a head.  f32: the states and cotangents in f32,
    the partials of dB and dC one a head, dA's; no wpart, rvec, dvec."""
    n_c = -(-S // chunk)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    if dtype == torch.bfloat16:
        hs, gs = (torch.empty((B_, H, n_c, 2, P, N), dtype=torch.bfloat16,
                              device=device) for _ in range(2))
        parts = G * build.extension().ssd_bwd_slots(B_, S, H, G, N, chunk)
        vecs = (f32(B_, H, n_c), f32(B_, H, S), f32(B_, H, S))
    else:
        hs, gs = f32(B_, H, n_c, P, N), f32(B_, H, n_c, P, N)
        parts, vecs = H, (None, None, None)
    return (hs, gs, f32(B_, S, parts, N), f32(B_, S, parts, N),
            f32(B_, H, n_c)) + vecs


def bwd_scratch_bytes(B_: int, S: int, H: int, P: int, G: int, N: int,
                      chunk: int, dtype: torch.dtype) -> int:
    """Bytes of scratch one :func:`ssd_bwd_cuda` call at this shape
    allocates (bf16 asks the kernels for their partials a group)."""
    if dtype == torch.bfloat16:
        N += -N % 8
    return sum(t.numel() * t.element_size() for t in _bwd_scratch(
        B_, S, H, P, G, N, chunk, dtype, "meta") if t is not None)


def ssd_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 128, init_state: Optional[torch.Tensor] = None,
                 d_state: Optional[torch.Tensor] = None):
    """Launches the SSD backward kernels.  The inputs of :func:`ssd_cuda`,
    dy (the cotangent of y, x's shape and dtype) and d_state (the f32
    cotangent of the final state, or None: zero).  Returns (dx, ddt, dA,
    dB, dC, d_init) as :func:`repro_torch.kernels.ref.ssd_bwd_ref` does:
    dx, dB, dC in the inputs' dtype, ddt, dA and d_init f32."""
    global bwd_launches
    chunk = int(chunk)
    _check(x, dt, A, Bm, Cm, init_state, chunk)
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous()):
        raise ValueError(f"dy must be contiguous {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}, got {tuple(dy.shape)} {dy.dtype}")
    if d_state is not None and (
            d_state.shape != (B_, H, P, N) or d_state.dtype != torch.float32
            or d_state.device != x.device or not d_state.is_contiguous()):
        raise ValueError(f"d_state must be contiguous f32 {(B_, H, P, N)}, "
                         f"got {tuple(d_state.shape)} {d_state.dtype}")
    dev = x.device
    pad_p = -P % 8
    x, dy = _pad_p(x, pad_p, 3), _pad_p(dy, pad_p, 3)
    init_state, d_state = (_pad_p(t, pad_p, 2) for t in (init_state, d_state))
    P += pad_p
    pad = 0
    if x.dtype == torch.bfloat16:
        # the tensor-core kernels copy 16-byte chunks, as ssd_cuda's do
        pad = -N % 8
        if pad:  # zero columns of B, C and the states add nothing
            Bm, Cm = (F.pad(t, (0, pad)) for t in (Bm, Cm))
            init_state, d_state = (None if t is None else F.pad(t, (0, pad))
                                   for t in (init_state, d_state))
        x, Bm, Cm, dy = (_chunk_aligned(t) for t in (x, Bm, Cm, dy))
    scratch = _bwd_scratch(B_, S, H, P, G, N + pad, chunk, x.dtype, dev)
    dx = torch.empty((B_, S, H, P), dtype=x.dtype, device=dev)
    dB = torch.empty((B_, S, G, N + pad), dtype=Bm.dtype, device=dev)
    dC = torch.empty_like(dB)
    ddt, dA, d_init = (torch.empty(shape, dtype=torch.float32, device=dev)
                       for shape in ((B_, S, H), (H,), (B_, H, P, N + pad)))
    build.extension().ssd_bwd(x, dt, A, Bm, Cm, init_state, dy, d_state,
                              *scratch, dx, ddt, dA, dB, dC, d_init, chunk)
    bwd_launches += 1
    if pad:
        dB, dC = (t[..., :N].contiguous() for t in (dB, dC))
    if pad or pad_p:
        d_init = d_init[:, :, :P - pad_p, :N].contiguous()
    if pad_p:
        dx = dx[..., :P - pad_p].contiguous()
    return dx, ddt, dA, dB, dC, d_init


class SSDFn(torch.autograd.Function):
    """(y, final state) = ssd(x, dt, A, B, C, init_state) with the backward
    of autodiff of ``ssd_ref``: the forward saves its inputs, the backward
    recomputes the chunk states from them.  ``kernel`` selects the CUDA
    kernels, else the plain versions.  Unused outputs get no cotangent
    (a missing y cotangent is zero, a missing state cotangent seeds
    nothing)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk: int,
                kernel: bool):
        if kernel:
            y, h = ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state, return_state=True)
        else:
            y, h = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk,
                               init_state=init_state, return_state=True)
        ctx.chunk, ctx.kernel = chunk, kernel
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        return y, h

    @staticmethod
    def backward(ctx, dy, d_state):
        x, dt, A, Bm, Cm, init_state = ctx.saved_tensors
        dy = (torch.zeros_like(x) if dy is None
              else dy.to(x.dtype).contiguous())
        if d_state is not None:
            d_state = d_state.float().contiguous()
        bwd = ssd_bwd_cuda if ctx.kernel else ref.ssd_bwd_ref
        with meter.charge("ssd_scan_bwd",
                          lambda: bwd_work(x, Bm, chunk=ctx.chunk)):
            dx, ddt, dA, dB, dC, d_init = bwd(
                x, dt, A, Bm, Cm, dy, chunk=ctx.chunk, init_state=init_state,
                d_state=d_state)
        return (dx, ddt, dA, dB, dC,
                None if init_state is None else d_init, None, None)
