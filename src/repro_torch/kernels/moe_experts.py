"""The dropless MoE's grouped expert products: the wrapper of the
hand-written CUDA kernels ``csrc/moe_experts.cu`` (bound in
``csrc/bindings.cpp``), their plain twin, and the work a call does.

No TPU kernel computes this: the JAX package's MoE puts each expert's
rows into a capacity slot grid and leaves the products to XLA.  The
port's ``granite_hybrid`` family routes 72 experts top 10 without
dropping a pair, where a slot grid would compute every token's slot for
each expert (7.2x the routed rows at E / K).  So the (token, k) pairs
are sorted by expert (``layers.moe_sort``) and each expert multiplies
exactly its rows:

- ``moe_experts_cuda``: two launches, the gate and up products of every
  expert's rows (X gathered by the sorted pairs' tokens, SiLU(gate) * up
  in the epilogue) into H, then H's down product into Y, one row a pair
  in the sorted order.  ``decode=True`` launches the same code under the
  decode kernels' names, so that a trace tells prefill's launches from
  decode's;
- ``moe_experts_ref``: the plain twin, a loop of per-expert ``@`` over
  the routed rows (the CPU path; it reads the offsets on the host).

Bound at prefill (T tokens, K of E experts, d, f): 6 T K d f FLOPs
against every expert's 3 d f weights, X's routed rows, H written and
read and Y written once: at 16 x 4096 tokens of granite-4.0-h-small
(d 4096, f 768, 72 experts top 10) 12.4 TFLOP (12.5 ms at the bf16
peak) against 13.5 GB (4.0 ms): the tensor cores.  At decode (16
tokens) every expert's weights (1.36 GB a layer) bound it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# kernel launches since the last reset (set to 0 to reset): two a call,
# prefill's and decode's alike
launches = 0


def work(x: torch.Tensor, pairs: int,
         w_gate: torch.Tensor) -> Tuple[float, int]:
    """(FLOPs, bytes) of one call over ``pairs`` routed rows of ``x`` (T,
    d) with experts (E, d, f): 6 d f FLOPs a row; every expert (or as
    many as there are rows) reads its gate, up and down weights once,
    X's routed rows are read once, H (pairs, f) is written and read once
    and Y (pairs, d) written once."""
    E, d, f = w_gate.shape
    el = x.element_size()
    hit = min(E, pairs)
    return (6.0 * pairs * d * f,
            el * (3 * hit * d * f + pairs * d + 2 * pairs * f + pairs * d))


def moe_experts_ref(x: torch.Tensor, token: torch.Tensor,
                    offsets: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor
                    ) -> torch.Tensor:
    """Y (pairs, d): sorted pair j of expert e gives silu(x[token[j]] @
    w_gate[e]) * (x[token[j]] @ w_up[e]) @ w_down[e], in x's dtype."""
    y = x.new_empty((token.numel(), x.shape[1]))
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        if hi == lo:
            continue
        xe = x[token[lo:hi].long()]
        h = F.silu(xe @ w_gate[e]) * (xe @ w_up[e])
        y[lo:hi] = h @ w_down[e]
    return y


def _check(x, token, offsets, w_gate, w_up, w_down) -> None:
    ts = (x, token, offsets, w_gate, w_up, w_down)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("moe_experts_cuda needs every tensor on one CUDA "
                         "device")
    if not all(t.dtype == torch.bfloat16 for t in (x, w_gate, w_up,
                                                    w_down)):
        raise TypeError("moe_experts_cuda takes bf16 x and weights")
    if token.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError("token and offsets must be int32")
    E, d, f = w_gate.shape
    if (x.dim() != 2 or x.shape[1] != d or w_up.shape != (E, d, f)
            or w_down.shape != (E, f, d) or offsets.shape != (E + 1,)
            or token.dim() != 1):
        raise ValueError(f"bad shapes x{tuple(x.shape)} w_gate"
                         f"{tuple(w_gate.shape)} w_up{tuple(w_up.shape)} "
                         f"w_down{tuple(w_down.shape)} offsets"
                         f"{tuple(offsets.shape)}")
    if d % 256 or f % 128:
        raise ValueError(f"d {d} must divide by 256 and f {f} by 128")
    if not (x.stride(1) == 1 and x.stride(0) % 8 == 0
            and x.data_ptr() % 16 == 0):
        raise ValueError("x needs contiguous 16-byte aligned rows")
    for t in (token, offsets, w_gate, w_up, w_down):
        if not t.is_contiguous():
            raise ValueError("token, offsets and the weights must be "
                             "contiguous")


def moe_experts_cuda(x: torch.Tensor, token: torch.Tensor,
                     offsets: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor,
                     decode: bool = False) -> torch.Tensor:
    """Launches the two kernels; returns Y (pairs, d) bf16.  x (T, d);
    token (pairs,) int32, the token of each pair sorted by expert;
    offsets (E + 1,) int32 on the device, expert e's pairs at rows
    offsets[e] .. offsets[e + 1] - 1; weights (E, d, f), (E, d, f),
    (E, f, d).  Nothing is read back to the host."""
    global launches
    _check(x, token, offsets, w_gate, w_up, w_down)
    P = token.numel()
    E, d, f = w_gate.shape
    h = torch.empty((P, f), dtype=x.dtype, device=x.device)
    y = torch.empty((P, d), dtype=x.dtype, device=x.device)
    if P:
        build.extension().moe_experts(x, token, offsets, w_gate, w_up,
                                      w_down, h, y, bool(decode))
        launches += 2
    return y
