"""AdamW: wrappers of the hand-written CUDA kernels ``csrc/adamw.cu``
(bound in ``csrc/bindings.cpp``), and the work each launch does.

The JAX package has no Pallas kernel here: its AdamW
(``repro/optim/adamw.py``) is jnp that XLA fuses.  The port's plain
version, ``repro_torch/optim/adamw.py``, runs it as chunked elementwise
passes, which on the card took a third of a yi-6b step.  These kernels
are bound by bytes (22 + 2 an element with bf16 params and gradients and
f32 moments) and read each byte once:

- ``norm_cuda``: one launch a leaf, its partial sums of squares (a fixed
  grid of ``norm_blocks(n)`` blocks, one f32 partial a block) into the
  leaf's row of a ``(leaves, PARTS)`` scratch (``new_parts``);
- ``norm_final_cuda``: one launch, every row summed in a fixed order into
  the leaves' sums, left on the device (the norm and the clip scale are
  taken from them in ``optim/adamw.py``, as the plain version takes
  them);
- ``update_cuda``: one launch a leaf, reading p, g, m and v once and
  writing p, m and v once, the gradient clipped by the scale read from
  device memory as it is read, rounded to its dtype as the reference
  rounds it, and not written back.

So a step launches 2 x leaves + 1 of these kernels.  The
bits of the norm depend only on the gradients and the leaves' sizes; the
update's on nothing but its element.  Dispatch, the plain versions and
the cost model's charges are in ``optim/adamw.py``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build

# kernel launches since the last reset (set to 0 to reset)
launches = 0  # the update, one a leaf
norm_launches = 0  # the norm: one a leaf, and the finalize

PARTS = 1024  # slots of a leaf's row of partials: its norm launch's most blocks
_VEC, _THREADS = 8, 256  # elements a thread takes at once; a block's threads
_DTYPES = (torch.float32, torch.bfloat16)


def norm_blocks(n: int) -> int:
    """Blocks of a leaf's norm launch: one a 256 vectors of 8, at most
    PARTS; a function of n alone, so the sum's bits are too."""
    vecs = -(-n // _VEC)
    return min(PARTS, max(1, -(-vecs // _THREADS)))


def norm_work(g: torch.Tensor) -> Tuple[float, int]:
    """(FLOPs, bytes) of one leaf's norm launch: a multiply and an add an
    element; g read once, the leaf's row of PARTS f32 partials written
    once."""
    return 2.0 * g.numel(), g.numel() * g.element_size() + 4 * PARTS


def final_work(leaves: int) -> Tuple[float, int]:
    """(FLOPs, bytes) of the finalize: each leaf's PARTS f32 partials read
    and added once, its f32 sum written once."""
    return float(leaves * PARTS), 4 * leaves * (PARTS + 1)


def update_work(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, *, clip: bool, decay: bool
                ) -> Tuple[float, int]:
    """(FLOPs, bytes) of one leaf's update: 14 FLOPs an element (the
    moments 7, the step 7, counting a division or a square root as one),
    one more for the clip and two for the decay; p, g, m and v read once,
    p, m and v written once."""
    n = p.numel()
    flops = (14 + (1 if clip else 0) + (2 if decay else 0)) * n
    return float(flops), n * (2 * p.element_size() + g.element_size()
                              + 2 * m.element_size() + 2 * v.element_size())


def _check_cuda(ts, name: str) -> None:
    dev = ts[0].device
    for t in ts:
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"{name} needs tensors on one CUDA device, got "
                             f"{[str(t.device) for t in ts]}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} takes bf16/f32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} updates contiguous tensors only")


def new_parts(leaves: List[torch.Tensor]) -> torch.Tensor:
    """The norm's scratch for these leaves: a (leaves, PARTS) f32 row a
    leaf, on their device."""
    return torch.empty((len(leaves), PARTS), dtype=torch.float32,
                       device=leaves[0].device)


def norm_cuda(g: torch.Tensor, parts: torch.Tensor, i: int) -> None:
    """Launches leaf ``i``'s norm into row ``i`` of ``parts``
    (``new_parts``)."""
    global norm_launches
    _check_cuda([g, parts], "norm_cuda")
    build.extension().adamw_norm(g, parts, i, norm_blocks(g.numel()))
    norm_launches += 1


def norm_final_cuda(parts: torch.Tensor) -> torch.Tensor:
    """Launches the finalize over every row of ``parts``; returns the
    (leaves,) f32 sums."""
    global norm_launches
    _check_cuda([parts], "norm_final_cuda")
    sums = torch.empty(parts.shape[0], dtype=torch.float32,
                       device=parts.device)
    build.extension().adamw_norm_final(parts, sums)
    norm_launches += 1
    return sums


def update_cuda(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, scale: Optional[torch.Tensor], *, lr: float,
                b1: float, b2: float, eps: float, weight_decay: float,
                c1: float, c2: float, decay: bool) -> None:
    """Launches one leaf's update, IN PLACE on p, m and v.  p, g: bf16 or
    f32; m, v: both bf16 or both f32; all contiguous, of one shape, on one
    CUDA device.  ``scale``: the 0-d f32 clip scale (device memory), or
    None for no clip.  ``decay``: apply the decoupled weight decay.  The
    scalars reach the kernel as f32, as PyTorch casts a Python scalar of
    an f32 op."""
    global launches
    _check_cuda([p, g, m, v] + ([scale] if scale is not None else []),
                "update_cuda")
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"update_cuda: shapes {tuple(p.shape)}, "
                         f"{tuple(g.shape)}, {tuple(m.shape)}, "
                         f"{tuple(v.shape)}")
    if m.dtype != v.dtype:
        raise TypeError(f"update_cuda: m is {m.dtype} but v {v.dtype}")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.numel() != 1):
        raise ValueError("update_cuda: scale must be one f32 value")
    build.extension().adamw_update(
        p, g, m, v, scale, float(lr), float(lr * weight_decay), bool(decay),
        float(b1), float(1 - b1), float(b2), float(1 - b2), float(c1),
        float(c2), float(eps))
    launches += 1
