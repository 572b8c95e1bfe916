"""Vocab-blockwise cross-entropy forward: wrapper of the hand-written CUDA
kernel ``csrc/cross_entropy.cu`` (bound in ``csrc/bindings.cpp``).

Replaces ``repro/kernels/cross_entropy.py::cross_entropy_pallas`` (body
``_ce_kernel``): the ``hidden @ w_vocabᵀ`` product fused with an online
(max, sumexp, target logit) reduction over vocab tiles, so the (T, V)
logits never reach device memory.  Bound on the card: operations
(``2 * T * V * D`` FLOPs over the peak of the input type).  bf16 inputs
(the training path) run on the tensor cores (``wgmma`` from swizzled
bf16 tiles, f32 sums): one block per (128-token tile, vocab split), 256
vocab entries a tile; f32 inputs run f32 FMAs on the CUDA cores.  A
second kernel merges the splits' statistics.  The bf16 kernel copies
16-byte chunks, so for a ``D`` that is not a multiple of 8 (or a
misaligned tensor) the wrapper zero-pads ``D`` in a copy; zero columns
add nothing to the logits.

The plain version is :func:`repro_torch.kernels.ref.
cross_entropy_stats_ref`; ``kernels/ops.py`` and ``train/loss.py`` send
CPU tensors there.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last reset (set to 0 to reset)

_DTYPES = (torch.float32, torch.bfloat16)


def work(hidden: torch.Tensor, w_vocab: torch.Tensor) -> Tuple[float, int]:
    """(FLOPs, bytes) of one call: the ``2 T V D`` of the logits; hidden
    and w_vocab read once, the int64 targets read and the f32 nll and lse
    written once."""
    T, D = hidden.shape
    V = w_vocab.shape[0]
    return 2.0 * T * V * D, (T + V) * D * hidden.element_size() + 16 * T


def cross_entropy_cuda(hidden: torch.Tensor, w_vocab: torch.Tensor,
                       targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches the kernel.  hidden: (T, D), w_vocab: (V, D), contiguous,
    one dtype (bf16 or f32), products summed in f32; targets: (T,)
    integer ids in [0, V).  Returns per-token f32 (nll, lse)."""
    global launches
    if not (hidden.is_cuda and w_vocab.device == hidden.device
            and targets.device == hidden.device):
        raise ValueError("cross_entropy_cuda needs hidden, w_vocab and "
                         f"targets on one CUDA device, got {hidden.device}, "
                         f"{w_vocab.device}, {targets.device}")
    if hidden.dtype not in _DTYPES or w_vocab.dtype != hidden.dtype:
        raise TypeError("cross_entropy_cuda takes one dtype, bf16 or f32; "
                        f"got {hidden.dtype}, {w_vocab.dtype}")
    if (hidden.dim() != 2 or w_vocab.dim() != 2
            or w_vocab.shape[1] != hidden.shape[1]
            or targets.shape != hidden.shape[:1]):
        raise ValueError(f"bad shapes hidden{tuple(hidden.shape)} "
                         f"w_vocab{tuple(w_vocab.shape)} "
                         f"targets{tuple(targets.shape)}")
    if not (hidden.is_contiguous() and w_vocab.is_contiguous()):
        raise ValueError("cross_entropy_cuda needs contiguous hidden and "
                         "w_vocab")
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise TypeError(f"targets must be integer ids, got {targets.dtype}")
    T, D = hidden.shape
    V = w_vocab.shape[0]
    nll = torch.empty((T,), dtype=torch.float32, device=hidden.device)
    lse = torch.empty((T,), dtype=torch.float32, device=hidden.device)
    if T == 0:
        return nll, lse
    if V == 0 or D == 0:
        raise ValueError("cross_entropy_cuda needs V > 0 and D > 0")
    bf16 = hidden.dtype == torch.bfloat16
    if bf16 and (D % 8 or hidden.data_ptr() % 16 or w_vocab.data_ptr() % 16):
        pad = -D % 8
        hidden = torch.nn.functional.pad(hidden, (0, pad))
        w_vocab = torch.nn.functional.pad(w_vocab, (0, pad))
    ext = build.extension()
    part = torch.empty((ext.ce_splits(T, V, bf16), T, 3),
                       dtype=torch.float32, device=hidden.device)
    ext.ce_fwd(hidden, w_vocab, targets.to(torch.int64).contiguous(), part,
               nll, lse)
    launches += 1
    return nll, lse
