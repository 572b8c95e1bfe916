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
second kernel merges the splits' statistics.  On a vocab shard (the LM
head split over ``model``) the kernel returns the merged (m, l, target
logit) triple of each token instead (``cross_entropy_stats_cuda``: the
targets shifted by the shard's first id, so a target in another shard
adds nothing), and the merge kernel, given the ranks' triples gathered,
merges them into nll and lse (``ce_merge_cuda``).  The bf16 kernel copies
16-byte chunks, so for a ``D`` that is not a multiple of 8 (or a
misaligned tensor) the wrapper zero-pads ``D`` in a copy; zero columns
add nothing to the logits.

The plain versions are :func:`repro_torch.kernels.ref.
cross_entropy_stats_ref`, ``cross_entropy_partial_ref`` and
``ce_merge_ref``; ``kernels/ops.py`` and ``train/loss.py`` send CPU
tensors there.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last reset (set to 0 to reset)
merge_launches = 0  # launches of the cross-shard merge (``ce_merge_cuda``)

_DTYPES = (torch.float32, torch.bfloat16)


def work(hidden: torch.Tensor, w_vocab: torch.Tensor,
         stats: bool = False) -> Tuple[float, int]:
    """(FLOPs, bytes) of one call: the ``2 T V D`` of the logits; hidden
    and w_vocab read once, the int64 targets read and the f32 outputs
    written once: nll and lse, or with ``stats`` a shard's (m, l, target
    logit) triples."""
    T, D = hidden.shape
    V = w_vocab.shape[0]
    out = 12 * T if stats else 8 * T
    return 2.0 * T * V * D, (T + V) * D * hidden.element_size() + 8 * T + out


def merge_work(parts: torch.Tensor) -> Tuple[float, int]:
    """(FLOPs, bytes) of one merge of n shards' (T, 3) f32 triples: the
    triples read once, nll and lse written once; an exp, a product and
    two sums a shard and token, and the log."""
    n, T = parts.shape[0], parts.shape[1]
    return 5.0 * n * T + 3.0 * T, 4 * (3 * n * T + 2 * T)


def _checked(hidden: torch.Tensor, w_vocab: torch.Tensor,
             targets: torch.Tensor, name: str):
    """The inputs as the kernel takes them: bf16 ``D`` zero-padded to a
    multiple of 8 (or a misaligned tensor copied), int64 targets."""
    if not (hidden.is_cuda and w_vocab.device == hidden.device
            and targets.device == hidden.device):
        raise ValueError(f"{name} needs hidden, w_vocab and targets on one "
                         f"CUDA device, got {hidden.device}, "
                         f"{w_vocab.device}, {targets.device}")
    if hidden.dtype not in _DTYPES or w_vocab.dtype != hidden.dtype:
        raise TypeError(f"{name} takes one dtype, bf16 or f32; got "
                        f"{hidden.dtype}, {w_vocab.dtype}")
    if (hidden.dim() != 2 or w_vocab.dim() != 2
            or w_vocab.shape[1] != hidden.shape[1]
            or targets.shape != hidden.shape[:1]):
        raise ValueError(f"bad shapes hidden{tuple(hidden.shape)} "
                         f"w_vocab{tuple(w_vocab.shape)} "
                         f"targets{tuple(targets.shape)}")
    if not (hidden.is_contiguous() and w_vocab.is_contiguous()):
        raise ValueError(f"{name} needs contiguous hidden and w_vocab")
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise TypeError(f"targets must be integer ids, got {targets.dtype}")
    if hidden.shape[0] and (w_vocab.shape[0] == 0 or hidden.shape[1] == 0):
        raise ValueError(f"{name} needs V > 0 and D > 0")
    D = hidden.shape[1]
    if hidden.dtype == torch.bfloat16 and (
            D % 8 or hidden.data_ptr() % 16 or w_vocab.data_ptr() % 16):
        pad = -D % 8
        hidden = torch.nn.functional.pad(hidden, (0, pad))
        w_vocab = torch.nn.functional.pad(w_vocab, (0, pad))
    return hidden, w_vocab, targets.to(torch.int64).contiguous()


def _scratch(ext, hidden: torch.Tensor, V: int) -> torch.Tensor:
    T = hidden.shape[0]
    bf16 = hidden.dtype == torch.bfloat16
    return torch.empty((ext.ce_splits(T, V, bf16), T, 3),
                       dtype=torch.float32, device=hidden.device)


def cross_entropy_cuda(hidden: torch.Tensor, w_vocab: torch.Tensor,
                       targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches the kernel.  hidden: (T, D), w_vocab: (V, D), contiguous,
    one dtype (bf16 or f32), products summed in f32; targets: (T,)
    integer ids (one outside [0, V) adds nothing to the target logit).
    Returns per-token f32 (nll, lse)."""
    global launches
    hidden, w_vocab, targets = _checked(hidden, w_vocab, targets,
                                        "cross_entropy_cuda")
    T = hidden.shape[0]
    nll = torch.empty((T,), dtype=torch.float32, device=hidden.device)
    lse = torch.empty((T,), dtype=torch.float32, device=hidden.device)
    if T == 0:
        return nll, lse
    ext = build.extension()
    ext.ce_fwd(hidden, w_vocab, targets, _scratch(ext, hidden,
                                                  w_vocab.shape[0]),
               nll, lse)
    launches += 1
    return nll, lse


def cross_entropy_stats_cuda(hidden: torch.Tensor, w_vocab: torch.Tensor,
                             targets: torch.Tensor) -> torch.Tensor:
    """The kernel on one vocab shard: ``w_vocab`` holds the shard's rows
    and ``targets`` the ids shifted by the shard's first (a target outside
    [0, V_shard) lies in another shard and adds nothing).  Returns each
    token's merged f32 (m, l, target logit), (T, 3): the shards' triples,
    stacked (n, T, 3), go to :func:`ce_merge_cuda`."""
    global launches
    hidden, w_vocab, targets = _checked(hidden, w_vocab, targets,
                                        "cross_entropy_stats_cuda")
    T = hidden.shape[0]
    stats = torch.empty((T, 3), dtype=torch.float32, device=hidden.device)
    if T == 0:
        return stats
    ext = build.extension()
    ext.ce_fwd_stats(hidden, w_vocab, targets,
                     _scratch(ext, hidden, w_vocab.shape[0]), stats)
    launches += 1
    return stats


def ce_merge_cuda(parts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merges n vocab shards' (m, l, target logit) triples, ``parts`` (n,
    T, 3) f32 on CUDA, with the kernel that merges a call's vocab splits
    (``ce_merge_kernel``, the shards as its splits).  Returns (nll,
    lse)."""
    global merge_launches
    if not parts.is_cuda or parts.dtype != torch.float32 \
            or parts.dim() != 3 or parts.shape[2] != 3:
        raise ValueError(f"ce_merge_cuda takes (n, T, 3) f32 on CUDA, got "
                         f"{tuple(parts.shape)} {parts.dtype} on "
                         f"{parts.device}")
    parts = parts.contiguous()
    T = parts.shape[1]
    nll = torch.empty((T,), dtype=torch.float32, device=parts.device)
    lse = torch.empty((T,), dtype=torch.float32, device=parts.device)
    if T:
        build.extension().ce_merge(parts, nll, lse)
        merge_launches += 1
    return nll, lse
