"""The reference's logits for served requests, for any family module of
this folder: the whole forward over each prompt followed by its served
tokens, a unit at a time over every request (a unit's weights made f32
once), a few rows at a time; the logits at the positions that produced a
served token."""
from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.reference.common import PRECISIONS, mm, unit_weights


@torch.no_grad()
def logits_at(fam, c: Dict, params: Dict, seqs: List[torch.Tensor],
              first: List[int], mode: str = "f32",
              rows: int = 4) -> List[torch.Tensor]:
    """``seqs``: groups of equal-length id rows (n, T); ``first``: each
    group's first position whose logits are wanted (through the end);
    ``mode``: a precision of ``mm``, or a fault of the family's units
    (the head then in f32).  Returns (n, T - first, V) f32 logits a
    group."""
    xs = [fam.embed(c, params, s) for s in seqs]
    for u in fam.units(c):
        w = unit_weights(params, fam.unit_leaves(c, u))
        for x in xs:
            for r in range(0, x.shape[0], rows):
                x[r:r + rows] = fam.unit_forward(c, u, w, x[r:r + rows],
                                                 mode)
        del w
    wh = unit_weights(params, fam.HEAD_LEAVES)
    head = wh[("embed", "lm_head")].t()
    head_mode = mode if mode in PRECISIONS else "f32"
    return [mm(fam.head_hidden(c, wh, x[:, f:]), head, head_mode)
            for x, f in zip(xs, first)]


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's
    best at its position: ref (n, k, V), tokens (n, k)."""
    return ref.max(dim=-1).values - ref.gather(
        -1, tokens[..., None].long())[..., 0]


def rel_err(logits: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The L2 distance of each position's logits from the reference's,
    over the reference's L2 norm there: logits, ref (n, k, V) -> (n, k)."""
    return (logits - ref).norm(dim=-1) / ref.norm(dim=-1)
