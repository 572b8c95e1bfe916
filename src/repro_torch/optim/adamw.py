"""AdamW with decoupled weight decay and global-norm clipping, ported
from ``repro/optim/adamw.py`` (same math, same defaults; no decay on 1-D
leaves).

Unlike the JAX version, which returns new trees, this one works IN PLACE
on the given trees, leaf by leaf and, inside a leaf, chunk by chunk of at
most ``CHUNK`` elements (a layer slice of the largest stacked leaves is
45 M elements).  At yi-6b size a stacked leaf holds 1.44 G elements, so
each f32 temporary of a whole-leaf update would take 5.8 GB; per chunk
they take at most 128 MB each.  ``m`` and ``v`` keep the dtype they were
made with (f32, or bf16 to halve their memory); the update runs in f32.

Under sharding rules each rank holds blocks of the leaves: the update is
elementwise, so each rank steps its own blocks, and ``global_norm``
(given each leaf's split axes) sums each leaf's squares over the ranks
that split it, so every rank clips by the same global norm.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.core import obs
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding import rules as S

OptState = Dict[str, Any]
CHUNK = 1 << 25  # elements per in-place update step


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of a contiguous tensor's elements, CHUNK at a time."""
    if not t.is_contiguous():
        raise ValueError("the optimizer updates contiguous tensors only")
    return iter(t.view(-1).split(CHUNK))


def global_norm(tree: Any, axes: Optional[Any] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor).
    ``axes`` (under sharding rules): per leaf, the mesh axes its blocks
    are split over; each leaf's sum is all-reduced over them."""
    if axes is not None:
        r = S.current_rules()
        total = None
        for x, ax in zip(tree_leaves(tree), tree_leaves(axes)):
            sq = None
            for c in _chunks(x):
                cf = c.float()
                sq = torch.dot(cf, cf) if sq is None else sq + torch.dot(
                    cf, cf)
            sq = r.all_reduce(sq, ax)
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    total = None
    for x in tree_leaves(tree):
        for c in _chunks(x):
            cf = c.float()
            sq = torch.dot(cf, cf)
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree: Any, max_norm: float,
                        axes: Optional[Any] = None
                        ) -> Tuple[Any, torch.Tensor]:
    """Scales every leaf IN PLACE by ``min(1, max_norm / norm)`` (in f32,
    rounded back to the leaf's dtype, as the JAX version casts back);
    returns (the same tree, norm)."""
    norm = global_norm(tree, axes)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(tree):
        g.mul_(scale)
    return tree, norm


def adamw_init(params: Any, *, dtype: torch.dtype = torch.float32
               ) -> OptState:
    """m/v moments shaped like params. ``dtype`` compresses the moments."""
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def adamw_update(
    params: Any,
    grads: Any,
    state: OptState,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    norm_axes: Optional[Any] = None,
) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step, IN PLACE: ``params``, ``state`` (and, through the
    clipping, ``grads``) are updated and returned.  Returns (params,
    state, metrics).  ``norm_axes``: see :func:`global_norm`."""
    with obs.span("train.clip"):
        if max_grad_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm,
                                               norm_axes)
        else:
            gnorm = global_norm(grads, norm_axes)

    step = state["step"] + 1
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        decay = p.dim() >= 2  # skip 1-D params (norms / biases)
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m),
                                  _chunks(v)):
            gf = gc.float()
            mf = mc.float()  # mc itself when m is f32
            vf = vc.float()
            mf.mul_(b1).add_(gf, alpha=1 - b1)
            vf.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            if mf is not mc:
                mc.copy_(mf)
                vc.copy_(vf)
            delta = (mf / c1) / (torch.sqrt(vf / c2) + eps)
            pf = pc.float()
            if decay:
                pf = pf - lr * weight_decay * pf
            pc.copy_(pf - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
