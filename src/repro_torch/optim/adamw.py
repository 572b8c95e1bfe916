"""AdamW with decoupled weight decay and global-norm clipping, ported
from ``repro/optim/adamw.py`` (same math, same defaults; no decay on 1-D
leaves).

Unlike the JAX version, which returns new trees, this one works IN PLACE
on the params and the moments; the gradients are read and left as they
are (the clipped gradient is a value inside the update, as in the JAX
version, and nothing reads it back: ``train_step`` drops the gradients).
``m`` and ``v`` keep the dtype they were made with (f32, or bf16 to halve
their memory); the update runs in f32.

Two versions, chosen as ``kernels/ops.py`` chooses (``use_kernels``
None: the kernels exactly when the leaves lie on CUDA; True on CPU
tensors raises):

- the CUDA kernels of ``kernels/adamw.py``: per leaf a sum-of-squares
  launch, one finalize launch for the leaves' sums (left on the device),
  then per leaf one update launch that reads p, g, m and v once;
- the plain version here, on CPU and meta tensors: the same steps leaf
  by leaf and, inside a leaf, chunk by chunk of at most ``CHUNK``
  elements (at yi-6b size a stacked leaf holds 1.44 G elements, so an
  f32 temporary of a whole leaf would take 5.8 GB; of a chunk at most
  128 MB).  It rounds where the kernel rounds: the clipped gradient to
  its dtype, m and v to theirs, p once at the end.

Both take the norm and the clip scale from the leaves' sums by the same
code (``_finish``), and both charge the cost counter
(``kernels/meter.py``) the same calls: one ``adamw_norm`` a leaf and one
for the finalize, one ``adamw`` a leaf.

Under sharding rules each rank holds blocks of the leaves: the update is
elementwise, so each rank steps its own blocks, and the norm (given each
leaf's split axes) sums each leaf's squares over the ranks that split
it, so every rank clips by the same global norm.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import obs
from repro_torch.kernels import adamw as kadamw
from repro_torch.kernels import meter
from repro_torch.kernels import ops
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding import rules as S

OptState = Dict[str, Any]
CHUNK = 1 << 25  # elements per in-place update step of the plain version


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of a contiguous tensor's elements, CHUNK at a time."""
    if not t.is_contiguous():
        raise ValueError("the optimizer updates contiguous tensors only")
    return iter(t.view(-1).split(CHUNK))


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    """The plain version of a leaf's norm launch: its f32 sum of squares
    (0-d)."""
    sq = None
    for c in _chunks(g):
        cf = c.float()
        sq = torch.dot(cf, cf) if sq is None else sq + torch.dot(cf, cf)
    return sq


def _finish(sums: torch.Tensor, max_norm: float
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(norm, clip scale or None) from the leaves' sums of squares, added
    in leaf order, so that the bits depend on the sums alone."""
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    norm = torch.sqrt(total)
    if max_norm <= 0:
        return norm, None
    return norm, torch.clamp(max_norm / torch.clamp(norm, min=1e-9),
                             max=1.0)


def _norm_and_scale(leaves: List[torch.Tensor], max_norm: float,
                    axes: Optional[Sequence], kernel: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the global norm, the clip scale ``min(1, max_norm / norm)`` or
    None where ``max_norm`` <= 0), both 0-d f32 on the leaves' device.
    ``axes``: per leaf, the mesh axes its blocks are split over; each
    leaf's sum is all-reduced over them before the norm is taken."""
    parts = kadamw.new_parts(leaves) if kernel else []
    for i, g in enumerate(leaves):
        with meter.charge("adamw_norm", functools.partial(kadamw.norm_work,
                                                          g)):
            if kernel:
                kadamw.norm_cuda(g, parts, i)
            else:
                parts.append(_sq_sum(g))
    with meter.charge("adamw_norm",
                      functools.partial(kadamw.final_work, len(leaves))):
        sums = kadamw.norm_final_cuda(parts) if kernel else torch.stack(parts)
    if axes is not None:
        r = S.current_rules()
        for i, ax in enumerate(axes):
            r.all_reduce(sums[i:i + 1], ax)
    return _finish(sums, max_norm)


def adamw_init(params: Any, *, dtype: torch.dtype = torch.float32
               ) -> OptState:
    """m/v moments shaped like params. ``dtype`` compresses the moments."""
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def _update_leaf(p, g, m, v, scale, *, lr, b1, b2, eps, weight_decay, c1,
                 c2, decay: bool) -> None:
    """The plain version of a leaf's update launch, IN PLACE on p, m, v,
    chunk by chunk, each op rounding as the kernel does (c1 and c2 as 0-d
    f32 tensors, so that they are divided by, not multiplied by their
    reciprocal as a Python scalar divisor is on CUDA)."""
    c1, c2 = (torch.full((), c, dtype=torch.float32, device=p.device)
              for c in (c1, c2))
    for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m),
                              _chunks(v)):
        gf = gc.float()
        if scale is not None:
            gf = (gf * scale).to(gc.dtype).float()
        mf = mc.float()  # mc itself when m is f32
        vf = vc.float()
        mf.mul_(b1).add_(gf * (1 - b1))
        vf.mul_(b2).add_(gf * (1 - b2) * gf)
        if mf is not mc:
            mc.copy_(mf)
            vc.copy_(vf)
        delta = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        pf = pc.float()
        if decay:
            pf = pf - lr * weight_decay * pf
        pc.copy_(pf - lr * delta)


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
    use_kernels: Optional[bool] = None,
) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step, IN PLACE: ``params`` and ``state`` are updated and
    returned; ``grads`` are read, clipped inside the update and not
    written.  Returns (params, state, metrics), ``grad_norm`` a 0-d
    device tensor.  ``norm_axes`` (under sharding rules): per leaf, the
    mesh axes its blocks are split over, so that each leaf's sum of
    squares is all-reduced over them; ``use_kernels``: see the module
    doc."""
    leaves, g_leaves = list(tree_leaves(params)), list(tree_leaves(grads))
    kernel = ops._kernel_path(leaves[0], use_kernels)
    with obs.span("train.clip"):
        gnorm, scale = _norm_and_scale(
            g_leaves, max_grad_norm,
            None if norm_axes is None else list(tree_leaves(norm_axes)),
            kernel)

    step = state["step"] + 1
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 c1=c1, c2=c2)
    for p, g, m, v in zip(leaves, g_leaves, tree_leaves(state["m"]),
                          tree_leaves(state["v"])):
        decay = p.dim() >= 2  # skip 1-D params (norms / biases)
        with meter.charge("adamw", functools.partial(
                kadamw.update_work, p, g, m, v, clip=scale is not None,
                decay=decay)):
            (kadamw.update_cuda if kernel else _update_leaf)(
                p, g, m, v, scale, decay=decay, **hyper)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
