"""Logical-axis -> mesh-axis resolution with divisibility fallbacks, and
the collectives that place a param tree on a mesh of ranks; the twin of
``repro/sharding/rules.py``.

Model code never names mesh axes: its defs tag each dim with a logical
name ("batch", "heads", "ffn", ...).  A ``ShardingRules`` context resolves
the names against a mesh, dropping any mapping whose dim the mesh-axis
size does not divide, and a mesh axis that an earlier dim of the same
tensor took (first dim wins):

  batch   -> ("pod", "data")     activations' batch dim (DP across pods)
  embed   -> ("data",)           weight d_model dim (FSDP / ZeRO-3 style)
  heads   -> ("model",)          attention heads
  qkv     -> ("model",)          flattened q/k/v feature dim
  ffn     -> ("model",)          MLP hidden
  vocab   -> ("model",)          embedding/vocab rows
  expert  -> ("model",)          MoE experts (EP)
  kv_seq  -> ("model",)          KV sequence of the cache
  layers  -> ()                  stacked-layer dim, never sharded

How the port runs under rules (the JAX drivers leave this to GSPMD):

* Activations are local tensors: each rank holds its rows of the batch,
  split over the batch axes (``batch_axes``), and is replicated over
  ``model`` between blocks.  ``constrain`` checks a local activation's
  rows; a DTensor it redistributes.
* Every weight is stored as its spec places it: a rank holds its block
  (``shard_params``, ``materialize`` under rules).  ``gather_params``
  all-gathers a layer's weights just before the layer (ZeRO-3) over the
  axes not in ``keep``: the blocks keep their ``model`` split
  (``keep=("model",)``) and gather the ``data`` / ``pod`` one (the MoE
  block gathers its own: its experts keep their ``model`` split on both
  of its paths, prefill and decode).  The gather's backward sums the
  gradient over the batch axes the weight is split on and keeps this
  rank's block, and ``sync_grads`` sums the rest over the batch axes, so
  each rank ends with its block of the gradient of the global-batch loss.
* Dense compute is split over ``model`` as the specs place it (the
  Megatron layout): each model rank runs its heads of every attention,
  its ``ffn`` columns of every MLP and its vocab rows of the LM head and
  the CE.  A split region starts at ``enter_model`` (identity; the
  backward sums the input's gradient over ``model``) and ends at
  ``leave_model`` (the forward sums the ranks' partial outputs; identity
  backward), so activations, and the gradients of everything replicated
  over ``model`` (norms, the residual stream, a router, ``b_down``), are
  the same on every model rank.  Where the heads do not divide ``model``,
  attention splits its query rows instead (``"q_seq"``): it uses its
  weights whole (``model_whole``: all-gathered over ``model``, the
  gradient summed over ``model``, since each rank's rows give part of it)
  and all-gathers its output rows (``gather_model``, whose backward keeps
  this rank's rows).  A weight a replicated computation uses whole is
  gathered with ``gather`` (the backward keeps this rank's block, as every
  model rank computes the same gradient).  The Mamba2 block splits its
  SSM heads (``"heads_ssm"``), else the SSD head dim (``"ssm_p"``, its
  ``ffn`` weights made whole and the rank's channels taken), else runs
  whole; its gated RMSNorm sums a row's statistic over ``model``
  (``models/mamba2.py``).  The MoE block runs the rank's experts (or
  every expert's ``ffn`` slice) at prefill and decode alike.

A group of one rank does nothing: at world size 1 every helper returns
its input, so the mesh path is bit for bit the path without rules.
"""
from __future__ import annotations

import contextlib
import math
import threading
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import meter
from repro_torch.models import params as P

DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),
    "heads": ("model",),
    "heads_ssm": ("model",),
    "ssm_p": ("model",),  # SSD head_dim fallback when heads don't divide
    "qkv": ("model",),
    "ffn": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "kv_seq": ("model",),
    "q_seq": ("model",),
    "layers": (),
    "seq": (),
}

Spec = Tuple[Any, ...]  # per dim: None, a mesh-axis name or a tuple of them

_TLS = threading.local()


def _axes(r: Any) -> Tuple[str, ...]:
    """A resolved dim's mesh axes as a tuple (None -> ())."""
    if r is None:
        return ()
    return r if isinstance(r, tuple) else (r,)


class ShardingRules:
    """Rules over a mesh: anything with ``shape``, an ordered mapping of
    axis name -> size, and ``coord(axis)``.  An abstract mesh (names and
    sizes, no ranks: ``repro_torch.launch.mesh.Mesh`` without a
    ``DeviceMesh``) resolves specs, placements and the blocks of the rank
    it stands for, and charges its collectives without running them (on
    meta tensors: the dry run); over a process group they run."""

    def __init__(self, mesh: Any,
                 rules: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    # -- resolution (the JAX package's, on any mesh) ------------------------

    def axis_size(self, axes: Iterable[str]) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    def resolve_dim(self, name: Optional[str], dim: int) -> Optional[Any]:
        """Mesh axes for one tensor dim, or None (replicated)."""
        if name is None:
            return None
        axes = tuple(a for a in self.rules.get(name, ())
                     if a in self.mesh.shape)
        if not axes:
            return None
        if dim % self.axis_size(axes) != 0:
            # divisibility fallback: try a prefix of the axes, else replicate
            for k in range(len(axes) - 1, 0, -1):
                sub = axes[:k]
                if dim % self.axis_size(sub) == 0:
                    return sub if len(sub) > 1 else sub[0]
            return None
        return axes if len(axes) > 1 else axes[0]

    def spec(self, logical: Sequence[Optional[str]],
             shape: Sequence[int]) -> Spec:
        """Resolve logical names, dropping duplicate mesh-axis uses (first
        dim wins): MoE weights carry both "expert" and "ffn" and shard on
        whichever the arch's sizes allow.  One entry a dim: None, an axis
        name, or a tuple of axis names (major first)."""
        assert len(logical) == len(shape), (logical, shape)
        resolved: List[Any] = []
        used: set = set()
        for n, d in zip(logical, shape):
            r = self.resolve_dim(n, d)
            axes = _axes(r)
            if not axes or any(a in used for a in axes):
                resolved.append(None)
                continue
            used.update(axes)
            resolved.append(r)
        return tuple(resolved)

    def placements(self, logical: Sequence[Optional[str]],
                   shape: Sequence[int]) -> tuple:
        """The spec as DTensor placements, one a mesh dim in the mesh's
        order: ``Shard(d)`` where tensor dim d takes the axis, else
        ``Replicate()``.  Two axes on one dim shard it major first, as a
        PartitionSpec's tuple does."""
        from torch.distributed.tensor import Replicate, Shard
        owner = {a: d for d, r in enumerate(self.spec(logical, shape))
                 for a in _axes(r)}
        return tuple(Shard(owner[a]) if a in owner else Replicate()
                     for a in self.mesh.shape)

    def batch_axes(self, rows: int) -> Tuple[str, ...]:
        """The mesh axes a batch of ``rows`` rows is split over."""
        return _axes(self.resolve_dim("batch", rows))

    # -- this rank's blocks -------------------------------------------------

    def _block(self, axes: Tuple[str, ...]) -> Tuple[int, int]:
        """(this rank's index, count) of the blocks ``axes`` split a dim
        into, major axis first."""
        idx, n = 0, 1
        for a in axes:
            size = self.mesh.shape[a]
            idx = idx * size + (self.mesh.coord(a) if size > 1 else 0)
            n *= size
        return idx, n

    def local_shard(self, x: torch.Tensor, logical, shape,
                    keep: Tuple[str, ...] = ()) -> torch.Tensor:
        """This rank's block of a full tensor ``x`` (a view); with
        ``keep``, only the dims split over those axes are cut."""
        for d, r in enumerate(self.spec(logical, shape)):
            axes = _axes(r)
            if keep:
                axes = tuple(a for a in axes if a in keep)
            idx, n = self._block(axes)
            if n > 1:
                size = x.shape[d] // n
                x = x.narrow(d, idx * size, size)
        return x

    def local_shape(self, logical, shape,
                    keep: Tuple[str, ...] = ()) -> Tuple[int, ...]:
        """The shape of this rank's block (``local_shard``'s)."""
        out = []
        for n, r in zip(shape, self.spec(logical, shape)):
            axes = tuple(a for a in _axes(r) if not keep or a in keep)
            out.append(n // self.axis_size(axes))
        return tuple(out)

    def rows(self, n_rows: int, accum: int = 1) -> torch.Tensor:
        """This rank's rows of a global batch of ``n_rows``: a block of
        every microbatch (a contiguous block when ``accum`` is 1), so the
        ranks' microbatch i together hold the global microbatch i."""
        idx, n = self._block(self.batch_axes(n_rows // accum))
        per = n_rows // (accum * n)
        base = torch.arange(accum)[:, None] * (n_rows // accum)
        return (base + idx * per + torch.arange(per)[None, :]).reshape(-1)

    def local_batch(self, batch: Dict[str, torch.Tensor], accum: int = 1):
        """(this rank's rows of the global ``batch`` (``rows``), the rows a
        microbatch, the batch axes); None when the batch is not split."""
        B = next(iter(batch.values())).shape[0]
        axes = self.batch_axes(B // accum)
        if not self._live(axes):
            return None
        idx = self.rows(B, accum).to(next(iter(batch.values())).device)
        return ({k: v[idx] for k, v in batch.items()}, idx.numel() // accum,
                axes)

    # -- collectives over mesh axes (a group of one does nothing) ----------
    #
    # Each is charged to the active cost counter (``kernels/meter.py``) and
    # its operand's bytes under its kind, as ``hlo_cost`` counts them: an
    # all-reduce the tensor, an all-gather this rank's block, a
    # reduce-scatter the whole input, one charge an axis.  Over a process
    # group it runs and its bytes are added to this process's tally
    # (``collective_tally``).  On an abstract mesh it is not run: it takes
    # meta tensors only and gives the result's shape (the input itself for
    # an all-reduce, whose values are not the sum).

    def _live(self, axes: Iterable[str]) -> List[str]:
        return [a for a in axes if self.mesh.shape[a] > 1]

    def _collective(self, kind: str, x: torch.Tensor, result_bytes: int,
                    run) -> None:
        """Charges one collective of ``kind`` on operand ``x`` and runs
        ``run()`` over the process group, or, on an abstract mesh, checks
        that ``x`` is a meta tensor."""
        n = x.numel() * x.element_size()
        with meter.collective(kind, n, result_bytes):
            if getattr(self.mesh, "device_mesh", None) is None:
                if x.device.type != "meta":
                    raise ValueError(
                        f"a {kind} on an abstract mesh takes meta tensors "
                        f"only, not {x.device.type} ones: it has no ranks")
                return
            _TALLY[kind] += n
            run()

    def all_reduce(self, x: torch.Tensor, axes: Iterable[str]
                   ) -> torch.Tensor:
        """Sums ``x`` IN PLACE over the ranks of ``axes`` (one axis after
        the other) and returns it."""
        n = x.numel() * x.element_size()
        for a in self._live(axes):
            self._collective("all-reduce", x, n, lambda: dist.all_reduce(
                x, group=self.mesh.group(a)))
        return x

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axis: str) -> torch.Tensor:
        """Sums ``x`` over the ranks of ``axis`` and returns this rank's
        block of ``dim`` of the sum."""
        n = self.mesh.shape[axis]
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        self._collective(
            "reduce-scatter", x, out.numel() * out.element_size(),
            lambda: dist.reduce_scatter_tensor(out, x,
                                               group=self.mesh.group(axis)))
        return out.movedim(0, dim)

    def all_gather(self, x: torch.Tensor, dim: int,
                   axes: Tuple[str, ...]) -> torch.Tensor:
        """Concatenates the ranks' blocks of ``dim`` over ``axes`` (minor
        axis first, so the blocks land major first)."""
        for a in reversed(axes):
            n = self.mesh.shape[a]
            if n == 1:
                continue
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(n)]
            self._collective(
                "all-gather", x, n * x.numel() * x.element_size(),
                lambda: dist.all_gather(parts, x, group=self.mesh.group(a)))
            x = torch.cat(parts, dim=dim)
        return x


_TALLY: Counter = Counter()  # kind -> bytes this process's collectives moved


def collective_tally() -> Dict[str, int]:
    """Bytes by kind that this process's collectives over process groups
    have moved (their operands, as the cost counter charges them) since
    the last ``reset_collective_tally``."""
    return dict(_TALLY)


def reset_collective_tally() -> None:
    _TALLY.clear()


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_TLS, "rules", None)
    _TLS.rules = rules
    try:
        yield rules
    finally:
        _TLS.rules = prev


def current_rules() -> Optional[ShardingRules]:
    return getattr(_TLS, "rules", None)


def sharded() -> bool:
    """Whether the current rules span more than one rank: without that
    nothing is split, and the helpers below return their inputs at once
    (a decode step is host-bound, so the bookkeeping would cost time)."""
    r = getattr(_TLS, "rules", None)
    return r is not None and math.prod(r.mesh.shape.values()) > 1


@contextlib.contextmanager
def batch_split(rows: int, axes: Tuple[str, ...]):
    """Marks the activations of the calls inside as ``rows`` local rows
    of a batch split over ``axes``: ``constrain`` checks the rows, and
    gradients are summed over ``axes``."""
    prev = getattr(_TLS, "split", None)
    _TLS.split = (rows, tuple(axes))
    try:
        yield
    finally:
        _TLS.split = prev


def current_split() -> Optional[Tuple[int, Tuple[str, ...]]]:
    return getattr(_TLS, "split", None)


@contextlib.contextmanager
def _entered(rules, split):
    prev_r, prev_s = current_rules(), current_split()
    _TLS.rules, _TLS.split = rules, split
    try:
        yield
    finally:
        _TLS.rules, _TLS.split = prev_r, prev_s


def checkpoint(fn, *args, context_fn=None):
    """``torch.utils.checkpoint.checkpoint(fn, *args)`` (non-reentrant)
    whose recompute runs under the rules and batch split of the forward:
    the backward, and with it the recompute, may run on another thread
    (CUDA's autograd device threads), which the thread-local context does
    not reach.  ``context_fn``: as checkpoint's (e.g. a selective
    policy's); its recompute context is entered too."""
    from torch.utils.checkpoint import checkpoint as _ckpt
    rules, split = current_rules(), current_split()

    def contexts():
        fwd, rec = (contextlib.nullcontext(), contextlib.nullcontext()) \
            if context_fn is None else context_fn()
        return fwd, _stacked(_entered(rules, split), rec)
    return _ckpt(fn, *args, use_reentrant=False, context_fn=contexts)


@contextlib.contextmanager
def _stacked(*ctxs):
    with contextlib.ExitStack() as stack:
        for c in ctxs:
            stack.enter_context(c)
        yield


def _split_axes() -> Tuple[str, ...]:
    s = current_split()
    return () if s is None else s[1]


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The twin of the JAX ``constrain``: a no-op without rules.  Under
    rules a DTensor is redistributed to the logical placements; a local
    activation whose leading dim is "batch" must hold this rank's rows of
    the current ``batch_split`` (else ValueError) and is returned as it
    is."""
    r = current_rules()
    if r is None:
        return x
    if type(x).__name__ == "DTensor":
        return x.redistribute(x.device_mesh, r.placements(logical, x.shape))
    s = current_split()
    if logical and logical[0] == "batch" and s is not None \
            and x.shape[0] != s[0]:
        raise ValueError(f"activation of {x.shape[0]} rows under a batch "
                         f"split of {s[0]} rows a rank")
    return x


# ---------------------------------------------------------------------------
# Param-tree helpers
# ---------------------------------------------------------------------------


def _zip_map(f, tree, defs):
    if isinstance(tree, dict):
        return {k: _zip_map(f, v, defs[k]) for k, v in tree.items()}
    return f(tree, defs)


def param_specs(defs: Any, rules: ShardingRules) -> Any:
    """Spec tree for a ParamDef tree."""
    return P.tree_map(lambda d: rules.spec(d.logical, d.shape), defs)


def param_placements(defs: Any, rules: ShardingRules) -> Any:
    """DTensor placements tree for a ParamDef tree."""
    return P.tree_map(lambda d: rules.placements(d.logical, d.shape), defs)


def shard_params(tree: Any, defs: Any, rules: ShardingRules) -> Any:
    """A full tree -> this rank's blocks (copies, so the full tree may be
    freed); a leaf the mesh does not split stays the same tensor."""
    def one(x, d):
        part = rules.local_shard(x, d.logical, d.shape)
        return x if part is x else part.clone()
    return _zip_map(one, tree, defs)


class _Gather(torch.autograd.Function):
    """All-gathers the split dims of a weight.  Backward: this rank's
    block of the gradient, reduce-scattered over ``sum_axes`` (the batch
    axes the weight is split on, or ``model`` for ``model_whole``; summed)
    and cut over the others."""

    @staticmethod
    def forward(ctx, x, rules, dims, sum_axes):
        ctx.rules, ctx.dims, ctx.sum_axes = rules, dims, sum_axes
        for d, axes in dims:
            x = rules.all_gather(x, d, axes)
        return x

    @staticmethod
    def backward(ctx, g):
        r = ctx.rules
        for d, axes in ctx.dims:
            for a in axes:  # major first: the block of each in turn
                n = r.mesh.shape[a]
                if n == 1:
                    continue
                if a in ctx.sum_axes:
                    g = r.reduce_scatter(g, d, a)
                else:
                    size = g.shape[d] // n
                    g = g.narrow(d, r.mesh.coord(a) * size, size)
        return g.contiguous(), None, None, None


def gather(x: torch.Tensor, d: P.ParamDef,
           keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """The full weight of def ``d`` from this rank's block ``x`` (``keep``:
    axes whose split stays), differentiable; ``x`` itself when nothing is
    split (or it is whole already)."""
    if not sharded():
        return x
    r = current_rules()
    dims = []
    for i, ax in enumerate(r.spec(d.logical, d.shape)):
        axes = tuple(a for a in _axes(ax) if a not in keep)
        if r._live(axes) and x.shape[i] != d.shape[i] // r.axis_size(
                tuple(a for a in _axes(ax) if a in keep)):
            dims.append((i, axes))
    if not dims:
        return x
    split = {a for _, axes in dims for a in axes}
    sum_axes = tuple(a for a in _split_axes() if a in split)
    return _Gather.apply(x, r, tuple(dims), sum_axes)


def model_ranks() -> int:
    """Ranks of the current rules' ``model`` axis: 1 without rules, without
    a ``model`` axis, or at world size 1 (then nothing is split)."""
    r = current_rules()
    if r is None or not sharded():
        return 1
    return r.mesh.shape.get("model", 1)


def model_block(n: int) -> Tuple[int, int]:
    """(first, count) of this rank's block of a dim of ``n`` split over
    ``model``."""
    m = model_ranks()
    size = n // m
    return (current_rules().mesh.coord("model") * size if m > 1 else 0), size


class _EnterModel(torch.autograd.Function):
    """Identity; the backward sums the cotangent over ``model``: the input
    of a region split over ``model`` gets a part of its gradient from each
    rank's block, as ``shard_map``'s transpose sums the cotangent of an
    input its spec replicates."""

    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a contiguous copy: NCCL takes no strided tensor (a convolution
        # weight's gradient arrives transposed)
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.rules.all_reduce(g, ("model",)), None


class _LeaveModel(torch.autograd.Function):
    """All-reduce (sum) over ``model``; the backward passes each rank's
    cotangent unchanged (what follows is replicated over ``model``, so
    every rank holds the same cotangent), as ``lax.psum``'s transpose
    inside ``shard_map`` does."""

    @staticmethod
    def forward(ctx, y, rules):
        return rules.all_reduce(y.clone(memory_format=torch.contiguous_format),
                                ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """All-gathers ``dim`` over ``model``; the backward keeps this rank's
    block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, rules, dim):
        ctx.rules, ctx.dim, ctx.size = rules, dim, x.shape[dim]
        return rules.all_gather(x, dim, ("model",))

    @staticmethod
    def backward(ctx, g):
        i = ctx.rules.mesh.coord("model")
        return g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(), \
            None, None


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """The start of a region split over ``model`` (see the module doc)."""
    if model_ranks() == 1:
        return x
    return _EnterModel.apply(x, current_rules())


def leave_model(x: torch.Tensor) -> torch.Tensor:
    """The end of a region split over ``model``: the ranks' partial sums
    added."""
    if model_ranks() == 1:
        return x
    return _LeaveModel.apply(x, current_rules())


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``dim`` concatenated over ``model``."""
    if model_ranks() == 1:
        return x
    return _GatherModel.apply(x, current_rules(), dim % x.dim())


def model_whole(x: torch.Tensor, d: P.ParamDef) -> torch.Tensor:
    """The whole weight of def ``d`` over ``model`` from this rank's block
    ``x`` (its other axes gathered already), for a region split over
    ``model`` that uses it whole: the gradient is SUMMED over ``model``
    (reduce-scattered where the weight is split, all-reduced where it is
    replicated), since each rank's part of the work gives part of it."""
    r = current_rules()
    if model_ranks() == 1:
        return x
    for i, ax in enumerate(r.spec(d.logical, d.shape)):
        if "model" in _axes(ax):
            assert _axes(ax) == ("model",), (d, ax)
            if x.shape[i] == d.shape[i]:
                break
            return _Gather.apply(x, r, ((i, ("model",)),), ("model",))
    return _EnterModel.apply(x, r)


def gather_params(tree: Any, defs: Any, keep: Tuple[str, ...] = ()) -> Any:
    """``gather`` over a tree and its defs; the tree itself when nothing
    is split."""
    if not sharded():
        return tree
    return _zip_map(lambda x, d: gather(x, d, keep), tree, defs)


def sync_grads(grads: Any, defs: Any) -> Any:
    """Sums each gradient block IN PLACE over the batch axes its weight is
    not split on (the gather's backward summed the others)."""
    r = current_rules()
    axes = _split_axes()
    if r is None or not r._live(axes):
        return grads

    def one(g, d):
        split = {a for ax in r.spec(d.logical, d.shape) for a in _axes(ax)}
        r.all_reduce(g, [a for a in axes if a not in split])
        return g
    return _zip_map(one, grads, defs)


def sharded_axes(defs: Any) -> Any:
    """Per leaf, the mesh axes its weight is split over (under the current
    rules): the ranks over which a sum over its blocks runs."""
    r = current_rules()
    return P.tree_map(lambda d: tuple(
        a for ax in r.spec(d.logical, d.shape) for a in _axes(ax)), defs)


