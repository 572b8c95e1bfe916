"""Functional parameter trees for the port (nested dicts of tensors).

A model definition is ``param_defs(cfg) -> tree of ParamDef``, as in
``repro/models/params.py``; the tree keeps the JAX layout (the same keys,
``x @ W`` with ``W`` shaped ``(d_in, d_out)``, layers stacked on a
leading ``L`` axis), so one set of weights loads into both packages.
Each def carries the JAX def's logical axes, one name (or None) a dim,
which ``repro_torch/sharding/rules.py`` resolves against a device mesh:

  "embed"   d_model dim            -> the data axis (FSDP / ZeRO-3)
  "heads"   attention head dim     -> model axis (iff divisible)
  "qkv"     flattened q/k/v dim    -> model axis (iff divisible)
  "ffn"     MLP hidden dim         -> model axis
  "vocab"   vocabulary dim         -> model axis
  "expert"  MoE expert dim         -> model axis (expert parallelism)
  "layers"  stacked-layer dim      -> never sharded
  None      replicated
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

Tree = Union[Dict[str, Any], Any]
Logical = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Logical  # one logical axis name (or None) per dim
    init: str = "normal"  # normal | zeros | ones | scaled | ssm_a | ssm_dt
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape,
                                                      self.logical)


def pdef(shape, logical, init: str = "normal", scale: float = 0.02,
         dtype: torch.dtype = torch.bfloat16) -> ParamDef:
    return ParamDef(tuple(shape), tuple(logical), init, scale, dtype)


def tree_map(f: Callable[[Any], Any], tree: Tree) -> Tree:
    """Maps ``f`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    return f(tree)


def logical_specs(defs: Tree) -> Tree:
    return tree_map(lambda d: d.logical, defs)


def unstack(defs: Tree) -> Tree:
    """The defs of one layer of a stacked tree: each def without its
    leading (``"layers"``) dim."""
    return tree_map(lambda d: ParamDef(d.shape[1:], d.logical[1:], d.init,
                                       d.scale, d.dtype), defs)


def layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a tree stacked on a leading L axis: a view of each
    leaf's slice (writes through it reach the stack)."""
    return tree_map(lambda a: a[i], tree)


def tree_leaves(tree: Tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def abstract(defs: Tree, device: Union[str, torch.device] = "meta") -> Tree:
    """Empty tensors of each def's shape and dtype (on ``meta``: shapes
    and dtypes only, nothing allocated) — what the dry run counts on.
    Under sharding rules over more than one rank, each leaf is this
    rank's block, as :func:`materialize` keeps it."""
    from repro_torch.sharding import rules as S  # sharding imports params
    r = S.current_rules()
    shape = (lambda d: r.local_shape(d.logical, d.shape)) \
        if S.sharded() else (lambda d: d.shape)
    return tree_map(lambda d: torch.empty(shape(d), dtype=d.dtype,
                                          device=device), defs)


def param_count(defs: Tree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def _init_leaf(d: ParamDef, gen: torch.Generator, device: torch.device,
               shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Draws ``d``'s init at ``shape`` (default ``d.shape``; one layer of a
    stacked def), its scale taken from ``d.shape``."""
    shape = d.shape if shape is None else shape
    if d.init == "zeros":
        return torch.zeros(shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=d.dtype, device=device)
    if d.init == "normal":
        s = d.scale
    elif d.init == "scaled":  # fan-in scaled
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        s = 1.0 / math.sqrt(max(fan_in, 1))
    elif d.init == "ssm_a":  # Mamba2 A_log: log of Uniform[1, 16]
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        return torch.log(u.mul_(15.0).add_(1.0)).to(d.dtype)
    elif d.init == "ssm_dt":  # dt bias: inverse softplus of U[1e-3, 1e-1]
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(0.099).add_(0.001)
        return (u + torch.log(-torch.expm1(-u))).to(d.dtype)
    else:
        raise ValueError(f"unknown init {d.init!r}")
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(s).to(d.dtype)


def _draw(d: ParamDef, gen: torch.Generator, device: torch.device,
          shard: Callable[[torch.Tensor, ParamDef], torch.Tensor]
          ) -> torch.Tensor:
    """One leaf: a stacked def (leading ``"layers"`` dim) is drawn a layer
    at a time into its output, so the f32 temporaries are one layer's;
    ``shard(x, def)`` keeps this rank's part of a drawn (layer) tensor."""
    if not d.logical or d.logical[0] != "layers":
        x = _init_leaf(d, gen, device)
        part = shard(x, d)
        return x if part is x else part.clone()
    one = ParamDef(d.shape[1:], d.logical[1:], d.init, d.scale, d.dtype)
    out = None
    for i in range(d.shape[0]):
        part = shard(_init_leaf(d, gen, device, one.shape), one)
        if out is None:
            out = torch.empty((d.shape[0],) + tuple(part.shape),
                              dtype=d.dtype, device=device)
        out[i] = part
    return out


def materialize(defs: Tree, generator: torch.Generator,
                device: Union[str, torch.device] = "cuda") -> Tree:
    """Initialises every leaf on ``device`` from ``generator`` (which must
    live on that device), a stacked leaf one layer at a time.  Under
    sharding rules (``repro_torch.sharding.use_rules``) every rank draws
    the same numbers and keeps only its shard of each leaf, so its peak is
    its shards plus one layer's leaf, and the ranks together hold the
    tree a one-rank run draws.  The numbers differ from ``jax.random``'s;
    load JAX weights with :func:`from_jax_params` to compare the two."""
    from repro_torch.sharding import rules as S  # sharding imports params
    device = torch.device(device)
    r = S.current_rules()
    shard = (lambda x, d: r.local_shard(x, d.logical, d.shape)) \
        if S.sharded() else (lambda x, d: x)
    return tree_map(lambda d: _draw(d, generator, device, shard), defs)


def cast_tree(tree: Tree, dtype: torch.dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), tree)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy that torch may own
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the raw bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_params(tree: Tree,
                    device: Union[str, torch.device] = "cuda") -> Tree:
    """Turns a JAX param tree, given as numpy arrays (``np.asarray`` of
    each leaf), into the port's tree: same keys, same layout, same bits."""
    return tree_map(lambda a: _from_numpy(a).to(device), tree)
