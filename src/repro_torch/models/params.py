"""Functional parameter trees for the port (nested dicts of tensors).

A model definition is ``param_defs(cfg) -> tree of ParamDef``, as in
``repro/models/params.py``; the tree keeps the JAX layout (the same keys,
``x @ W`` with ``W`` shaped ``(d_in, d_out)``, layers stacked on a
leading ``L`` axis), so one set of weights loads into both packages.
The logical sharding axes of the JAX defs are not kept: one card holds
the model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch

Tree = Union[Dict[str, Any], Any]


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | scaled | ssm_a | ssm_dt
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16


def pdef(shape, init: str = "normal", scale: float = 0.02,
         dtype: torch.dtype = torch.bfloat16) -> ParamDef:
    return ParamDef(tuple(shape), init, scale, dtype)


def tree_map(f: Callable[[Any], Any], tree: Tree) -> Tree:
    """Maps ``f`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    return f(tree)


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
    and dtypes only, nothing allocated) — what the dry run counts on."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device=device), defs)


def param_count(defs: Tree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def _init_leaf(d: ParamDef, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "normal":
        s = d.scale
    elif d.init == "scaled":  # fan-in scaled
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        s = 1.0 / math.sqrt(max(fan_in, 1))
    elif d.init == "ssm_a":  # Mamba2 A_log: log of Uniform[1, 16]
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=device)
        return torch.log(u.mul_(15.0).add_(1.0)).to(d.dtype)
    elif d.init == "ssm_dt":  # dt bias: inverse softplus of U[1e-3, 1e-1]
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(0.099).add_(0.001)
        return (u + torch.log(-torch.expm1(-u))).to(d.dtype)
    else:
        raise ValueError(f"unknown init {d.init!r}")
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(s).to(d.dtype)


def materialize(defs: Tree, generator: torch.Generator,
                device: Union[str, torch.device] = "cuda") -> Tree:
    """Initialises every leaf on ``device`` from ``generator`` (which must
    live on that device).  The numbers differ from ``jax.random``'s; load
    JAX weights with :func:`from_jax_params` to compare the two."""
    device = torch.device(device)
    return tree_map(lambda d: _init_leaf(d, generator, device), defs)


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
