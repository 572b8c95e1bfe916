"""The benchmark's weights, drawn from ``--seed`` on the device, one call
a leaf, straight in the leaf's stored type.  Each leaf has a generator of
its own (seeded from the run's seed and the leaf's path), so one leaf can
be drawn again alone: the reference draws the same tree after the
program's state is gone, and the initial value of a trained leaf is
drawn again to measure how far training moved it."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from perfbench.corpus import mix
from perfbench.reference.common import Leaf, tree_from_paths

Path = Tuple[str, ...]


def draw_leaf(leaf: Leaf, seed: int, path: Path, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, "weights", *path))
    kw = dict(generator=g, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "normal":
        return torch.randn(leaf.shape, dtype=leaf.dtype, **kw).mul_(
            leaf.scale)
    u = torch.rand(leaf.shape, dtype=torch.float32, **kw)
    if leaf.init == "ssm_a":  # A_log = log of U[1, 16]
        return torch.log(u.mul_(15.0).add_(1.0)).to(leaf.dtype)
    if leaf.init == "ssm_dt":  # inverse softplus of U[1e-3, 1e-1]
        u = u.mul_(0.099).add_(0.001)
        return (u + torch.log(-torch.expm1(-u))).to(leaf.dtype)
    raise ValueError(f"unknown init {leaf.init!r}")


def draw_tree(specs: Dict[Path, Leaf], seed: int, device) -> Dict:
    return tree_from_paths({p: draw_leaf(l, seed, p, device)
                            for p, l in specs.items()})
