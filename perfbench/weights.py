"""The benchmark's weights, drawn from ``--seed`` on the device, straight
in the leaf's stored type.  Each leaf has a generator of its own (seeded
from the run's seed and the leaf's path), so one leaf can be drawn again
alone: the reference draws the same tree after the program's state is
gone, and the initial value of a trained leaf is drawn again to measure
how far training moved it.

A configuration whose file sets ``"draw_by_layer": true`` draws each leaf
stacked on a leading layer axis a layer at a time instead, each (leaf,
layer) from a generator of its own (seeded from the seed, the path and
the layer): a model too large for one card is drawn on each of its cards
keeping only that card's block of each layer (:func:`draw_blocks`), and
the reference draws the same layers again one at a time
(:class:`ByLayer`)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from perfbench.corpus import mix
from perfbench.reference.common import Leaf, tree_from_paths

Path = Tuple[str, ...]


def _draw(leaf: Leaf, shape: Tuple[int, ...], seed: int, device,
          *name) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, "weights", *name))
    kw = dict(generator=g, device=device)
    if leaf.init == "ones":
        return torch.ones(shape, dtype=leaf.dtype, device=device)
    if leaf.init == "zeros":
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    if leaf.init == "normal":
        return torch.randn(shape, dtype=leaf.dtype, **kw).mul_(leaf.scale)
    u = torch.rand(shape, dtype=torch.float32, **kw)
    if leaf.init == "ssm_a":  # A_log = log of U[1, 16]
        return torch.log(u.mul_(15.0).add_(1.0)).to(leaf.dtype)
    if leaf.init == "ssm_dt":  # inverse softplus of U[1e-3, 1e-1]
        u = u.mul_(0.099).add_(0.001)
        return (u + torch.log(-torch.expm1(-u))).to(leaf.dtype)
    raise ValueError(f"unknown init {leaf.init!r}")


def draw_leaf(leaf: Leaf, seed: int, path: Path, device) -> torch.Tensor:
    return _draw(leaf, leaf.shape, seed, device, *path)


def draw_layer(leaf: Leaf, seed: int, path: Path, i: int,
               device) -> torch.Tensor:
    """Layer ``i`` of a leaf stacked on a leading layer axis, drawn
    alone."""
    return _draw(leaf, leaf.shape[1:], seed, device, *path, i)


def draw_tree(specs: Dict[Path, Leaf], seed: int, device) -> Dict:
    return tree_from_paths({p: draw_leaf(l, seed, p, device)
                            for p, l in specs.items()})


def stacked(path: Path) -> bool:
    """Whether leaf ``path`` is stacked on a leading layer axis: the
    leaves under ``blocks``, as the program stores them."""
    return path[0] == "blocks"


def draw_blocks(specs: Dict[Path, Leaf], seed: int, device, shards,
                by_layer: bool) -> Dict:
    """This rank's blocks of the tree (``shards``: ``program.Shards``):
    each leaf drawn whole and cut, or with ``by_layer`` each stacked leaf
    drawn a layer at a time, each layer cut as it is drawn, so that the
    rank holds its blocks and one layer of one leaf at most."""
    out = {}
    for p, leaf in specs.items():
        if not (by_layer and stacked(p)):
            whole = draw_leaf(leaf, seed, p, device)
            part = shards.param(p, whole)
            out[p] = whole if part is whole else part.clone()
            del whole
            continue
        n = leaf.shape[0]
        out[p] = torch.empty((n,) + shards.param_shape(p, layer=True),
                             dtype=leaf.dtype, device=device)
        for i in range(n):
            out[p][i] = shards.param(
                p, draw_layer(leaf, seed, p, i, device), layer=True)
    return tree_from_paths(out)


class ByLayer:
    """A stacked leaf as the reference reads it: ``[i]`` draws layer
    ``i`` (:func:`draw_layer`, the draw the program's layer came from)."""

    def __init__(self, leaf: Leaf, seed: int, path: Path, device):
        self.leaf, self.seed, self.path, self.device = leaf, seed, path, \
            device

    def __getitem__(self, i: int) -> torch.Tensor:
        return draw_layer(self.leaf, self.seed, self.path, i, self.device)


def reference_tree(specs: Dict[Path, Leaf], seed: int, device,
                   by_layer: bool) -> Dict:
    """The whole tree for the reference: with ``by_layer`` each stacked
    leaf a :class:`ByLayer` (the reference takes one layer at a time),
    else every leaf drawn whole (``draw_tree``)."""
    if not by_layer:
        return draw_tree(specs, seed, device)
    return tree_from_paths({
        p: ByLayer(leaf, seed, p, device) if stacked(p)
        else draw_leaf(leaf, seed, p, device) for p, leaf in specs.items()})
