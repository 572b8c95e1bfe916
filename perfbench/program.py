"""The benchmark's one door into the program under test, the PyTorch and
CUDA port ``repro_torch`` (``<checkout>/src``): the entry points the
timed paths drive, and nothing else.  Imported only once a run has
checked for its chips."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Tuple

from perfbench.reference.common import flatten

SRC = Path(__file__).resolve().parents[1] / "src"


def load() -> SimpleNamespace:
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.carousel.delivery import DeliveryIterator, device_put
    from repro_torch.carousel.stager import Stager
    from repro_torch.carousel.storage import ColdStore, DiskCache, TapeFile
    from repro_torch.carousel.transform import make_packing_transform
    from repro_torch.configs.base import ModelConfig, RunConfig, get_config
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.launch.serve import host_rules, resolve_device
    from repro_torch.models import registry
    from repro_torch.models.layers import cache_read, moe_route
    from repro_torch.optim import adamw_init
    from repro_torch.serve import engine
    from repro_torch.sharding import batch_split, use_rules
    from repro_torch.train.step import make_train_step
    return SimpleNamespace(**locals())


def model_config(prog, cfg_file: Dict):
    """The port's config of ``port_arch`` with every size the file
    states."""
    fields = {f.name for f in dataclasses.fields(prog.ModelConfig)}
    dims = {k: v for k, v in cfg_file["model"].items() if k in fields}
    return prog.get_config(cfg_file["port_arch"]).replace(**dims)


def param_layout(prog, cfg) -> Dict[Tuple[str, ...], Tuple]:
    """Each leaf of the port's parameter tree: (shape, dtype)."""
    return {p: (tuple(d.shape), d.dtype)
            for p, d in flatten(prog.registry.param_defs(cfg)).items()}


class Shards:
    """This rank's blocks of whole tensors, cut by the port's own
    ``ShardingRules.local_shard`` under ``rules`` as the port's defs name
    each dim: of a parameter leaf (``param``; with ``layer``, of one
    layer of a leaf stacked on a leading ``"layers"`` dim), and of a KV
    cache leaf of ``rows`` x ``max_len`` positions (``cache``)."""

    def __init__(self, prog, cfg, rules):
        self.prog, self.cfg, self.rules = prog, cfg, rules
        self.defs = flatten(prog.registry.param_defs(cfg))

    def _logical(self, path, layer: bool):
        d = self.defs[path]
        return (d.logical[1:], d.shape[1:]) if layer else (d.logical, d.shape)

    def param(self, path, x, layer: bool = False):
        return self.rules.local_shard(x, *self._logical(path, layer))

    def param_shape(self, path, layer: bool = False) -> Tuple[int, ...]:
        return self.rules.local_shape(*self._logical(path, layer))

    def cache(self, name: str, x, rows: int, max_len: int):
        """This rank's block of ``x`` laid out as one layer of cache leaf
        ``name`` (rows, max_len, heads, head dim), as ``engine.init_cache``
        keeps it (its ``model`` block)."""
        d = self.prog.registry.cache_defs(self.cfg, rows, max_len)[name]
        return self.rules.local_shard(x, d.logical[1:], d.shape[1:],
                                      keep=("model",))
