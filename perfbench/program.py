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

SRC = Path(__file__).resolve().parents[1] / "src"


def load() -> SimpleNamespace:
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.carousel.delivery import DeliveryIterator, device_put
    from repro_torch.carousel.stager import Stager
    from repro_torch.carousel.storage import ColdStore, DiskCache, TapeFile
    from repro_torch.carousel.transform import make_packing_transform
    from repro_torch.configs.base import ModelConfig, RunConfig, get_config
    from repro_torch.launch.serve import host_rules, resolve_device
    from repro_torch.models import registry
    from repro_torch.models.layers import cache_read
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
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = (tuple(t.shape), t.dtype)
    walk(prog.registry.param_defs(cfg), ())
    return out
