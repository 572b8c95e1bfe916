"""What a run finds by name: the cell in ``BENCHMARK.json``, and under
``perfbench/`` its configuration (``configs/<config>.json``), its traffic
mix (``traffic/<traffic>.json``), its limits of ``correct``
(``limits/<cell>.json``), each metric's reader (``metrics/<metric>.py``),
each op class (``ops/*.py``) and each model family's reference
(``reference/<family>.py``).  A new cell, configuration, mix, metric or
op is a new file and an entry, never an edit."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]


def set_cache_env(root: Path = ROOT) -> None:
    """Points every build and kernel cache at a fixed directory under the
    checkout's ``build/`` (call before torch is imported)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """``metrics/<name>.py``: its ``read(record)`` gives the metric's
    value, or None where the run has nothing to read."""
    return _module(root / "perfbench" / "metrics" / f"{name}.py",
                   "perfbench_metric_" + name.replace(".", "_"))


def ops(root: Path = ROOT) -> Dict[str, object]:
    """Every op class of ``ops/``, by its name."""
    out = {}
    for p in sorted((root / "perfbench" / "ops").glob("*.py")):
        op = _module(p, "perfbench_op_" + p.stem).OP
        out[op.name] = op
    return out


def family(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.reference.{name}")


@dataclass
class Cell:
    """One cell with everything its files say."""
    name: str
    root: Path
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    peaks: Dict = field(default_factory=dict)

    @property
    def family(self) -> ModuleType:
        return family(self.config["reference"])


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[Dict] = None,
         root: Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = root / "perfbench"
    limits_path = here / "limits" / f"{name}.json"
    return Cell(
        name=name, root=root, chips=int(entry["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(limits_path) if limits_path.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        peaks=load_json(here / "peaks.json"))
