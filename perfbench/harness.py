"""One run of one cell: the chip check, the cell's set-up and window
(``train_cell`` / ``serve_cell`` by the mix's ``kind``), the metrics by
their readers, the comparison with the limits, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end ones;
with ``--trace 1`` its per-layer ones, read from the host clock over the
window (which runs as with ``--trace 0``) and from a device trace of a
few more steps or batches run after it.
The numbers compared with their limits are printed last on standard
error and under the result's last key, ``check``.

A cell of ``chips`` N > 1 runs as N ranks, a card each (``ranks.py``
starts them): each rank joins the port's process group, serves under
rules over a (1, N) mesh and checks its share of the sampled requests;
rank 0 closes the window, takes every number compared at its worst over
the ranks, and alone prints the result, with rank 0's trace and clock
and every rank's memory peak.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from perfbench import bench
from perfbench.workmath import bound_s

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Record:
    """What one run measured, for the metric readers: the window's steps
    (training: start, end, wait in ``next()``, tokens) or batches
    (serving: prompt length, rows, sent, first tokens and all tokens on
    the host, the tokens); with ``--trace 1`` the summary of the device
    trace of the steps or batches run after the window, and the kernel
    calls they needed; and the numbers ``correct`` compares."""

    def __init__(self, cell: bench.Cell, t_start: float):
        self.cell = cell
        self.kind = cell.traffic["kind"]
        self.t_start = t_start
        self.model = cell.config["model"]
        self.family = cell.family
        self.ops = bench.ops(cell.root)
        self.peaks = cell.peaks
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.steps: List[Dict] = []
        self.batches: List[Dict] = []
        self.shape: Dict = {}
        self.trace: Optional[Dict] = None
        self.traced_calls: List = []
        self.memory_peak_bytes: Optional[int] = None
        self.check: Dict[str, float] = {}
        self.detail: Dict = {}

    def log(self, msg: str) -> None:
        """A progress line on standard error, stamped from the start."""
        print(f"[perfbench {time.perf_counter() - self.t_start:8.2f} s] "
              f"{msg}", file=sys.stderr, flush=True)

    def read_memory(self, dev) -> None:
        import torch
        if dev.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))

    def forward_flops(self, B: int, S: int) -> float:
        return self.family.forward_flops(self.model, B, S, self.ops)

    def roofline(self, names: Sequence[str]) -> Optional[float]:
        """The traced calls of ops ``names``: their least time at the
        chip's peaks over their kernels' device time, in percent."""
        from perfbench.devtrace import kernel_seconds
        calls = [(n, kw) for n, kw in self.traced_calls if n in names]
        spent = kernel_seconds(self.trace, [p for n in names
                                            for p in self.ops[n].patterns])
        if not calls or spent <= 0:
            return None
        least = sum(bound_s(*self.ops[n].work(**kw), self.peaks)
                    for n, kw in calls)
        return 100.0 * least / spent


def run_cell(cell: bench.Cell, prog, dev, *, seed: int, seconds: float,
             trace: bool, t_start: float, **serve_kw) -> Record:
    from perfbench import serve_cell, train_cell
    rec = Record(cell, t_start)
    kind = cell.traffic["kind"]
    if kind == "train":
        train_cell.run(cell, prog, rec, seed=seed, seconds=seconds,
                       trace=trace, dev=dev)
    elif kind == "serve":
        serve_cell.run(cell, prog, rec, seed=seed, seconds=seconds,
                       trace=trace, dev=dev, **serve_kw)
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    return rec


def verdict(rec: Record) -> Dict[str, Dict[str, Optional[float]]]:
    """Each number the cell's limits file names, beside its limit (all of
    the run's numbers, limits None, where the cell has no limits yet)."""
    limits = rec.cell.limits.get("limits")
    if not limits:
        return {k: {"value": v, "limit": None} for k, v in rec.check.items()}
    return {k: {"value": rec.check.get(k), "limit": lim}
            for k, lim in limits.items()}


def is_correct(check: Dict[str, Dict[str, Optional[float]]]) -> bool:
    return bool(check) and all(
        c["limit"] is not None and c["value"] is not None
        and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in check.values())


def metrics(rec: Record, trace: bool) -> Dict[str, Dict]:
    out = {}
    for m in (rec.cell.per_layer if trace else rec.cell.end_to_end):
        v = bench.metric_reader(m["name"], rec.cell.root).read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result(rec: Record, trace: bool, dev) -> Dict:
    import torch
    check = verdict(rec)
    n = (len(rec.steps) if rec.kind == "train"
         else sum(b["rows"] for b in rec.batches))
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": rec.cell.chips,
              "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": is_correct(check), "attempted": n, "failed": 0,
           "metrics": metrics(rec, trace), "device": device}
    if trace and rec.trace:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    if dev.type == "cuda":
        device["power_limit_w"] = power_limit_w()
    out["check"] = check
    return out


def gather_ranks(rec: Record) -> Optional[List[int]]:
    """Over the ranks of a cell of more than one card: every number
    compared at its worst (largest) over the ranks, on every rank, and
    every rank's memory peak in rank order (None for one card)."""
    if rec.cell.chips == 1:
        return None
    import torch.distributed as dist
    got: List = [None] * rec.cell.chips
    dist.all_gather_object(got, (rec.memory_peak_bytes, rec.check))
    rec.check = {}
    for _, check in got:
        for k, v in check.items():
            if v is not None:
                rec.check[k] = max(v, rec.check.get(k, v))
    return [peak for peak, _ in got]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = bench.cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    from perfbench import program, ranks
    if cell.chips > 1 and not ranks.is_rank():
        return ranks.launch([sys.executable, str(
            bench.ROOT / "perfbench" / "run.py")] + list(argv), cell.chips,
            t_start)
    prog = program.load()
    dev = prog.resolve_device("cuda")
    if cell.chips > 1:
        t_start = ranks.started_at()
        ranks.join(prog.init_distributed)
    torch.cuda.reset_peak_memory_stats(dev)
    rec = run_cell(cell, prog, dev, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), t_start=t_start)
    rc = finish(rec, bool(args.trace), dev)
    if cell.chips > 1:
        ranks.leave(rc)
    return rc


def finish(rec: Record, trace: bool, dev) -> int:
    """Gathers the ranks' numbers, leaves the process group, looks for
    modules the run may not load (on every rank), and on rank 0 prints the
    numbers compared and the result line; the exit code."""
    peaks = gather_ranks(rec)
    res = result(rec, trace, dev)
    if peaks is not None:
        res["device"]["rank_memory_peak_bytes"] = peaks
    import torch.distributed as dist
    first = not dist.is_initialized() or dist.get_rank() == 0
    if dist.is_initialized():
        dist.destroy_process_group()
    bad = forbidden_modules()
    if bad:
        print(f"modules that the run may not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    if not first:
        return 0
    for k, c in res["check"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
