"""The program's spans (``repro_torch.core.obs``) joined with the device
trace of the same steps or batches, and the per-layer numbers read from
that join.

A device operation (kernel, copy or fill) belongs to the innermost span
open on its launching thread at its launch time: the launch is the
runtime or driver event that carries the operation's correlation id.
Kineto numbers a launching thread by the profiler's own count (1, 2,
...), not by the OS thread id the spans carry, so the join maps each
profiler thread to the recorder's thread, other than the main one, whose
spans hold the most of its launches, or to the main thread where no
other thread's spans hold any (on CUDA the main thread waits in
``backward()`` while autograd's device thread launches).  Where the
launching thread has no span open, the operation goes to the main
thread's innermost span, which the recorder makes the parent of that
thread's spans.  Per span name, the join gives the
device seconds under a span of that name (its own operations and its
descendants', as the union of their intervals), their count, the idle
seconds put down to it (each gap between device intervals goes to the
innermost span open on the recorder's main thread as the gap began, or
to ``outside spans``), and the spans' own wall time with the share of it
in which nothing ran on the device.  The spans' clock is the trace's
(Unix epoch ns).

``SpannedTrace`` is a ``DeviceTrace`` that keeps the recorder on over
exactly the traced steps or batches and adds the join to its summary
under ``spans``; every other key of the summary is the base class's.
Run as a script it runs one cell as ``run.py --trace 1`` does, with
``SpannedTrace`` in the cells' place, and prints, after the result line,
a line ``spans {...}`` with the join and its ``readings``:

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from perfbench.devtrace import DeviceTrace, _events, _union  # noqa: E402

OUTSIDE = "outside spans"

# op: (start_ns, end_ns, correlation id, name); launch: correlation id ->
# (thread id, start_ns)
Op = Tuple[int, int, int, str]


def _is_device(e) -> bool:
    return str(e.device_type()).split(".")[-1] == "CUDA"


def _is_launch(e) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...); torch's own ops are
    named ``aten::...``."""
    return e.name().startswith("cu")


def trace_rows(events: Iterable) -> Tuple[List[Op], Dict[int, Tuple]]:
    """The device operations and the launches of kineto ``events``."""
    ops: List[Op] = []
    launches: Dict[int, Tuple[int, int]] = {}
    for e in events:
        start = e.start_ns()
        if _is_device(e):
            ops.append((start, start + e.duration_ns(), e.correlation_id(),
                        e.name()))
        elif _is_launch(e):
            launches[e.correlation_id()] = (e.start_thread_id(), start)
    return ops, launches


def _sweep(spans: Sequence[Dict], times: Sequence[int]
           ) -> List[Optional[Dict]]:
    """For each of the sorted ``times``, the innermost (latest-started)
    of ``spans`` open at it, or None."""
    marks = sorted([(s["start_ns"], 1, i) for i, s in enumerate(spans)]
                   + [(s["end_ns"], 0, i) for i, s in enumerate(spans)])
    out: List[Optional[Dict]] = []
    open_: List[int] = []
    j = 0
    for t in times:
        while j < len(marks) and marks[j][0] <= t:
            _, is_start, i = marks[j]
            if is_start:
                open_.append(i)
            elif i in open_:
                open_.remove(i)
            j += 1
        out.append(spans[open_[-1]] if open_ else None)
    return out


def _thread_map(launches: Sequence[Tuple[int, int]],
                spans: Sequence[Dict], main_tid: Optional[int]
                ) -> Dict[int, Optional[int]]:
    """Profiler thread -> recorder thread (module doc)."""
    others: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(list)
    for s in spans:
        if s["tid"] != main_tid:
            others[s["tid"]].append((s["start_ns"], s["end_ns"]))
    unions = {t: _union(iv) for t, iv in others.items()}
    held: Dict[int, collections.Counter] = collections.defaultdict(
        collections.Counter)
    for ptid, t in launches:
        for rtid, iv in unions.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t < iv[i][1]:
                held[ptid][rtid] += 1
    out: Dict[int, Optional[int]] = {}
    for ptid, _ in launches:
        if ptid not in out:
            best = held[ptid].most_common(1)
            out[ptid] = best[0][0] if best else main_tid
    return out


def _innermost(spans: Sequence[Dict], queries: List[Tuple[int, int]]
               ) -> List[Optional[Dict]]:
    """For each (recorder thread id, time): the innermost span open at
    that time on that thread, or None."""
    by_tid: Dict[int, List[Dict]] = collections.defaultdict(list)
    for s in spans:
        by_tid[s["tid"]].append(s)
    out: List[Optional[Dict]] = [None] * len(queries)
    groups: Dict[int, List[int]] = collections.defaultdict(list)
    for k, (tid, _) in enumerate(queries):
        groups[tid].append(k)
    for tid, ks in groups.items():
        ks.sort(key=lambda k: queries[k][1])
        got = _sweep(by_tid.get(tid, []), [queries[k][1] for k in ks])
        for k, s in zip(ks, got):
            out[k] = s
    return out


def join(ops: Sequence[Op], launches: Dict[int, Tuple[int, int]],
         spans: Sequence[Dict], main_tid: Optional[int] = None,
         groups: Optional[Dict[str, Sequence[str]]] = None) -> Dict:
    """Puts every device operation and idle gap down to a span (module
    doc).  ``groups``: further names, each the union of the device time
    under any of its span names.  ``main_tid``: the thread whose spans
    take the idle gaps (default: the thread of the first span)."""
    spans = [s for s in spans if s["end_ns"] is not None]
    by_id = {s["id"]: s for s in spans}
    if main_tid is None and spans:
        main_tid = spans[0]["tid"]

    def names_up(s: Optional[Dict]) -> List[str]:
        out = []
        while s is not None:
            out.append(s["name"])
            s = by_id.get(s["parent"])
        return out

    launched = [launches.get(corr) for _, _, corr, _ in ops]
    tmap = _thread_map([x for x in launched if x is not None], spans,
                       main_tid)
    owner = _innermost(spans, [(tmap[x[0]], x[1]) if x is not None
                               else (None, -1) for x in launched])
    again = [k for k, (x, s) in enumerate(zip(launched, owner))
             if x is not None and s is None and tmap[x[0]] != main_tid]
    for k, s in zip(again, _innermost(
            spans, [(main_tid, launched[k][1]) for k in again])):
        owner[k] = s
    fell = set(again)
    matched = collections.Counter(
        "unlaunched" if x is None else "main" if k in fell else "thread"
        for k, x in enumerate(launched))

    intervals: Dict[str, List] = collections.defaultdict(list)
    for (a, b, _, _), s in zip(ops, owner):
        seen = set(names_up(s)) if s is not None else {OUTSIDE}
        for n, members in (groups or {}).items():
            if seen & set(members):
                seen.add(n)
        for n in seen:
            intervals[n].append((a, b))
    busy = _union([(a, b) for a, b, _, _ in ops])
    idle: Dict[str, float] = collections.defaultdict(float)
    main = [s for s in spans if s["tid"] == main_tid]
    gaps = list(zip(busy, busy[1:]))
    at = _sweep(main, [end for (_, end), _ in gaps])
    for ((_, end), (nxt, _)), s in zip(gaps, at):
        idle[s["name"] if s is not None else OUTSIDE] += (nxt - end) * 1e-9

    walls: Dict[str, List] = collections.defaultdict(list)
    calls = collections.Counter()
    for s in spans:
        walls[s["name"]].append((s["start_ns"], s["end_ns"]))
        calls[s["name"]] += 1
    starts = [a for a, _ in busy]

    def busy_in(a: int, b: int) -> int:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        got = 0
        while i < len(busy) and busy[i][0] < b:
            got += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
        return got

    by_span: Dict[str, Dict] = {}
    for n in sorted(set(intervals) | set(idle) | set(walls)):
        dev = _union(intervals.get(n, []))
        wall = _union(walls.get(n, []))
        wall_ns = sum(b - a for a, b in wall)
        by_span[n] = {
            "device_s": sum(b - a for a, b in dev) * 1e-9,
            "kernels": len(intervals.get(n, [])),
            "idle_s": idle.get(n, 0.0),
            "calls": calls.get(n, 0),
            "wall_s": wall_ns * 1e-9,
            "idle_in_s": (wall_ns - sum(busy_in(a, b) for a, b in wall))
            * 1e-9,
        }
    return {"busy_s": sum(b - a for a, b in busy) * 1e-9,
            "in_spans_s": sum(b - a for a, b in _union(
                [(a, b) for (a, b, _, _), s in zip(ops, owner)
                 if s is not None])) * 1e-9,
            "launches": dict(matched), "by_span": by_span}


# mamba_ms.train's union: the blocks' forward and remat's recompute lie
# under block.mamba2, their backward under block.mamba2.bwd
GROUPS = {"mamba": ("block.mamba2", "block.mamba2.bwd")}


def readings(j: Dict, kind: str, traffic: Dict) -> Dict[str, float]:
    """``optimizer_ms.train``, ``ce_bwd_ms.train`` and ``mamba_ms.train``
    (device ms under ``train.optimizer``, ``loss.ce_bwd``, the mamba
    blocks' forward, recompute and backward, a traced step);
    ``decode_idle.serve`` (% of the ``serve.decode`` spans' time with
    nothing on the device) and ``decode_launches.serve`` (device
    operations under ``serve.decode`` a decode step); each where the join
    has it."""
    by, out = j["by_span"], {}
    if kind == "train":
        n = traffic["trace_steps"]
        for metric, name in (("optimizer_ms.train", "train.optimizer"),
                             ("ce_bwd_ms.train", "loss.ce_bwd"),
                             ("mamba_ms.train", "mamba")):
            if by.get(name, {}).get("kernels"):
                out[metric] = 1e3 * by[name]["device_s"] / n
    elif kind == "serve" and by.get("serve.decode", {}).get("calls"):
        d = by["serve.decode"]
        if d["wall_s"] > 0:
            out["decode_idle.serve"] = 100.0 * d["idle_in_s"] / d["wall_s"]
        out["decode_launches.serve"] = d["kernels"] / d["calls"]
    return out


class SpannedTrace(DeviceTrace):
    """A ``DeviceTrace`` with the program's span recorder on between its
    ``start`` and ``stop``; ``summary`` adds the join under ``spans``."""

    def start(self) -> None:
        from repro_torch.core import obs
        super().start()
        self.obs = obs
        self.obs.start()

    def stop(self) -> None:
        self.spans = self.obs.stop()
        super().stop()

    def summary(self, top: int = 10) -> Dict:
        out = super().summary(top)
        ops, launches = trace_rows(_events(self.prof))
        main = self.spans[0]["tid"] if self.spans else None
        out["spans"] = join(ops, launches, self.spans, main,
                            groups=GROUPS)
        return out


def table(j: Dict, top: int = 16) -> str:
    rows = sorted(j["by_span"].items(), key=lambda kv: -kv[1]["idle_s"])
    lines = [f"{'span':<22}{'idle_s':>10}{'device_s':>10}{'kernels':>9}"
             f"{'calls':>7}"]
    for n, r in rows[:top]:
        lines.append(f"{n:<22}{r['idle_s']:>10.4f}{r['device_s']:>10.4f}"
                     f"{r['kernels']:>9}{r['calls']:>7}")
    return "\n".join(lines)


def main(argv: List[str]) -> int:
    t_start = time.perf_counter()
    from perfbench import bench, harness, serve_cell, train_cell
    bench.set_cache_env()
    args = harness.parse(argv + ["--trace", "1"])
    got: List[Dict] = []

    class Kept(SpannedTrace):
        def summary(self, top: int = 10) -> Dict:
            got.append(super().summary(top))
            return got[-1]

    train_cell.DeviceTrace = serve_cell.DeviceTrace = Kept
    rc = harness.main(argv + ["--trace", "1"], t_start)
    if rc != 0 or not got:
        return rc or 1
    s = got[-1]
    j = s["spans"]
    cell = bench.cell(args.workload)
    print(table(j), file=sys.stderr, flush=True)
    print("spans " + json.dumps({
        "busy_s": s["busy_s"], "window_s": s["window_s"],
        "readings": readings(j, cell.traffic["kind"], cell.traffic),
        "join": j}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
