"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI)
over the first steps or batches of the window, reduced to what the
per-layer readers and the result line take: the window's length, the
seconds in which some operation ran on the device (the union of their
intervals), each kernel's device time, and the longest idle gaps by what
the host was doing."""
from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_SKIP_HOST = ("ProfilerStep", "[memory]", "PyTorch Profiler")


def _events(prof) -> List:
    return list(prof.profiler.kineto_results.events())


def _span(e) -> Tuple[float, float]:
    start = e.start_ns() * 1e-9 if hasattr(e, "start_ns") \
        else e.start_us() * 1e-6
    dur = e.duration_ns() * 1e-9 if hasattr(e, "duration_ns") \
        else e.duration_us() * 1e-6
    return start, start + dur


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class DeviceTrace:
    """Profiles between :meth:`start` and :meth:`stop` (both synchronise
    the device); :meth:`warm` once in set-up starts CUPTI there."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = 0.0

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.ones(8, device=self.device).sum().item()

    def start(self) -> None:
        from torch.profiler import profile
        self._sync()
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self, top: int = 10) -> Dict:
        dev_type = "CUDA" if self.device.type == "cuda" else "CPU"
        device, host = [], []
        for e in _events(self.prof):
            if getattr(e, "is_user_annotation", lambda: False)():
                continue  # a range over operations (NCCL's), none itself
            kind = str(e.device_type()).split(".")[-1]
            (device if kind == dev_type and self.device.type == "cuda"
             else host).append((e.name(), *_span(e)))
        busy = _union([(a, b) for _, a, b in device])
        by_name: Dict[str, float] = collections.defaultdict(float)
        for n, a, b in device:
            by_name[n] += b - a
        return {
            "window_s": self.t1 - self.t0,
            "busy_s": sum(b - a for a, b in busy),
            "kernels": dict(by_name),
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:top],
            "idle_gaps": _gaps_by_host(busy, host, top),
        }


def _gaps_by_host(busy: List[Tuple[float, float]],
                  host: List[Tuple[str, float, float]], top: int) -> List:
    """The idle gaps between device intervals, summed by the innermost
    host operation running as each began."""
    host = sorted((h for h in host if not h[0].startswith(_SKIP_HOST)),
                  key=lambda h: h[1])
    starts = [h[1] for h in host]
    by: Dict[str, float] = collections.defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(starts, end) - 1
        label = "host idle"
        for j in range(i, max(i - 400, -1), -1):
            if host[j][2] > end:
                label = host[j][0]
                break
        by[label] += nxt - end
    return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:top]


def kernel_seconds(trace: Optional[Dict], patterns: Sequence[str]) -> float:
    """Device seconds of the kernels whose names hold one of
    ``patterns``."""
    if not trace:
        return 0.0
    return sum(s for n, s in trace["kernels"].items()
               if any(p in n for p in patterns))
