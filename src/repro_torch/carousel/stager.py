"""Asynchronous staging engine, the twin of ``repro/carousel/stager.py``.

Moves files ColdStore -> DiskCache on a worker pool, applying the
on-demand transformation at stage time, then announces each file's
availability on an optional bus (topic ``T_COLLECTION_UPDATED``).

Fault tolerance:
  * retries with exponential backoff on tape read errors (no backoff
    sleep after the final attempt: a terminal failure is marked, and
    announced, at once);
  * hedged (duplicate) requests for stragglers: if a file's stage time
    exceeds ``hedge_factor`` x the observed median, a second request is
    issued and the first to land wins.

All timing uses the monotonic clock.  The ``on_submitted`` /
``on_available`` / ``on_failed`` hooks let a caller follow each file's
state.  ``bus`` is any object with ``publish(topic, payload)``;
``bind_telemetry`` takes a registry with ``histogram`` and ``counter``
families and a tracer with ``emit``, as ``repro.core.obs`` gives them.
The worker threads run the cold store and the transform (numpy) only:
nothing here touches torch or CUDA.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.carousel.storage import ColdStore, DiskCache
from repro_torch.core.obs import RollingPercentile, get_logger

_log = get_logger("stager")

# the DDM's "collection updated" topic (repro/core/messaging.py)
T_COLLECTION_UPDATED = "ddm.collections.updated"


@dataclass
class StageRecord:
    name: str
    submitted: float             # monotonic
    finished: Optional[float] = None
    attempts: int = 0
    hedged: bool = False
    ok: bool = False


class Stager:
    # telemetry is optional: unbound, each hook costs one attribute
    # lookup against these class defaults
    _obs_stage_hist = None
    _obs_failures = None
    tracer = None

    def __init__(self, cold: ColdStore, cache: DiskCache,
                 bus: Optional[Any] = None, *,
                 collection: str = "carousel",
                 workers: int = 4, max_attempts: int = 4,
                 backoff: float = 0.02, hedge_factor: float = 3.0,
                 hedge_min_samples: int = 8, latency_window: int = 512,
                 transform: Optional[Callable[[str, Any], Any]] = None,
                 on_available: Optional[Callable[[str], None]] = None,
                 on_failed: Optional[Callable[[str], None]] = None,
                 on_submitted: Optional[Callable[[str], None]] = None):
        self.cold = cold
        self.cache = cache
        self.bus = bus
        self.collection = collection
        self.transform = transform
        self.on_available = on_available
        self.on_failed = on_failed
        self.on_submitted = on_submitted
        self.max_attempts = max_attempts
        self.backoff = backoff
        self.hedge_factor = hedge_factor
        self.hedge_min_samples = hedge_min_samples
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="stager")
        self._lock = threading.RLock()
        self.records: Dict[str, StageRecord] = {}
        self._landed: Dict[str, bool] = {}
        # files whose landing or failure has been announced: ``wait``
        # returns once every one is, so the caller sees the announcements
        self._settled: set = set()
        # rolling window of stage latencies: the hedge reads its median
        self._lat_window = RollingPercentile(window=latency_window)
        # landed (name, seconds) pairs awaiting drain_latencies()
        self._recent_latencies: List[Tuple[str, float]] = []
        self._futures: List[Future] = []
        self.hedges_issued = 0

    @property
    def _latencies(self) -> List[float]:
        """Arrival-ordered latency window (kept for introspection)."""
        return self._lat_window.values()

    # ------------------------------------------------------------------
    def bind_telemetry(self, registry, tracer=None) -> None:
        """Wires a metrics registry (and a tracer) into the hooks."""
        self._obs_stage_hist = registry.histogram(
            "stager_stage_seconds", "cold-to-cache staging latency",
            labels=("collection",)).labels(collection=self.collection)
        self._obs_failures = registry.counter(
            "stager_failures_total", "terminal staging failures",
            labels=("collection",)).labels(collection=self.collection)
        self.tracer = tracer

    def _median_latency(self) -> Optional[float]:
        if len(self._lat_window) < self.hedge_min_samples:
            return None
        return self._lat_window.median()

    def _land(self, name: str, data: Any, size: int) -> bool:
        """First landing wins (hedges make this racy by design)."""
        with self._lock:
            if self._landed.get(name):
                return False
            self._landed[name] = True
            rec = self.records[name]
            rec.finished = time.monotonic()
            rec.ok = True
            dt = rec.finished - rec.submitted
            attempts, hedged = rec.attempts, rec.hedged
            self._lat_window.observe(dt)
            self._recent_latencies.append((name, dt))
        if self._obs_stage_hist is not None:
            self._obs_stage_hist.observe(dt)
        self.cache.put(name, data, size, pin=False)
        # the caller's state first, the bus second: a consumer woken by
        # the announcement must observe the availability it announces
        if self.on_available is not None:
            self.on_available(name)
        if self.tracer is not None:
            self.tracer.emit("content_available",
                             collection=self.collection, entity=name,
                             data={"attempts": attempts, "hedged": hedged,
                                   "stage_s": round(dt, 6)})
        if self.bus is not None:
            self.bus.publish(T_COLLECTION_UPDATED,
                             {"collection": self.collection, "file": name})
        with self._lock:
            self._settled.add(name)
        return True

    def _stage_once(self, name: str) -> None:
        rec = self.records[name]
        for attempt in range(1, self.max_attempts + 1):
            with self._lock:
                if self._landed.get(name):
                    return
                rec.attempts += 1
            try:
                raw = self.cold.read(name)
                data = (self.transform(name, raw)
                        if self.transform is not None else raw)
                size = self.cold.get(name).size
                self._land(name, data, size)
                return
            except IOError:
                if attempt < self.max_attempts:
                    # no sleep after the FINAL attempt: the record turns
                    # failed now, not one backoff interval later
                    time.sleep(self.backoff * (2 ** (attempt - 1)))
        # exhausted: only mark failed if nobody else landed it
        with self._lock:
            if self._landed.get(name):
                return
            rec.finished = time.monotonic()
            rec.ok = False
        _log.warning("staging failed terminally: %s/%s after %d attempts",
                     self.collection, name, rec.attempts)
        if self._obs_failures is not None:
            self._obs_failures.inc()
        if self.on_failed is not None:
            self.on_failed(name)
        if self.bus is not None:
            # announce the terminal failure too, so a waiting consumer
            # re-evaluates completion instead of waiting forever
            self.bus.publish(T_COLLECTION_UPDATED,
                             {"collection": self.collection, "file": name,
                              "failed": True})
        with self._lock:
            self._settled.add(name)

    def submit(self, name: str) -> None:
        with self._lock:
            if name in self.records:
                return
            self.records[name] = StageRecord(name, time.monotonic())
        if self.on_submitted is not None:
            self.on_submitted(name)
        if self.tracer is not None:
            self.tracer.emit("content_staging",
                             collection=self.collection, entity=name)
        self._futures.append(self._pool.submit(self._stage_once, name))

    def submit_all(self, names: List[str]) -> None:
        for n in names:
            self.submit(n)

    # -- straggler hedging (call periodically, as wait() does) ----------
    def hedge_check(self) -> int:
        med = self._median_latency()
        if med is None:
            return 0
        return self.hedge_overdue(self.hedge_factor * med)

    def hedge_overdue(self, threshold_s: float) -> int:
        """Re-submits every un-hedged in-flight file older than
        ``threshold_s``; the first landing wins.  A record hedges at most
        once, so repeated calls converge."""
        now = time.monotonic()
        with self._lock:
            cands = [r for r in self.records.values()
                     if not r.finished and not r.hedged
                     and now - r.submitted > threshold_s]
            for r in cands:
                r.hedged = True
            self.hedges_issued += len(cands)
        for r in cands:
            self._futures.append(self._pool.submit(self._stage_once, r.name))
        return len(cands)

    def drain_latencies(self) -> List[Tuple[str, float]]:
        """Landed ``(name, seconds)`` pairs since the last drain."""
        with self._lock:
            out, self._recent_latencies = self._recent_latencies, []
        return out

    def wait(self, timeout: float = 60.0,
             hedge_interval: float = 0.05) -> bool:
        """Blocks until every submitted file landed or terminally failed,
        and its landing or failure was announced."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.hedge_check()
            with self._lock:
                pend = [r for r in self.records.values()
                        if r.name not in self._settled]
            if not pend:
                return True
            time.sleep(hedge_interval)
        return False

    def failed(self) -> List[str]:
        with self._lock:
            return [r.name for r in self.records.values()
                    if r.finished is not None and not r.ok]

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
