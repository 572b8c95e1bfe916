"""Storage tiers of the Data Carousel, the twin of
``repro/carousel/storage.py``: ColdStore (the tape system) and DiskCache
(the staging pool).

ColdStore's read latency models a tape library: mount/seek latency plus
size/bandwidth, with a limited number of drives (concurrent reads) and a
seeded fault and straggler draw per read.

DiskCache is the bounded staging pool the carousel keeps small: files
are pinned while a consumer processes them and *promptly released*
afterwards; eviction only reclaims released files (LRU).  ``peak_bytes``
and the residence integral are the paper's Fig. 5 metrics.

Standard library only: the stager's threads run this, and never touch
torch or CUDA.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass
class TapeFile:
    name: str
    size: int                      # bytes
    payload: Any = None            # the actual data (ndarray / bytes / path)
    generator: Optional[Callable[[], Any]] = None  # lazy synth data

    def read(self) -> Any:
        if self.payload is not None:
            return self.payload
        if self.generator is not None:
            return self.generator()
        return None


class ColdStore:
    """Tape-like bulk store: cheap, high-latency, few concurrent drives."""

    def __init__(self, *, drives: int = 2, mount_latency: float = 0.0,
                 bandwidth: float = float("inf"),
                 fault_rate: float = 0.0, straggler_frac: float = 0.0,
                 straggler_mult: float = 10.0, seed: int = 0):
        self._files: Dict[str, TapeFile] = {}
        self._drives = threading.Semaphore(drives)
        self.n_drives = drives
        self.mount_latency = mount_latency
        self.bandwidth = bandwidth
        self.fault_rate = fault_rate
        self.straggler_frac = straggler_frac   # per-READ tail latency
        self.straggler_mult = straggler_mult
        self._rnd = random.Random(seed)
        # guards the draws and the two counters (drives read concurrently)
        self._rnd_lock = threading.Lock()
        self.reads = 0
        self.failed_reads = 0

    def add(self, f: TapeFile) -> None:
        self._files[f.name] = f

    def files(self) -> List[TapeFile]:
        return list(self._files.values())

    def get(self, name: str) -> TapeFile:
        return self._files[name]

    def stage_latency(self, f: TapeFile) -> float:
        return self.mount_latency + (f.size / self.bandwidth
                                     if self.bandwidth != float("inf")
                                     else 0.0)

    def read(self, name: str) -> Any:
        """Blocking staged read through a tape drive (real-time mode)."""
        f = self._files[name]
        with self._drives:
            with self._rnd_lock:
                fail = self._rnd.random() < self.fault_rate
                slow = self._rnd.random() < self.straggler_frac
            lat = self.stage_latency(f)
            if slow:
                lat *= self.straggler_mult  # tail read (per-read, so a
                # hedged duplicate re-read is most likely fast)
            if lat > 0:
                time.sleep(lat)
            with self._rnd_lock:
                self.reads += 1
                self.failed_reads += fail
            if fail:
                raise IOError(f"tape read error on {name}")
            return f.read()


class CacheFullError(Exception):
    pass


class DiskCache:
    """Bounded staging cache with pin/release + LRU eviction of released
    entries.  Tracks the Fig. 5 metrics: peak usage and byte-seconds."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._lock = threading.RLock()
        self._data: Dict[str, Any] = {}
        self._size: Dict[str, int] = {}
        self._pins: Dict[str, int] = {}
        self._lru: List[str] = []      # released entries, oldest first
        self.used = 0
        self.peak_bytes = 0
        self.evictions = 0
        self._residence_acc = 0.0      # integral of used bytes over time
        # monotonic: a wall-clock step (NTP slew) must not corrupt the
        # byte-seconds integral
        self._last_t = time.monotonic()

    def _tick(self) -> None:
        now = time.monotonic()
        self._residence_acc += self.used * (now - self._last_t)
        self._last_t = now

    @property
    def byte_seconds(self) -> float:
        with self._lock:
            self._tick()
            return self._residence_acc

    def _evict_for(self, need: int) -> bool:
        while self.used + need > self.capacity and self._lru:
            victim = self._lru.pop(0)
            self.used -= self._size.pop(victim)
            self._data.pop(victim, None)
            self._pins.pop(victim, None)
            self.evictions += 1
        return self.used + need <= self.capacity

    def put(self, name: str, data: Any, size: int, *,
            pin: bool = True) -> None:
        with self._lock:
            self._tick()
            if name in self._data:
                if pin:
                    self._pins[name] = self._pins.get(name, 0) + 1
                return
            if not self._evict_for(size):
                raise CacheFullError(
                    f"{name}: need {size}, used {self.used}/{self.capacity} "
                    f"with {len(self._lru)} evictable")
            self._data[name] = data
            self._size[name] = size
            self._pins[name] = 1 if pin else 0
            if not pin:
                self._lru.append(name)
            self.used += size
            self.peak_bytes = max(self.peak_bytes, self.used)

    def get(self, name: str) -> Any:
        with self._lock:
            return self._data[name]

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._data

    def pin(self, name: str) -> None:
        with self._lock:
            self._pins[name] = self._pins.get(name, 0) + 1
            if name in self._lru:
                self._lru.remove(name)

    def release(self, name: str, *, drop: bool = False) -> None:
        """Consumer done with the file. drop=True frees immediately (the
        carousel's prompt release); otherwise it becomes LRU-evictable."""
        with self._lock:
            if name not in self._data:
                return
            self._pins[name] = max(0, self._pins.get(name, 0) - 1)
            if self._pins[name] == 0:
                if drop:
                    self._tick()
                    self.used -= self._size.pop(name)
                    self._data.pop(name)
                    self._pins.pop(name)
                elif name not in self._lru:
                    self._lru.append(name)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            self._tick()
            return {"used": self.used, "peak_bytes": self.peak_bytes,
                    "evictions": self.evictions,
                    "byte_seconds": self._residence_acc,
                    "entries": len(self._data)}
