"""The two pieces of ``repro/core/obs.py`` that the stager uses: the
exact rolling percentile behind its hedge median, and its logger.

The metrics registry, the tracer and the logging set-up belong to the
service half and are not copied; ``Stager.bind_telemetry`` takes them
duck-typed.
"""
from __future__ import annotations

import collections
import logging
import threading
from bisect import bisect_left, insort
from typing import List, Optional

_LOG_ROOT = "repro_torch"


class RollingPercentile:
    """Exact percentile over a bounded sliding window.

    A deque keeps arrival order while a parallel sorted list is kept with
    bisect, so an observation is an O(log n) search plus a memmove on a
    small window and a percentile read is O(1), never a re-sort.
    """

    __slots__ = ("_lock", "_window", "_sorted")

    def __init__(self, window: int = 512):
        if window <= 0:
            raise ValueError("window must be positive")
        self._lock = threading.Lock()
        self._window: collections.deque = collections.deque(maxlen=window)
        self._sorted: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if len(self._window) == self._window.maxlen:
                # drop exactly one copy of the value leaving the window
                evicted = self._window[0]
                del self._sorted[bisect_left(self._sorted, evicted)]
            self._window.append(v)
            insort(self._sorted, v)

    def __len__(self) -> int:
        with self._lock:
            return len(self._sorted)

    def percentile(self, q: float) -> Optional[float]:
        """The q-th percentile (0..100) by nearest rank, or None while
        the window is empty."""
        with self._lock:
            n = len(self._sorted)
            if n == 0:
                return None
            return self._sorted[min(n - 1, int(q / 100.0 * n))]

    def median(self) -> Optional[float]:
        """Upper median (matches ``sorted(w)[len(w) // 2]``)."""
        with self._lock:
            n = len(self._sorted)
            return self._sorted[n // 2] if n else None

    def values(self) -> List[float]:
        """Arrival-ordered snapshot of the current window."""
        with self._lock:
            return list(self._window)


def get_logger(name: str) -> logging.Logger:
    """A child of the ``repro_torch`` logger tree.  Unconfigured, records
    fall through to Python's last-resort handler (WARNING and up to
    stderr), so library use stays quiet."""
    return logging.getLogger(f"{_LOG_ROOT}.{name}")
