"""Observation for the port: the span recorder of the compute path, and
the two pieces of ``repro/core/obs.py`` that the stager uses (the exact
rolling percentile behind its hedge median, and its logger).  The
service half's metrics registry, tracer and logging set-up are not
copied: the span recorder takes their place.

Spans.  ``span(name)`` is a context around one piece of the step or the
serving path (``train.step``, ``train.forward``, ``block.decoder``,
``serve.decode``, ...).  While the recorder is off it is one shared null
context after one module-global check: no clock is read, nothing is
allocated and no hook is registered.  ``start()`` turns the recorder on;
``stop()`` turns it off and returns the spans it recorded, each with its
name, id, parent id, the id of its root (the step or batch it belongs
to), the native id of its thread, and its start and end in ns on the
Unix epoch clock that ``torch.profiler``'s (kineto's) events carry, so
that a device trace taken over the same time can put its operations
down to the spans by time and thread.  Spans stay in memory: they are
not entered into the profiler (a ``record_function`` range would add
device-side annotations to the trace).

A thread opening a span with none of its own open takes as its parent
the innermost span open on the thread that called ``start()``: the
backward, and remat's recompute inside it, run on autograd's device
thread on CUDA, and their spans then lie under ``train.backward``.
``grad_span`` times a block's backward with two tensor hooks.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import logging
import threading
import time
from bisect import bisect_left, insort
from typing import Dict, List, Optional

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


class Span:
    """One recorded span; ``end_ns`` is None while it is open."""

    __slots__ = ("name", "id", "parent", "root", "tid", "start_ns",
                 "end_ns")

    def __init__(self, name: str, id: int, parent: Optional["Span"],
                 tid: int, start_ns: int):
        self.name, self.id, self.tid, self.start_ns = name, id, tid, start_ns
        self.parent = None if parent is None else parent.id
        self.root = id if parent is None else parent.root
        self.end_ns: Optional[int] = None

    def as_dict(self) -> Dict:
        return {k: getattr(self, k) for k in self.__slots__}


class _Recorder:
    """The spans of one ``start()`` .. ``stop()``: a stack of open spans
    a thread, and every span in the order it was opened."""

    def __init__(self):
        self.main = threading.get_native_id()
        self.stacks: Dict[int, List[Span]] = {self.main: []}
        self.spans: List[Span] = []
        self.ids = itertools.count(1)
        self.hooked: set = set()  # ids of the spans grad_span opened
        # perf_counter_ns is monotonic and fine-grained; the offset puts
        # it on the epoch clock of time.time_ns(), which kineto uses
        self.offset = time.time_ns() - time.perf_counter_ns()

    def open(self, name: str) -> Span:
        tid = threading.get_native_id()
        stack = self.stacks.get(tid)
        if stack is None:
            stack = self.stacks[tid] = []
        main = self.stacks[self.main]
        parent = stack[-1] if stack else (main[-1] if main else None)
        s = Span(name, next(self.ids), parent, tid,
                 time.perf_counter_ns() + self.offset)
        stack.append(s)
        self.spans.append(s)
        return s

    def close(self, s: Span) -> None:
        if s.end_ns is not None:
            return
        s.end_ns = time.perf_counter_ns() + self.offset
        stack = self.stacks[s.tid]
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)

    def close_hooked(self) -> None:
        """Closes this thread's innermost open span if ``grad_span``
        opened it."""
        stack = self.stacks.get(threading.get_native_id())
        if stack and stack[-1].id in self.hooked:
            self.close(stack[-1])

    def finish(self) -> List[Dict]:
        now = time.perf_counter_ns() + self.offset
        for s in self.spans:
            if s.end_ns is None:
                s.end_ns = now
        return [s.as_dict() for s in self.spans]


class _Open:
    __slots__ = ("rec", "name", "span")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> Span:
        self.span = self.rec.open(self.name)
        return self.span

    def __exit__(self, *exc) -> None:
        self.rec.close(self.span)


NULL = contextlib.nullcontext()
_recorder: Optional[_Recorder] = None  # set between start() and stop()


def span(name: str):
    """A context recording span ``name`` while the recorder is on; the
    shared ``NULL`` context while it is off."""
    return NULL if _recorder is None else _Open(_recorder, name)


def spanned(name: str):
    """Decorates a function so that each call is a span ``name`` while
    the recorder is on."""
    def wrap(f):
        @functools.wraps(f)
        def call(*args, **kwargs):
            if _recorder is None:
                return f(*args, **kwargs)
            with _Open(_recorder, name):
                return f(*args, **kwargs)
        return call
    return wrap


def start() -> None:
    """Turns the recorder on, with no spans (again, if it was on)."""
    global _recorder
    _recorder = _Recorder()


def stop() -> List[Dict]:
    """Turns the recorder off and returns its spans as dicts (``name``,
    ``id``, ``parent``, ``root``, ``tid``, ``start_ns``, ``end_ns``) in
    the order they were opened; a span still open ends now.  Empty when
    the recorder was off."""
    global _recorder
    rec, _recorder = _recorder, None
    return [] if rec is None else rec.finish()


def grad_span(name: str, x, out) -> None:
    """While recording, a span ``name`` over the backward of the code that
    made ``out`` from ``x``: a hook on ``out``'s gradient opens it and one
    on ``x``'s closes it.  Where ``x`` is the ``out`` of the block before
    (the residual stream), that block's hook runs first on the shared
    tensor and closes this span as it opens its own."""
    rec = _recorder
    if rec is None or not (x.requires_grad and out.requires_grad):
        return
    held: List[Span] = []

    def opened(_g) -> None:
        rec.close_hooked()
        held.append(rec.open(name))
        rec.hooked.add(held[-1].id)

    def closed(_g) -> None:
        if held:
            rec.close(held.pop())
    out.register_hook(opened)
    x.register_hook(closed)
