"""Delivery iterator, the consumer end of the carousel: the twin of
``repro/carousel/delivery.py``.

Yields fixed-size training batches *as shards land* (fine granularity:
processing starts with the first staged file), keeping ``prefetch``
batches assembled (and, with ``device_put``, their host-to-device copies
issued) ahead of the consumer.  ``coarse=True`` is the pre-iDDS
baseline: block until the whole collection is staged.

Row conservation: every row of every successfully staged shard is
delivered exactly once; the final partial batch (fewer than
``batch_rows`` rows) is emitted too, unpadded.  Shards that fail staging
terminally are skipped and recorded (``failed_shards`` /
``skipped_shards``) in both modes; if every shard failed, iteration
raises.  Deadlines use the monotonic clock.

Consumed shards are released from the DiskCache at once (pin/release per
shard), keeping the footprint at O(open shards), not O(dataset).
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.carousel.stager import Stager
from repro_torch.carousel.storage import DiskCache
from repro_torch.core import obs


@obs.spanned("delivery.device_put")
def device_put(batch: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``, dtypes kept (int32 tokens
    and labels, f32 mask).  To a CUDA device each array is copied from
    pinned host memory with ``non_blocking=True``: the copy runs on the
    current stream, so work queued after it sees the data, and PyTorch's
    pinned-memory allocator keeps the staging buffer from reuse until the
    copy is done.  On the CPU nothing is pinned."""
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            .to(device, non_blocking=True) for k, v in batch.items()}


class DeliveryIterator:
    def __init__(self, stager: Stager, cache: DiskCache, names: List[str], *,
                 batch_rows: int, coarse: bool = False,
                 device_put: Optional[Callable[[Dict[str, np.ndarray]],
                                               Any]] = None,
                 prefetch: int = 2, timeout: float = 120.0):
        self.stager = stager
        self.cache = cache
        self.names = list(names)
        self.batch_rows = batch_rows
        self.coarse = coarse
        self.device_put = device_put
        self.prefetch = max(1, prefetch)
        self.timeout = timeout
        self.first_batch_at: Optional[float] = None   # monotonic
        self.started_at: Optional[float] = None       # monotonic
        self.batches_delivered = 0
        self.rows_delivered = 0
        self.rows_received = 0  # rows of the shards taken from the cache
        self.failed_shards = 0
        self.skipped_shards: List[str] = []

    def _record_failed(self, failed) -> None:
        self.failed_shards += len(failed)
        self.skipped_shards.extend(sorted(failed))
        if self.names and self.failed_shards >= len(self.names):
            raise RuntimeError(
                f"all {len(self.names)} shards failed staging: "
                f"{self.skipped_shards[:5]}")

    # -- shard arrival order (fine mode consumes in landing order) ----------
    def _iter_ready_shards(self) -> Iterator[str]:
        remaining = set(self.names)
        deadline = time.monotonic() + self.timeout
        if self.coarse:
            # baseline: wait for the ENTIRE collection before any delivery
            if not self.stager.wait(timeout=self.timeout):
                raise TimeoutError("coarse staging timed out")
            failed = set(self.stager.failed()) & remaining
            if failed:
                # skip with a record, as fine mode does (and raise when
                # nothing at all survived staging)
                remaining -= failed
                self._record_failed(failed)
            for n in self.names:
                if n in remaining and n in self.cache:
                    remaining.discard(n)
                    yield n
            return
        while remaining:
            self.stager.hedge_check()
            landed = [n for n in list(remaining) if n in self.cache]
            for n in landed:
                remaining.discard(n)
                yield n
            if not landed:
                failed = set(self.stager.failed()) & remaining
                if failed:
                    remaining -= failed  # skip terminally failed shards
                    self._record_failed(failed)
                if not remaining:
                    return
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "fine staging timed out; missing "
                        f"{sorted(remaining)[:5]}")
                time.sleep(0.002)

    # -- batch assembly -------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, Any]]:
        """The batches; each resumption up to the next batch is a span
        ``delivery.next`` while the recorder is on."""
        batches = self._batches()
        while True:
            with obs.span("delivery.next"):
                b = next(batches, None)
            if b is None:
                return
            yield b

    def _batches(self) -> Iterator[Dict[str, Any]]:
        self.started_at = time.monotonic()
        rows: Dict[str, List[np.ndarray]] = collections.defaultdict(list)
        n_rows = 0
        pending: collections.deque = collections.deque()

        def emit(batch_np: Dict[str, np.ndarray]):
            out = (self.device_put(batch_np) if self.device_put is not None
                   else batch_np)
            pending.append(out)

        def drain(force: bool = False):
            while pending and (force or len(pending) >= self.prefetch):
                b = pending.popleft()
                if self.first_batch_at is None:
                    self.first_batch_at = time.monotonic()
                self.batches_delivered += 1
                yield b

        for name in self._iter_ready_shards():
            self.cache.pin(name)
            shard = self.cache.get(name)
            for k, v in shard.items():
                rows[k].append(v)
            got = next(iter(shard.values())).shape[0]
            n_rows += got
            self.rows_received += got
            self.cache.release(name, drop=True)  # prompt release

            while n_rows >= self.batch_rows:
                batch = {k: np.concatenate(v) for k, v in rows.items()}
                head = {k: v[:self.batch_rows] for k, v in batch.items()}
                tail = {k: v[self.batch_rows:] for k, v in batch.items()}
                rows = collections.defaultdict(list)
                for k, v in tail.items():
                    if v.shape[0]:
                        rows[k].append(v)
                n_rows -= self.batch_rows
                self.rows_delivered += self.batch_rows
                emit(head)
                yield from drain()
        if n_rows > 0:
            # the final partial batch: without it, delivered rows !=
            # staged rows whenever they are not a multiple of batch_rows
            batch = {k: np.concatenate(v) for k, v in rows.items()}
            self.rows_delivered += n_rows
            emit(batch)
        yield from drain(force=True)
