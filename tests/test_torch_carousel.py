"""The port's Data Carousel (``repro_torch.carousel``, ``repro_torch.data``)
on the CPU: twins of the trainer-facing cases of tests/test_carousel.py,
and the same corpus, packing and delivery through both packages.

Skipped shards are compared as a set: fine mode records the failures in
the order it sees them, which depends on the stager's threads.
"""
import time

import numpy as np
import pytest
import torch

from repro.carousel.delivery import DeliveryIterator as JDelivery
from repro.carousel.stager import Stager as JStager
from repro.carousel.storage import DiskCache as JDiskCache
from repro.carousel.transform import make_packing_transform as j_transform
from repro.carousel.transform import pack_documents as j_pack
from repro.core import messaging as JM
from repro.core.obs import RollingPercentile as JRollingPercentile
from repro.data.synthetic import build_cold_store as j_build
from repro_torch.carousel import (ColdStore, DeliveryIterator, DiskCache,
                                  Stager, TapeFile)
from repro_torch.carousel import stager as tstager
from repro_torch.carousel.delivery import device_put
from repro_torch.carousel.storage import CacheFullError
from repro_torch.carousel.transform import (make_packing_transform,
                                            pack_documents)
from repro_torch.core.obs import RollingPercentile
from repro_torch.data.synthetic import build_cold_store, synth_docs

# ---------------------------------------------------------------- DiskCache


def test_cache_pin_release_evict():
    c = DiskCache(100)
    c.put("a", b"x", 40, pin=True)
    c.put("b", b"y", 40, pin=True)
    with pytest.raises(CacheFullError):
        c.put("c", b"z", 40, pin=True)  # nothing evictable
    c.release("a")                       # now LRU-evictable
    c.put("c", b"z", 40, pin=True)
    assert "a" not in c and "b" in c and "c" in c
    assert c.evictions == 1
    assert c.peak_bytes == 80


def test_cache_prompt_release_frees_immediately():
    c = DiskCache(100)
    c.put("a", b"x", 60, pin=True)
    c.release("a", drop=True)
    assert c.used == 0 and "a" not in c


# ---------------------------------------------------------------- Stager


class _Bus:
    def __init__(self):
        self.seen = []

    def publish(self, topic, payload):
        self.seen.append((topic, payload))


def test_stager_stages_all_and_announces():
    cold = ColdStore(drives=4)
    for i in range(10):
        cold.add(TapeFile(f"f{i}", size=10, payload=np.arange(i + 1)))
    cache = DiskCache(10_000)
    seen = []
    bus = _Bus()
    st = Stager(cold, cache, bus, workers=4,
                on_available=lambda n: seen.append(n))
    st.submit_all([f"f{i}" for i in range(10)])
    assert st.wait(timeout=10)
    assert sorted(seen) == [f"f{i}" for i in range(10)]
    assert all(f"f{i}" in cache for i in range(10))
    # the DDM's topic, the same string as the service half's
    assert tstager.T_COLLECTION_UPDATED == JM.T_COLLECTION_UPDATED
    assert sorted(p["file"] for t, p in bus.seen
                  if t == JM.T_COLLECTION_UPDATED) == sorted(seen)
    st.shutdown()


def test_stager_retries_tape_faults():
    cold = ColdStore(drives=2, fault_rate=0.5, seed=42)
    for i in range(8):
        cold.add(TapeFile(f"f{i}", size=1, payload=i))
    cache = DiskCache(10_000)
    st = Stager(cold, cache, workers=2, max_attempts=20, backoff=0.001)
    st.submit_all([f"f{i}" for i in range(8)])
    assert st.wait(timeout=30)
    assert st.failed() == []
    assert cold.failed_reads > 0  # faults happened and were retried
    assert cold.reads == sum(r.attempts for r in st.records.values())
    st.shutdown()


def test_stager_no_backoff_sleep_after_final_attempt():
    """A terminally failing file is marked failed right after its last
    attempt, not one backoff interval later.  Timed from the reads
    themselves, so a loaded machine does not move the bounds."""
    class TimedStore(ColdStore):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.read_at = []

        def read(self, name):
            self.read_at.append(time.monotonic())
            return super().read(name)  # fault_rate 1: always raises

    cold = TimedStore(drives=1, fault_rate=1.0, seed=0)
    cold.add(TapeFile("f0", size=1, payload=b"x"))
    cache = DiskCache(100)
    bus = _Bus()
    st = Stager(cold, cache, bus, workers=1, max_attempts=3, backoff=0.2)
    st.submit("f0")
    assert st.wait(timeout=5, hedge_interval=0.005)
    r0, r1, r2 = cold.read_at
    # backoff 0.2, then 0.4, between the attempts
    assert r1 - r0 >= 0.2 and r2 - r1 >= 0.4, cold.read_at
    # a sleep after the last attempt would add 0.8 s; half of it bounds
    assert st.records["f0"].finished - r2 < 0.4, (
        st.records["f0"].finished, r2)
    assert st.failed() == ["f0"]
    assert st.records["f0"].attempts == 3
    assert bus.seen == [(JM.T_COLLECTION_UPDATED,
                         {"collection": "carousel", "file": "f0",
                          "failed": True})]
    st.shutdown()


def test_stager_latency_window_bounded():
    cold = ColdStore(drives=4)
    n = 40
    for i in range(n):
        cold.add(TapeFile(f"f{i}", size=1, payload=i))
    cache = DiskCache(10_000)
    st = Stager(cold, cache, workers=4, latency_window=16)
    st.submit_all([f"f{i}" for i in range(n)])
    assert st.wait(timeout=10)
    assert len(st._latencies) <= 16  # rolling window, not unbounded
    window = st._latencies
    assert st._lat_window._sorted == sorted(window)
    assert st._median_latency() == sorted(window)[len(window) // 2]
    assert [n for n, _ in st.drain_latencies()] and not st.drain_latencies()
    st.shutdown()


def test_stager_hedges_an_overdue_file_once():
    cold = ColdStore(drives=2, mount_latency=0.05)
    cold.add(TapeFile("slow", size=1, payload=1))
    cache = DiskCache(100)
    st = Stager(cold, cache, workers=2)
    st.submit("slow")
    assert st.hedge_overdue(0.0) == 1
    assert st.hedge_overdue(0.0) == 0  # a record hedges at most once
    assert st.wait(timeout=5)
    assert st.hedges_issued == 1 and st.records["slow"].hedged
    assert "slow" in cache and st.failed() == []
    st.shutdown()


def test_stager_transform_applied():
    cold = ColdStore(drives=2)
    docs = synth_docs(0, 8, vocab_size=64, mean_len=20)
    cold.add(TapeFile("s0", size=100, payload=docs))
    cache = DiskCache(10_000)
    st = Stager(cold, cache, transform=make_packing_transform(16))
    st.submit("s0")
    assert st.wait(timeout=10)
    packed = cache.get("s0")
    assert packed["tokens"].shape[1] == 16
    assert packed["tokens"].dtype == np.int32
    assert packed["labels"].dtype == np.int32
    assert packed["loss_mask"].dtype == np.float32
    st.shutdown()


def test_rolling_percentile_matches_the_service_half():
    rng = np.random.default_rng(5)
    mine, ref = RollingPercentile(window=32), JRollingPercentile(window=32)
    for v in rng.exponential(size=100).round(3):  # ties included
        mine.observe(v)
        ref.observe(v)
        assert mine.median() == ref.median()
        assert mine.percentile(95) == ref.percentile(95)
    assert mine.values() == ref.values() and len(mine) == 32
    with pytest.raises(ValueError):
        RollingPercentile(window=0)


# ---------------------------------------------------------------- transform


def test_packing_shapes_and_labels():
    docs = [np.arange(2, 12, dtype=np.int32), np.arange(2, 7, dtype=np.int32)]
    out = pack_documents(docs, seq_len=8, pad_id=0, eod_id=1)
    T, L, M = out["tokens"], out["labels"], out["loss_mask"]
    assert T.shape == L.shape == M.shape and T.shape[1] == 8
    assert (L[0][:-1] == T[0][1:]).all()  # next-token labels
    assert set(np.unique(M)) <= {0.0, 1.0}
    for r, c in zip(*np.where(T == 1)):
        assert M[r, c] == 0.0  # predicting across a boundary is masked


def test_packing_mask_matches_stream_validity():
    docs = [np.arange(2, 30, dtype=np.int32)]
    out = pack_documents(docs, seq_len=16)
    assert out["loss_mask"].sum() > 0


@pytest.mark.parametrize("seq_len", [1, 8, 17, 64])
def test_packing_matches_the_jax_package(seq_len):
    cases = [[np.arange(2, 12, dtype=np.int32),
              np.arange(2, 7, dtype=np.int32)], [],
             synth_docs(3, 16, 1000, 40), [np.array([5], np.int32)] * 9]
    tf, jtf = make_packing_transform(seq_len), j_transform(seq_len)
    for docs in cases:
        for got, want in ((pack_documents(docs, seq_len),
                           j_pack(docs, seq_len)),
                          (tf("s", docs), jtf("s", docs))):
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_cold_store_matches_the_jax_package():
    kw = dict(n_shards=5, docs_per_shard=6, vocab_size=500, mean_doc_len=40,
              seed=3)
    mine, ref = build_cold_store(**kw), j_build(**kw)
    assert [f.name for f in mine.files()] == [f.name for f in ref.files()]
    for a, b in zip(mine.files(), ref.files()):
        assert a.size == b.size
        da, db = a.read(), b.read()
        assert len(da) == len(db) == 6
        for x, y in zip(da, db):
            assert x.dtype == y.dtype == np.int32
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- delivery


def _mk_pipeline(n_shards=6, capacity=1 << 30):
    cold = build_cold_store(n_shards=n_shards, docs_per_shard=8,
                            vocab_size=64, mean_doc_len=32, drives=2,
                            mount_latency=0.002)
    cache = DiskCache(capacity)
    names = [f.name for f in cold.files()]
    st = Stager(cold, cache, transform=make_packing_transform(16), workers=2)
    st.submit_all(names)
    return st, cache, names


def test_delivery_fine_yields_batches():
    st, cache, names = _mk_pipeline()
    it = DeliveryIterator(st, cache, names, batch_rows=4)
    batches = list(it)
    assert batches, "no batches delivered"
    for b in batches[:-1]:
        assert b["tokens"].shape == (4, 16)
        assert set(b) == {"tokens", "labels", "loss_mask"}
    # the final batch may be the partial tail; never empty, never over
    assert 1 <= batches[-1]["tokens"].shape[0] <= 4
    assert it.rows_delivered == sum(b["tokens"].shape[0] for b in batches)
    assert it.rows_received == it.rows_delivered
    assert cache.stats()["entries"] == 0  # prompt release
    st.shutdown()


def test_delivery_emits_final_partial_batch():
    """Row conservation: delivered rows == staged rows when they are not a
    multiple of batch_rows."""
    cold = ColdStore(drives=2)
    rows_per_shard = 5
    for i in range(3):  # 15 rows, batch_rows=4 -> 4+4+4+3
        cold.add(TapeFile(f"s{i}", size=10, payload={
            "x": np.arange(rows_per_shard * 2).reshape(rows_per_shard, 2)}))
    cache = DiskCache(1 << 20)
    st = Stager(cold, cache, workers=2)
    names = [f"s{i}" for i in range(3)]
    st.submit_all(names)
    it = DeliveryIterator(st, cache, names, batch_rows=4)
    sizes = [b["x"].shape[0] for b in it]
    assert sizes == [4, 4, 4, 3]
    assert sum(sizes) == 3 * rows_per_shard == it.rows_delivered
    st.shutdown()


def test_delivery_coarse_waits_then_yields():
    st, cache, names = _mk_pipeline()
    it = DeliveryIterator(st, cache, names, batch_rows=4, coarse=True)
    batches = list(it)
    assert batches
    assert it.first_batch_at is not None
    assert it.failed_shards == 0
    assert all(r.finished is not None for r in st.records.values())
    st.shutdown()


def _mk_faulty(n_shards=4, fault_rate=1.0, seed=0):
    cold = ColdStore(drives=2, fault_rate=fault_rate, seed=seed)
    rows = 4
    for i in range(n_shards):
        cold.add(TapeFile(f"s{i}", size=10, payload={
            "x": np.arange(rows * 2).reshape(rows, 2)}))
    cache = DiskCache(1 << 20)
    st = Stager(cold, cache, workers=2, max_attempts=2, backoff=0.001)
    names = [f"s{i}" for i in range(n_shards)]
    st.submit_all(names)
    return st, cache, names


@pytest.mark.parametrize("coarse", [False, True])
def test_delivery_all_failed_shards_raise(coarse):
    st, cache, names = _mk_faulty(fault_rate=1.0)
    it = DeliveryIterator(st, cache, names, batch_rows=4, coarse=coarse,
                          timeout=20)
    with pytest.raises(RuntimeError, match="failed staging"):
        list(it)
    assert it.failed_shards == len(names)
    st.shutdown()


@pytest.mark.parametrize("coarse", [False, True])
def test_delivery_partial_failure_is_recorded(coarse):
    """Some shards fail terminally: the survivors are delivered and the
    skips are recorded, in both modes."""
    cold = ColdStore(drives=2)
    rows = 4
    for i in range(4):
        cold.add(TapeFile(f"s{i}", size=10, payload={
            "x": np.arange(rows * 2).reshape(rows, 2)}))
    cache = DiskCache(1 << 20)
    real_read = cold.read

    def read(name):  # s1 and s3 are unreadable, the rest stage fine
        if name in ("s1", "s3"):
            raise IOError(f"tape read error on {name}")
        return real_read(name)

    cold.read = read
    st = Stager(cold, cache, workers=2, max_attempts=2, backoff=0.001)
    names = [f"s{i}" for i in range(4)]
    st.submit_all(names)
    it = DeliveryIterator(st, cache, names, batch_rows=4, coarse=coarse,
                          timeout=20)
    batches = list(it)
    assert it.failed_shards == 2
    assert set(it.skipped_shards) == {"s1", "s3"}
    assert len(it.skipped_shards) == 2
    assert sum(b["x"].shape[0] for b in batches) == 2 * rows
    st.shutdown()


def test_delivery_fine_starts_before_all_staged():
    """Fine mode delivers its first batch while later shards are still on
    'tape'."""
    cold = build_cold_store(n_shards=8, docs_per_shard=8, vocab_size=64,
                            mean_doc_len=32, drives=1, mount_latency=0.03)
    cache = DiskCache(1 << 30)
    names = [f.name for f in cold.files()]
    st = Stager(cold, cache, transform=make_packing_transform(16), workers=1)
    st.submit_all(names)
    it = DeliveryIterator(st, cache, names, batch_rows=2, prefetch=1)
    first = next(iter(it))
    assert first["tokens"].shape == (2, 16)
    pending = [r for r in st.records.values() if r.finished is None]
    assert pending, "first batch should arrive before staging completes"
    st.shutdown()


def test_delivery_device_put_keeps_dtypes_and_does_not_pin_on_cpu():
    st, cache, names = _mk_pipeline(n_shards=2)
    put = lambda b: device_put(b, torch.device("cpu"))  # noqa: E731
    it = DeliveryIterator(st, cache, names, batch_rows=3, device_put=put)
    batches = list(it)
    assert batches and it.rows_delivered == sum(
        b["tokens"].shape[0] for b in batches)
    for b in batches:
        assert b["tokens"].dtype == b["labels"].dtype == torch.int32
        assert b["loss_mask"].dtype == torch.float32
        assert not any(t.is_pinned() for t in b.values())
    st.shutdown()


@pytest.mark.parametrize("coarse", [False, True])
def test_delivery_matches_the_jax_package(coarse):
    """One worker, no faults, the same corpus: both packages' iterators
    yield the same batches.  Fine mode starts after staging ends, so both
    see every shard landed at their first poll."""
    kw = dict(n_shards=5, docs_per_shard=8, vocab_size=300, mean_doc_len=24,
              drives=1, seed=7)
    out = []
    for build, cache_t, stager_t, deliv_t, tf in (
            (build_cold_store, DiskCache, Stager, DeliveryIterator,
             make_packing_transform),
            (j_build, JDiskCache, JStager, JDelivery, j_transform)):
        cold = build(**kw)
        cache = cache_t(1 << 30)
        names = [f.name for f in cold.files()]
        st = stager_t(cold, cache, workers=1, transform=tf(16))
        st.submit_all(names)
        assert st.wait(timeout=20)
        it = deliv_t(st, cache, names, batch_rows=3, coarse=coarse)
        out.append((list(it), it.rows_delivered))
        st.shutdown()
    (mine, n_mine), (ref, n_ref) = out
    assert n_mine == n_ref and len(mine) == len(ref) > 2
    assert mine[-1]["tokens"].shape[0] <= 3
    for a, b in zip(mine, ref):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
