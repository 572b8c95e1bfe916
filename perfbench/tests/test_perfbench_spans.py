"""The join of the program's spans with the device trace
(``perfbench/spans.py``), over synthetic kineto events and spans: a
device operation goes to the innermost span open on its launching
thread (found by correlation id), counts for every span above it, and
overlapping operations count once; idle gaps go to the main thread's
innermost span, or outside; ``SpannedTrace.summary`` keeps every key of
``DeviceTrace.summary`` as it is."""
import pytest
import torch

from perfbench import spans as J
from perfbench.devtrace import DeviceTrace

MAIN, BWD = 100, 200  # the recorder's (OS) thread ids
P_MAIN, P_BWD = 1, 2  # the profiler's numbers of the same threads


class Ev:
    """What the join reads of a kineto event."""

    def __init__(self, name, start, end, corr, *, device=False, tid=P_MAIN):
        self._n, self._a, self._b, self._c = name, start, end, corr
        self._dev, self._tid = device, tid

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._tid


def kernel(corr, launch_at, start, end, tid=P_MAIN, name="k"):
    """A launch on ``tid`` at ``launch_at`` and its kernel."""
    return [Ev("cudaLaunchKernel", launch_at, launch_at + 1, corr, tid=tid),
            Ev(name, start, end, corr, device=True)]


def span(i, name, a, b, parent=None, tid=MAIN, root=None):
    return {"name": name, "id": i, "parent": parent, "tid": tid,
            "root": root or i, "start_ns": a, "end_ns": b}


SPANS = [
    span(1, "train.step", 0, 1000),
    span(2, "train.forward", 10, 300, 1, root=1),
    span(3, "block.decoder", 20, 280, 2, root=1),
    span(4, "train.backward", 300, 800, 1, root=1),
    span(5, "loss.ce_bwd", 310, 400, 4, tid=BWD, root=1),
    span(6, "block.decoder.bwd", 410, 790, 4, tid=BWD, root=1),
    span(7, "block.decoder", 420, 500, 6, tid=BWD, root=1),
    span(8, "train.optimizer", 800, 990, 1, root=1),
]

EVENTS = (
    kernel(1, 5, 6, 20)                          # train.step itself
    + kernel(2, 30, 40, 100)                     # block.decoder (fwd)
    + kernel(3, 40, 90, 150)                     # overlaps the one above
    + kernel(4, 320, 330, 380, tid=P_BWD)        # loss.ce_bwd
    + kernel(5, 430, 440, 470, tid=P_BWD)        # recompute in the bwd
    + kernel(6, 600, 600, 700, tid=P_BWD)        # block.decoder.bwd
    + kernel(7, 810, 810, 900)                   # train.optimizer
    + kernel(8, 995, 995, 1000)                  # after the optimizer
    + kernel(9, 1100, 1100, 1110)                # after every span
    + [Ev("aten::mm", 30, 31, 2)]                # a CPU op, same corr id
)


def _join():
    ops, launches = J.trace_rows(EVENTS)
    return J.join(ops, launches, SPANS, MAIN,
                  groups={"decoder": ("block.decoder", "block.decoder.bwd")})


def test_rows_are_device_ops_and_their_launches():
    ops, launches = J.trace_rows(EVENTS)
    assert len(ops) == 9 and sorted(launches) == list(range(1, 10))
    assert launches[2] == (P_MAIN, 30)  # not the CPU op's id
    assert launches[4] == (P_BWD, 320)


def test_operations_go_to_the_launching_threads_innermost_span():
    by = _join()["by_span"]
    # launched on the backward thread while the main thread's innermost
    # is train.backward: the thread's own span takes it
    assert by["loss.ce_bwd"]["kernels"] == 1
    assert by["loss.ce_bwd"]["device_s"] == pytest.approx(50e-9)
    assert by["block.decoder.bwd"]["kernels"] == 2  # recompute + its own
    assert by["train.backward"]["kernels"] == 3


def test_nesting_and_union_of_overlapping_kernels():
    by = _join()["by_span"]
    # fwd kernels [40, 100) and [90, 150) union to 110 ns, + recompute 30
    assert by["block.decoder"]["kernels"] == 3
    assert by["block.decoder"]["device_s"] == pytest.approx(140e-9)
    assert by["train.forward"]["device_s"] == pytest.approx(110e-9)
    assert by["train.step"]["kernels"] == 8
    assert by["decoder"]["device_s"] == pytest.approx(240e-9)
    assert by["outside spans"]["kernels"] == 1


def test_idle_goes_to_the_main_threads_innermost_span():
    j = _join()
    by = j["by_span"]
    # gaps: 20-40, 150-330 (block.decoder, open on the main thread until
    # 280), 380-440, 470-600, 700-810 (train.backward), 900-995
    # (train.optimizer), 1000-1100 (outside)
    assert by["block.decoder"]["idle_s"] == pytest.approx(200e-9)
    assert by["train.forward"]["idle_s"] == 0.0
    assert by["train.backward"]["idle_s"] == pytest.approx(300e-9)
    assert by["train.optimizer"]["idle_s"] == pytest.approx(95e-9)
    assert by["outside spans"]["idle_s"] == pytest.approx(100e-9)
    assert j["busy_s"] == pytest.approx((14 + 110 + 50 + 30 + 100 + 90 + 5
                                         + 10) * 1e-9)
    assert j["in_spans_s"] == pytest.approx(j["busy_s"] - 10e-9)
    assert j["launches"] == {"thread": 9}
    # train.optimizer's 190 ns hold 90 on the device
    assert by["train.optimizer"]["idle_in_s"] == pytest.approx(100e-9)


def test_profiler_threads_map_to_the_recorders():
    ops, launches = J.trace_rows(EVENTS)
    got = J._thread_map(list(launches.values()), SPANS, MAIN)
    assert got == {P_MAIN: MAIN, P_BWD: BWD}


def test_a_launch_between_a_threads_spans_goes_to_the_main_thread():
    # the backward thread launches between loss.ce_bwd and the first
    # block's backward: the main thread's innermost, train.backward
    ev = EVENTS + kernel(10, 405, 405, 408, tid=P_BWD)
    j = J.join(*J.trace_rows(ev), SPANS, MAIN)
    assert j["launches"] == {"thread": 9, "main": 1}
    assert j["by_span"]["train.backward"]["kernels"] == 4
    assert j["by_span"]["loss.ce_bwd"]["kernels"] == 1
    assert j["by_span"]["block.decoder.bwd"]["kernels"] == 2


def test_a_thread_no_other_span_holds_goes_to_the_main_thread():
    ops, launches = J.trace_rows(kernel(1, 850, 850, 860, tid=7))
    j = J.join(ops, launches, SPANS, MAIN)
    assert j["launches"] == {"thread": 1}
    assert j["by_span"]["train.optimizer"]["kernels"] == 1
    assert j["by_span"]["train.backward"]["kernels"] == 0


def test_readings():
    train = {"trace_steps": 2}
    j = J.join(*J.trace_rows(EVENTS), SPANS, MAIN,
               groups={"mamba": J.GROUPS["mamba"]})
    got = J.readings(j, "train", train)
    assert got == {"optimizer_ms.train": pytest.approx(90e-6 / 2),
                   "ce_bwd_ms.train": pytest.approx(50e-6 / 2)}
    dec = [span(1, "serve.decode", 0, 100), span(2, "serve.decode", 200, 300)]
    ev = kernel(1, 10, 20, 60) + kernel(2, 30, 50, 70) + kernel(3, 210, 220,
                                                                 240)
    j = J.join(*J.trace_rows(ev), dec, MAIN)
    got = J.readings(j, "serve", {})
    assert got["decode_launches.serve"] == pytest.approx(1.5)
    assert got["decode_idle.serve"] == pytest.approx(100 * (200 - 70) / 200)


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": lambda _self: list(events)})()})()


def test_summary_keeps_every_key_of_the_base():
    base = DeviceTrace(torch.device("cuda"))
    spanned = J.SpannedTrace(torch.device("cuda"))
    for t in (base, spanned):
        t.prof, t.t0, t.t1 = _Prof(EVENTS), 0.0, 1.25e-6
    spanned.spans = SPANS
    a, b = base.summary(), spanned.summary()
    assert set(b) == set(a) | {"spans"}
    assert {k: b[k] for k in a} == a
    assert b["spans"]["busy_s"] == pytest.approx(a["busy_s"])
