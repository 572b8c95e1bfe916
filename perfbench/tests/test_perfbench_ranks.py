"""The launcher of a cell's ranks (``perfbench/ranks.py``) on the CPU,
with 2 gloo ranks and the tiny targets of ``ranked.py``: only rank 0
prints, a rank that fails ends the run at once, ranks whose clocks
disagree close the window on the same batch; and a cell over 2 ranks,
cut to smoke size, run past the harness's look for a chip: sound, and
with the timed path broken by each fault a cell split over cards can
have (the exchange between the cards left out, a token altered where it
is produced, an expert dropped from each token's route), which
``correct`` has to fail."""
import json
import subprocess
import sys
import time

import pytest

from perfbench import bench

TARGET = [sys.executable, str(bench.ROOT / "perfbench" / "tests"
                              / "ranked.py"), "--ranks"]
CELL = "mixtral-8x7b.serve.tp4"


def _launch(n, *args, timeout=120):
    return subprocess.run(TARGET + [str(n)] + list(args), capture_output=True,
                          text=True, timeout=timeout, cwd=bench.ROOT)


def test_only_rank_0_prints():
    p = _launch(2, "print")
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout == "rank 0\n"
    assert "[rank 1] rank 1" in p.stderr


def test_a_failed_rank_ends_the_run_within_seconds():
    t0 = time.perf_counter()
    p = _launch(2, "fail", timeout=60)
    assert p.returncode != 0
    assert p.stdout == ""
    assert time.perf_counter() - t0 < 30  # rank 0 would wait a minute


def test_ranks_close_the_window_on_rank_0s_clock():
    # rank 1's clock runs 100 s ahead and it would close the window at
    # once: rank 0's decision holds on both
    p = _launch(2, "window", "0.5", "100")
    assert p.returncode == 0, p.stderr[-2000:]
    counts = json.loads(p.stdout)["batches"]
    assert counts[0] == counts[1] > 5


def test_every_stderr_line_names_its_rank():
    p = _launch(2, "cell", CELL, "7")
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stderr.splitlines()
    ranked = [x for x in lines if not x.startswith("check ")]
    assert ranked and all(x.startswith(("[rank 0] ", "[rank 1] "))
                          for x in ranked)
    assert any(x.startswith("[rank 1] [perfbench") for x in lines)
    # the numbers compared come last, as the launcher prints them
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert lines[-len(res["check"]):] == [
        f"check {k}: {c['value']!r} limit {c['limit']!r}"
        for k, c in res["check"].items()]


_SOUND = {}


def _cell(fault=""):
    if fault not in _SOUND:
        p = _launch(2, "cell", CELL, "7", *([fault] if fault else []))
        assert p.returncode == 0, p.stderr[-2000:]
        assert len(p.stdout.strip().splitlines()) == 1, (p.stdout,
                                                         p.stderr[-2000:])
        _SOUND[fault] = json.loads(p.stdout)
    return _SOUND[fault]


def test_sound_run_over_two_ranks():
    res = _cell()
    assert res["device"]["count"] == 2
    assert len(res["device"]["rank_memory_peak_bytes"]) == 2
    assert list(res)[-1] == "check"
    limits = bench.cell(CELL).limits["limits"]
    assert set(res["check"]) == set(limits)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("fault", ["exchange_left_out", "token_altered",
                                   "first_token_altered", "top1"])
def test_fault_over_two_ranks_is_not_correct(fault):
    ok = _cell()["check"]
    res = _cell(fault)
    assert not res["correct"], res["check"]
    assert any(c["value"] > ok[k]["value"] and c["value"] > c["limit"]
               for k, c in res["check"].items()), (res["check"], ok)
