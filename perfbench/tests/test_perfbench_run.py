"""The command itself: without the cell's CUDA devices it exits non-zero
and prints no result; on the cards (``cuda``) a short run of each cell
prints one correct result line whose last key is ``check`` (a cell of
more than one card skips on a machine with fewer), and a four-card run
with one of its ranks killed in the window ends at once, non-zero and
with no result."""
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from perfbench import bench, ranks

CMD = [sys.executable, str(bench.ROOT / "perfbench" / "run.py")]


def _run(cell, seconds, trace=0, timeout=1200):
    return subprocess.run(
        CMD + ["--workload", cell, "--seed", "2147483659", "--seconds",
               str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, timeout=timeout, cwd=bench.ROOT)


def test_no_chip_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = _run("yi-6b.serve.longprompt", 1, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  bench.load_benchmark()["workloads"]])
def test_short_run_on_the_card(cell):
    chips = bench.cell(cell).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA device(s)")
    p = _run(cell, 3)
    assert p.returncode == 0, p.stderr[-2000:]
    assert len(p.stdout.strip().splitlines()) == 1
    res = json.loads(p.stdout)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == chips
    if chips > 1:
        assert len(res["device"]["rank_memory_peak_bytes"]) == chips


def _children(pid: int):
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        return [int(x) for x in f.read().split()]


@pytest.mark.cuda
def test_a_killed_rank_ends_the_run():
    cell = next(w["name"] for w in bench.load_benchmark()["workloads"]
                if w["chips"] == 4)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    p = subprocess.Popen(
        CMD + ["--workload", cell, "--seed", "2147483671", "--seconds", "60",
               "--trace", "0"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=bench.ROOT)
    seen = []
    for line in p.stderr:
        seen.append(line)
        if line.startswith("[rank 2] [perfbench") and "warm-up" in line:
            break
    time.sleep(5)  # inside the window
    rank2 = _children(p.pid)[2]
    os.kill(rank2, signal.SIGKILL)
    t_kill = time.perf_counter()
    out, err = p.communicate(timeout=ranks.GROUP_TIMEOUT.total_seconds())
    took = time.perf_counter() - t_kill
    assert p.returncode != 0
    assert out.strip() == ""
    assert "a rank exited with" in err
    print(f"killed rank 2 (pid {rank2}): the run exited {p.returncode} "
          f"{took:.2f} s later, no result line")
