"""The command itself: without the cell's CUDA devices it exits non-zero
and prints no result; on the card (``cuda``) a short run of each cell
prints a correct result line whose last key is ``check``."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import bench

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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _run(cell, 3)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    assert res["device"]["platform"] == "gpu"
