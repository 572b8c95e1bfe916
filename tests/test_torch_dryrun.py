"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), on the CPU and the meta device.

- ``active_params`` and ``model_flops`` equal the JAX package's for every
  arch at its full config, for each kind of shape;
- ``all_cells()`` equals the JAX package's list, skips and reasons too;
- the CLI in a subprocess, as tests/test_dryrun_cli.py runs the JAX one:
  whisper-tiny x train_4k keeps the cell contract on one card, and
  yi-6b x long_500k is the documented skip;
- a full-size cell counted twice gives the same count.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from repro.configs import base as jbase
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jdryrun():
    """``repro.launch.dryrun``, whose import sets XLA_FLAGS for 512 host
    devices: the backend starts first (so the flag changes nothing here)
    and the variable is put back after."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return mod


@pytest.mark.parametrize("arch", tbase.list_archs())
def test_active_params_and_model_flops_equal_jax(jdryrun, arch):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    assert dryrun.active_params(tcfg) == jdryrun.active_params(jcfg)
    for name, shape in tbase.SHAPES.items():
        assert dryrun.model_flops(tcfg, shape) == jdryrun.model_flops(
            jcfg, jbase.SHAPES[name]), name


def test_all_cells_equal_jax():
    assert tbase.list_archs() == jbase.list_archs()
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in tbase.SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.kind)
         for k, s in jbase.SHAPES.items()}
    assert tbase.all_cells() == jbase.all_cells()


def _cli(tmp_path, arch, shape):
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", arch, "--shape", shape, "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    cells = json.loads(out.read_text())
    assert len(cells) == 1
    return cells[0]


def test_dryrun_cli_single_cell(tmp_path):
    c = _cli(tmp_path, "whisper-tiny", "train_4k")
    assert c["status"] == "ok"
    assert c["chips"] == 1
    assert c["hlo_flops"] > 0 and c["hlo_bytes"] > 0
    assert c["collective_total"] == 0  # one card
    rf = c["roofline"]
    assert rf["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert 0 < rf["useful_flops_ratio"] < 1.5
    mem = c["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "peak_bytes"}
    # a train step of whisper's two stacks, checkpointed: every kernel
    # but the SSD scan's is called
    assert set(c["calls"]) == {"rmsnorm", "rmsnorm_bwd", "flash_attention",
                               "flash_attention_bwd", "cross_entropy"}


def test_dryrun_cli_skip_cell(tmp_path):
    """long_500k on a pure-attention arch is a DOCUMENTED skip."""
    c = _cli(tmp_path, "yi-6b", "long_500k")
    assert c["status"] == "skipped"
    assert "sub-quadratic" in c["reason"]


def test_full_size_cell_counts_the_same_twice():
    a = dryrun.run_cell("zamba2-1.2b", "decode_32k")
    b = dryrun.run_cell("zamba2-1.2b", "decode_32k")
    assert a["status"] == b["status"] == "ok"
    for key in ("hlo_flops", "hlo_bytes", "calls", "memory"):
        assert a[key] == b[key], key
    assert a["calls"] == {"rmsnorm": 2 * 38 + 2 * (38 // 6) + 1}
