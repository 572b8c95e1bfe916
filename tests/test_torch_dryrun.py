"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), on the CPU and the meta device.

- ``active_params`` and ``model_flops`` equal the JAX package's for every
  arch at its full config, for each kind of shape;
- ``all_cells()`` equals the JAX package's list, skips and reasons too;
- the CLI in a subprocess, as tests/test_dryrun_cli.py runs the JAX one:
  whisper-tiny x train_4k keeps the cell contract per device of the
  production mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``;
  ``--both-meshes`` gives a row each), and yi-6b x long_500k is the
  documented skip;
- the same cell on an abstract 1 x 1 mesh: the whole cell on one card;
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
from repro_torch.launch.mesh import Mesh

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


def _cli(tmp_path, arch, shape, *flags):
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", arch, "--shape", shape, "--out", str(out), *flags],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    cells = json.loads(out.read_text())
    assert len(cells) == (2 if "--both-meshes" in flags else 1)
    return cells if "--both-meshes" in flags else cells[0]


def _cell_contract(c):
    assert c["status"] == "ok"
    assert c["hlo_flops"] > 0 and c["hlo_bytes"] > 0
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


def test_dryrun_cli_single_cell(tmp_path):
    """The JAX contract: one device of the 16 x 16 production mesh, its
    collectives counted by kind."""
    c = _cli(tmp_path, "whisper-tiny", "train_4k")
    _cell_contract(c)
    assert c["chips"] == 256
    assert c["mesh"] == "(16, 16)"
    assert c["collective_total"] > 0
    assert c["collective_total"] == sum(c["collective_bytes"].values())
    assert set(c["collective_bytes"]) == {"all-gather", "all-reduce",
                                          "reduce-scatter"}
    assert c["roofline"]["collective_s"] > 0


def test_dryrun_one_card_cell():
    """The same cell on an abstract 1 x 1 mesh: the whole global batch on
    one card, no collective."""
    c = dryrun.run_cell("whisper-tiny", "train_4k",
                        mesh=Mesh((1, 1), ("data", "model")))
    _cell_contract(c)
    assert c["chips"] == 1
    assert c["mesh"] == "(1, 1)"
    assert c["collective_total"] == 0  # one card
    assert c["collective_bytes"] == {}
    one = dryrun.count_cell(tbase.get_config("whisper-tiny"),
                            tbase.SHAPES["train_4k"])
    assert c["hlo_flops"] == one["flops"]
    assert c["memory"]["peak_bytes"] == one["peak_bytes"]


def test_dryrun_cli_multi_pod(tmp_path):
    c = _cli(tmp_path, "whisper-tiny", "train_4k", "--multi-pod")
    _cell_contract(c)
    assert c["chips"] == 512
    assert c["mesh"] == "pod2x(2, 16, 16)"
    assert c["collective_total"] > 0


def test_dryrun_cli_both_meshes(tmp_path):
    """``--both-meshes``: a row per mesh, 16 x 16 then 2 x 16 x 16; the
    batch splits over twice the data ranks on the second."""
    a, b = _cli(tmp_path, "whisper-tiny", "decode_32k", "--both-meshes")
    assert (a["mesh"], a["chips"]) == ("(16, 16)", 256)
    assert (b["mesh"], b["chips"]) == ("pod2x(2, 16, 16)", 512)
    assert a["hlo_flops"] > b["hlo_flops"] > 0
    assert a["collective_total"] > 0 and b["collective_total"] > 0


def test_dryrun_cli_skip_cell(tmp_path):
    """long_500k on a pure-attention arch is a DOCUMENTED skip."""
    c = _cli(tmp_path, "yi-6b", "long_500k")
    assert c["status"] == "skipped"
    assert "sub-quadratic" in c["reason"]


def test_full_size_cell_counts_the_same_twice():
    """zamba2-1.2b's decode, per device of 16 x 16 and on one card: each
    counted twice gives the same count.  Split over 16, its 64 SSM heads
    run 4 a device and each mamba block's gated norm takes the split-row
    kernels (a statistic launch and a rows launch)."""
    for mesh, calls in (
            (None, {"rmsnorm": 38 + 2 * (38 // 6) + 1,
                    "rmsnorm_split": 2 * 38}),
            (Mesh((1, 1), ("data", "model")),
             {"rmsnorm": 2 * 38 + 2 * (38 // 6) + 1})):
        a = dryrun.run_cell("zamba2-1.2b", "decode_32k", mesh=mesh)
        b = dryrun.run_cell("zamba2-1.2b", "decode_32k", mesh=mesh)
        assert a["status"] == b["status"] == "ok"
        for key in ("hlo_flops", "hlo_bytes", "calls", "memory",
                    "collective_bytes"):
            assert a[key] == b[key], key
        assert a["calls"] == calls
