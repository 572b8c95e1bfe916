"""The port's checkpoints (``repro_torch.ckpt``): twins of
tests/test_checkpoint.py on the CPU, and the on-disk format shared with
``repro.ckpt`` (a checkpoint written by either package loads in the
other, bit for bit, with equal manifests).  The save of CUDA tensors
updated in place right after it is tested on the card, in
tests/test_torch_cuda.py.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import load_checkpoint as j_load
from repro.ckpt import save_checkpoint as j_save
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_smoke_config as j_smoke
from repro.train.step import init_state as j_init_state
from repro_torch.ckpt import (AsyncCheckpointer, latest_step, load_checkpoint,
                              save_checkpoint)
from repro_torch.configs.base import RunConfig, ShapeConfig, get_smoke_config
from repro_torch.models import params as TP
from repro_torch.models import registry
from repro_torch.train.step import init_state, make_train_step


def _tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.tensor([1.0, -2.5, 3e-3, 7.0],
                                     dtype=torch.bfloat16)},
        "opt": {"m": [torch.zeros(2), torch.full((3,), 7.0)],
                "step": 5},
        "mixed": (torch.tensor([1, 2], dtype=torch.int8),
                  torch.tensor(3, dtype=torch.int32),
                  torch.ones((2, 0, 3), dtype=torch.bfloat16)),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _assert_tree_equal(a, b):
    """``b`` as loaded: an int of ``a`` comes back as a 0-d int32."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, int):
            x = torch.tensor(x, dtype=torch.int32)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_round_trip(tmp_path):
    t = _tree()
    d = save_checkpoint(str(tmp_path), t, 120, meta={"loss": 1.5})
    assert os.path.basename(d) == "step_00000120"
    t2, meta = load_checkpoint(str(tmp_path))
    assert isinstance(t2["mixed"], tuple) and isinstance(t2["opt"]["m"], list)
    # keys in the order saved (not sorted), so leaves pair up by position
    assert list(t2) == list(t) and list(t2["opt"]) == list(t["opt"])
    _assert_tree_equal(t, t2)
    assert meta["loss"] == 1.5 and meta["step"] == 120
    t3, _ = load_checkpoint(str(tmp_path), 120, device="cpu")
    _assert_tree_equal(t, t3)


def test_latest_step_and_overwrite(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    save_checkpoint(str(tmp_path), _tree(), 1)
    save_checkpoint(str(tmp_path), _tree(), 3)
    save_checkpoint(str(tmp_path), _tree(), 2)
    assert latest_step(str(tmp_path)) == 3
    save_checkpoint(str(tmp_path), _tree(), 3)  # idempotent overwrite
    assert latest_step(str(tmp_path)) == 3
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


def test_no_partial_commit(tmp_path, monkeypatch):
    """A crashed save leaves no committed step dir and no tmp dir."""
    class Boom(Exception):
        pass

    def exploding_save(f, arr, **kw):
        raise Boom()

    monkeypatch.setattr(np, "save", exploding_save)
    with pytest.raises(Boom):
        save_checkpoint(str(tmp_path), {"x": torch.ones(2)}, 9)
    assert latest_step(str(tmp_path)) is None
    assert os.listdir(tmp_path) == []


def test_leaves_of_another_type_are_refused(tmp_path):
    for bad in (1.5, True, "x"):
        with pytest.raises(TypeError):
            save_checkpoint(str(tmp_path), {"x": bad}, 0)


def test_async_checkpointer_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in range(5):
        ck.save(_tree(), s)
    ck.close()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]


def test_async_save_copies_before_it_returns(tmp_path):
    """The train step updates the state in place right after a save: the
    save holds the values as they were."""
    t = _tree()
    want = {"w": t["params"]["w"].clone(), "b": t["params"]["b"].clone()}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(t, 1)
    t["params"]["w"].add_(1.0)
    t["params"]["b"].mul_(2.0)
    ck.close()
    got, _ = load_checkpoint(str(tmp_path), 1)
    assert torch.equal(got["params"]["w"], want["w"])
    assert torch.equal(got["params"]["b"], want["b"])


def test_async_checkpointer_surfaces_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save({"x": torch.ones(2)}, 0)
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        ck.close()


def test_resume_bit_equality(tmp_path):
    """Training resumed from a checkpoint matches uninterrupted training."""
    cfg = get_smoke_config("yi-6b")
    run = RunConfig(ce_block_v=64)
    shape = ShapeConfig("s", 16, 4, "train")
    step = make_train_step(cfg, run)

    def batch(i):
        return registry.synth_inputs(torch.Generator().manual_seed(100 + i),
                                     cfg, shape, "train", device="cpu")

    s = init_state(torch.Generator().manual_seed(0), cfg, run)
    for i in range(2):
        s, _ = step(s, batch(i))
    save_checkpoint(str(tmp_path), s, 2)
    for i in range(2, 4):
        s, _ = step(s, batch(i))
    s_resumed, _ = load_checkpoint(str(tmp_path), 2)
    s_resumed["opt"]["step"] = int(s_resumed["opt"]["step"])
    for i in range(2, 4):
        s_resumed, _ = step(s_resumed, batch(i))
    assert s_resumed["opt"]["step"] == s["opt"]["step"] == 4
    for a, b in zip(_leaves(s), _leaves(s_resumed)):
        if isinstance(a, int):
            assert a == b
        else:
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The format shared with the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_state():
    """A yi-6b smoke train state of the JAX package: bf16 params, f32
    moments filled from a seed, step 3, as numpy arrays."""
    cfg = j_smoke("yi-6b")
    state = jax.tree.map(np.asarray, jax.jit(
        lambda k: j_init_state(k, cfg, JRunConfig()))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for k in ("m", "v"):
        state["opt"][k] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            state["opt"][k])
    state["opt"]["step"] = np.asarray(3, np.int32)
    return state


def _port_state(jstate):
    return {"params": TP.from_jax_params(jstate["params"], device="cpu"),
            "opt": {"m": TP.from_jax_params(jstate["opt"]["m"], device="cpu"),
                    "v": TP.from_jax_params(jstate["opt"]["v"], device="cpu"),
                    "step": int(jstate["opt"]["step"])}}


def _bits(x) -> np.ndarray:
    """Raw bytes of a tensor or array (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.reshape(-1).view(torch.uint8).numpy() if x.numel() else \
            np.zeros((0,), np.uint8)
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def test_jax_checkpoint_loads_in_the_port(tmp_path, jax_state):
    j_save(str(tmp_path), jax_state, 3, meta={"arch": "yi-6b"})
    got, meta = load_checkpoint(str(tmp_path))
    assert meta == {"arch": "yi-6b", "step": 3}
    want = _port_state(jax_state)
    assert int(got["opt"]["step"]) == 3
    assert got["opt"]["step"].dtype == torch.int32
    assert got["params"]["embed"]["tok"].dtype == torch.bfloat16
    for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for k in ("m", "v"):
        for a, b in zip(_leaves(got["opt"][k]), _leaves(want["opt"][k])):
            assert a.dtype == b.dtype == torch.float32
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_port_checkpoint_loads_in_jax(tmp_path, jax_state):
    save_checkpoint(str(tmp_path), _port_state(jax_state), 3,
                    meta={"arch": "yi-6b"})
    got, meta = j_load(str(tmp_path))
    assert meta == {"arch": "yi-6b", "step": 3}
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(jax_state)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_manifests_of_both_packages_are_equal(tmp_path, jax_state):
    j_save(str(tmp_path / "jax"), jax_state, 3, meta={"loss": 1.25})
    save_checkpoint(str(tmp_path / "port"), _port_state(jax_state), 3,
                    meta={"loss": 1.25})
    manifests = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg / "step_00000003"
        with open(d / "manifest.json") as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    paths = [leaf["path"] for leaf in manifests[0]["leaves"]]
    assert paths == sorted(paths)
    assert ["opt", "step"] in [p.split("/")[1:] for p in paths]
    for leaf in manifests[1]["leaves"]:
        a = np.load(tmp_path / "jax" / "step_00000003" / leaf["file"])
        b = np.load(tmp_path / "port" / "step_00000003" / leaf["file"])
        assert a.dtype == b.dtype and a.shape == b.shape, leaf["path"]
        np.testing.assert_array_equal(a, b, err_msg=leaf["path"])
