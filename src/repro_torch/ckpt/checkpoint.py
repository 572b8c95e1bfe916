"""Checkpoints, the twin of ``repro/ckpt/checkpoint.py``, in the same
on-disk format: a checkpoint written by either package loads in the
other.

Layout (one directory per step, committed atomically by rename):

    <root>/step_00000120/
        manifest.json       # tree structure + shapes/dtypes + metadata
        leaf_00000.npy ...  # one file per leaf, in sorted-path order

* ``save_checkpoint``: synchronous and atomic (a tmp dir, an fsync'd
  manifest, then a rename); safe against a process dying mid-write.
* ``AsyncCheckpointer``: a background writer thread.  ``save`` returns
  once every leaf is copied to host memory, so the caller may update the
  tensors in place right after (the train step does); the file I/O
  overlaps with the steps that follow.
* ``load_checkpoint``: rebuilds the tree, its leaves moved to a given
  device.

Trees are nested dict / list / tuple of tensor leaves; a numpy array or
a Python int (saved as a 0-d int32, as the JAX optimizer keeps its step)
is a leaf too.  bf16, which numpy lacks, is stored as its raw bytes (a
``uint8`` array with a trailing itemsize axis) under the dtype name
``"bfloat16"``, as the JAX package stores it; the bytes go through
``torch.Tensor.view``, so no ``ml_dtypes`` is needed.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, f"{prefix}/[{i}]"))
        return out
    return [(prefix, tree)]


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _structure(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def _rebuild(struct: Any, leaves: "queue.SimpleQueue") -> Any:
    kind = struct["__kind__"]
    if kind == "dict":
        # the leaves come in sorted-path order; the keys go back in the
        # order they were saved in, so that code pairing the leaves of
        # two trees by position (the optimizer) sees one order
        built = {k: _rebuild(v, leaves)
                 for k, v in sorted(struct["items"].items())}
        return {k: built[k] for k in struct["items"]}
    if kind in ("list", "tuple"):
        seq = [_rebuild(v, leaves) for v in struct["items"]]
        return seq if kind == "list" else tuple(seq)
    return leaves.get_nowait()


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def _to_host(x: Any) -> Tuple[np.ndarray, str, List[int]]:
    """A leaf as (the array written to disk, the logical dtype name, the
    logical shape).  A tensor is copied to the host before this returns,
    so later in-place updates of it cannot reach the saved bytes."""
    if isinstance(x, bool) or not isinstance(
            x, (int, np.ndarray, torch.Tensor)):
        raise TypeError(f"a checkpoint leaf must be a tensor, an array or "
                        f"an int, got {type(x).__name__}")
    if isinstance(x, int):
        x = np.asarray(x, np.int32)
    if isinstance(x, np.ndarray):
        return np.array(x), str(x.dtype), list(x.shape)
    # .to(copy=True): a private copy even of a CPU tensor; from a CUDA
    # tensor a synchronous copy, issued after the work queued before it
    t = x.detach().to("cpu", copy=True)
    shape = list(t.shape)
    if t.dtype == torch.bfloat16:
        raw = t.reshape(-1).view(torch.uint8).reshape(shape + [2])
        return raw.numpy(), "bfloat16", shape
    return t.numpy(), str(t.dtype).removeprefix("torch."), shape


def _from_disk(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        shape = arr.shape[:-1]
        return torch.from_numpy(np.ascontiguousarray(arr)).reshape(-1).view(
            torch.bfloat16).reshape(shape)
    if str(arr.dtype) != dtype_name:
        raise TypeError(f"cannot decode a {arr.dtype} leaf as {dtype_name}")
    return torch.from_numpy(arr)


def _host_leaves(tree: Any):
    return [(path, *_to_host(x)) for path, x in _flatten(tree)]


def _write(root: str, leaves, structure, step: int,
           meta: Optional[Dict[str, Any]]) -> str:
    os.makedirs(root, exist_ok=True)
    final = _step_dir(root, step)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=root)
    try:
        names = []
        for i, (path, arr, dtype_name, shape) in enumerate(leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            names.append({"path": path, "file": fname, "shape": shape,
                          "dtype": dtype_name})
        manifest = {"step": step, "leaves": names, "structure": structure,
                    "meta": meta or {}}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):      # overwrite = replace atomically-ish
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint(root: str, tree: Any, step: int,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomic synchronous save. Returns the committed directory."""
    return _write(root, _host_leaves(tree), _structure(tree), step, meta)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and os.path.exists(
                os.path.join(root, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def load_checkpoint(root: str, step: Optional[int] = None, *,
                    device: Union[str, torch.device, None] = None
                    ) -> Tuple[Any, Dict[str, Any]]:
    """Returns (tree, manifest meta with ``"step"``).  Leaves are CPU
    tensors, moved to ``device`` when one is given; an int saved as a
    leaf comes back as a 0-d int32 tensor."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    q: "queue.SimpleQueue" = queue.SimpleQueue()
    for leaf in manifest["leaves"]:
        t = _from_disk(np.load(os.path.join(d, leaf["file"])), leaf["dtype"])
        q.put(t if device is None else t.to(device))
    tree = _rebuild(manifest["structure"], q)
    manifest["meta"]["step"] = manifest["step"]
    return tree, manifest["meta"]


class AsyncCheckpointer:
    """Single background writer; the caller pays only the host copy.

    ``copy_s`` and ``write_s`` hold each save's host-copy time (what the
    caller waits for) and its writer time, ``bytes_written`` the bytes of
    the leaf files written."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self.copy_s: List[float] = []
        self.write_s: List[float] = []
        self.bytes_written = 0
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name="ckpt-writer")
        self._t.start()

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.root)
            if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            leaves, structure, step, meta = item
            try:
                t0 = time.perf_counter()
                _write(self.root, leaves, structure, step, meta)
                self.write_s.append(time.perf_counter() - t0)
                self.bytes_written += sum(arr.nbytes for _, arr, _, _ in leaves)
                if self.keep:
                    self._gc()
            except BaseException as e:  # surfaced on next save()/close()
                self._err = e

    def save(self, tree: Any, step: int,
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Copies every leaf to the host (synchronously), then queues the
        write."""
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
        t0 = time.perf_counter()
        leaves = _host_leaves(tree)
        self.copy_s.append(time.perf_counter() - t0)
        self._q.put((leaves, _structure(tree), step, meta))

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
