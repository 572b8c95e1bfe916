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

Under sharding rules (``defs``: the tree's ParamDefs, None for a leaf the
mesh does not split) a tree holds each rank's blocks.  Saving gathers
each leaf whole, one leaf at a time, on every rank (a collective), and
rank 0 alone writes it: the on-disk format does not change.  Loading
reads each leaf whole and keeps this rank's block: a checkpoint loads on
any mesh (the elastic restart of ``load_checkpoint(shardings=...)``),
whatever mesh wrote it.

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
import torch.distributed as dist

from repro_torch.models import params as P
from repro_torch.sharding import rules as S


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


def _to_host(x: Any, copy: bool = True
             ) -> Tuple[np.ndarray, str, List[int]]:
    """A leaf as (the array written to disk, the logical dtype name, the
    logical shape).  A tensor is copied to the host before this returns,
    so later in-place updates of it cannot reach the saved bytes (with
    ``copy`` False a CPU tensor is taken as it is: a private copy
    already)."""
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
    t = x.detach().to("cpu", copy=copy)
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


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or a process with none."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _leaf_defs(tree: Any, defs: Any) -> List[Any]:
    """Each leaf's def in ``_flatten`` order (None throughout without
    defs)."""
    n = len(_flatten(tree))
    if defs is None:
        return [None] * n
    out = [d for _, d in _flatten(defs)]
    assert len(out) == n, (len(out), n)
    return out


def _gathered_on_host(x: torch.Tensor, d: Any) -> Optional[torch.Tensor]:
    """The whole leaf of def ``d`` from this rank's block ``x``, under
    rules: a CPU tensor on the writer, None elsewhere.  A stacked leaf is
    gathered a layer at a time, so no rank holds more than one layer's
    whole slice on its device."""
    with torch.no_grad():
        if d.logical[:1] != ("layers",):
            full = S.gather(x, d)
            return full.to("cpu", copy=True) if _writer() else None
        one = P.unstack(d)
        host = torch.empty(d.shape, dtype=x.dtype) if _writer() else None
        for i in range(d.shape[0]):
            part = S.gather(x[i], one)
            if host is not None:
                host[i].copy_(part)
        return host


def _host_leaves(tree: Any, defs: Any = None):
    """Every leaf on the host; under rules each leaf is gathered (on every
    rank, ``_gathered_on_host``) and copied by the writer alone."""
    out = []
    for (path, x), d in zip(_flatten(tree), _leaf_defs(tree, defs)):
        private = d is not None and S.sharded()
        if private:
            x = _gathered_on_host(x, d)
        if _writer():
            out.append((path, *_to_host(x, copy=not private)))
    return out


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
                    meta: Optional[Dict[str, Any]] = None,
                    defs: Any = None) -> Optional[str]:
    """Atomic synchronous save. Returns the committed directory (None on
    a rank that does not write)."""
    leaves = _host_leaves(tree, defs)
    if not _writer():
        return None
    return _write(root, leaves, _structure(tree), step, meta)


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
                    device: Union[str, torch.device, None] = None,
                    defs: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """Returns (tree, manifest meta with ``"step"``).  Leaves are CPU
    tensors, moved to ``device`` when one is given; an int saved as a
    leaf comes back as a 0-d int32 tensor.  With ``defs`` under sharding
    rules each leaf is cut to this rank's block."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    r = S.current_rules()
    leaf_defs = ([None] * len(manifest["leaves"]) if defs is None
                 else [x for _, x in _flatten(defs)])
    q: "queue.SimpleQueue" = queue.SimpleQueue()
    for leaf, ld in zip(manifest["leaves"], leaf_defs):
        t = _from_disk(np.load(os.path.join(d, leaf["file"])), leaf["dtype"])
        if ld is not None and S.sharded():
            part = r.local_shard(t, ld.logical, ld.shape)
            t = t if part is t else part.clone()
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
             meta: Optional[Dict[str, Any]] = None,
             defs: Any = None) -> None:
        """Copies every leaf to the host (synchronously; under rules with
        ``defs``, gathered whole first on every rank), then queues the
        write (on the writing rank)."""
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
        t0 = time.perf_counter()
        leaves = _host_leaves(tree, defs)
        self.copy_s.append(time.perf_counter() - t0)
        if _writer():
            self._q.put((leaves, _structure(tree), step, meta))

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
