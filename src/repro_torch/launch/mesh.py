"""Mesh construction over the ranks of a process group, and the hardware
constants of the port's target, one NVIDIA H100 SXM, for the roofline;
the twin of ``repro/launch/mesh.py``, which builds ``jax`` meshes and
holds TPU v5e constants.

A ``Mesh`` names its axes and their sizes (``shape``, as a JAX mesh's)
and, unless it is abstract, holds the torch ``DeviceMesh`` whose process
groups the sharding rules' collectives run over.  ``make_host_mesh``
spans the world's ranks: the ranks of ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; each rank pins ``cuda:LOCAL_RANK``, or
``cuda:0`` when the ranks outnumber the cards), or one rank in a group
built from an in-process store.  NCCL carries CUDA tensors and gloo CPU
ones (gloo both, where several ranks share a card).
``make_production_mesh`` is abstract: its specs resolve on any machine,
for the dry run.  An abstract mesh stands for one of its ranks, by default
the one at coordinate 0 on every axis (``coords``): ``coord`` answers for
that rank, so the rules cut its blocks and rows, and the sharding rules'
collectives are charged to the cost counter instead of being run.

The rates are NVIDIA's data sheet for the H100 SXM5 80 GB, dense (no
structured sparsity): bf16 tensor cores 989 TFLOP/s, f32 on the CUDA
cores 67 TFLOP/s (the f32 instantiations of the kernels, which use no
TF32), HBM3 3.35 TB/s, 80 GB of HBM, and NVLink 4 at 900 GB/s both
directions together, 450 GB/s a direction, in place of the TPU's ICI
rate.  A card set below its 700 W limit runs slower than these under
load.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s, f32 on the CUDA cores
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80e9  # bytes
NVLINK_BW = 450e9  # bytes/s a direction, per card

PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float32: PEAK_FLOPS_F32}


def bound_s(n_bytes: float, flops: float,
            dtype: torch.dtype = torch.bfloat16) -> Tuple[float, str]:
    """The least time the card could take for work that moves ``n_bytes``
    through HBM and does ``flops`` at the peak of ``dtype``: the larger of
    the two times, and which it is (``"bytes"`` or ``"operations"``)."""
    t_bytes = n_bytes / HBM_BW
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Mesh:
    """Axis names and sizes (``shape``: an ordered name -> size dict) and,
    unless abstract, the ``DeviceMesh`` over the ranks.  An abstract mesh
    stands for the rank at ``coords`` (one index an axis; default 0 on
    every axis)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_mesh=None, coords: Optional[Sequence[int]] = None):
        assert len(shape) == len(axes), (shape, axes)
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.device_mesh = device_mesh
        if coords is not None and device_mesh is not None:
            raise ValueError("a mesh over ranks takes its coordinates from "
                             "them")
        coords = tuple(coords or (0,) * len(axes))
        if len(coords) != len(axes) or not all(
                0 <= c < n for c, n in zip(coords, shape)):
            raise ValueError(f"coordinates {coords} outside the mesh {shape}")
        self.coords: Dict[str, int] = dict(zip(axes, coords))

    def _mesh(self):
        if self.device_mesh is None:
            raise RuntimeError("an abstract mesh has no ranks")
        return self.device_mesh

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (an abstract mesh's: the rank
        it stands for)."""
        if self.device_mesh is None:
            return self.coords[axis]
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self._mesh().get_group(axis)

    def __repr__(self) -> str:
        if self.device_mesh is None:
            return f"abstract Mesh({self.shape}, at {self.coords})"
        return f"Mesh({self.shape})"


def local_device(device: str) -> torch.device:
    """``device``, a bare ``"cuda"`` pinned to this rank's card and made
    current: ``cuda:LOCAL_RANK``, or ``cuda:0`` for every rank when the
    machine runs more ranks than it has cards (several ranks on one
    card, over gloo: NCCL refuses two ranks on one device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ.get("WORLD_SIZE", 1)))
        dev = torch.device("cuda", 0 if world > torch.cuda.device_count()
                           else local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def init_distributed(backend: Optional[str] = None) -> None:
    """Joins the default process group once: the launcher's (``env://``)
    when ``WORLD_SIZE`` is set, else a one-rank group over an in-process
    store.  ``backend`` None carries CPU tensors over gloo and, where CUDA
    and NCCL exist, CUDA ones over NCCL; ``"gloo"`` carries both over gloo
    (several ranks on one card).  A group that fails to form raises."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl"
                   if torch.cuda.is_available() and dist.is_nccl_available()
                   else "gloo")
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


_MESHES: Dict[tuple, tuple] = {}


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: str = "cuda") -> Mesh:
    """A mesh of ``shape`` over the default group's ranks (joined first),
    rank-major; ``device`` its tensors' device type.  A mesh is built once
    a process group: later calls return it (building one makes a process
    group per axis)."""
    from torch.distributed.device_mesh import init_device_mesh
    init_distributed()
    world = dist.group.WORLD
    key = (id(world), tuple(shape), tuple(axes), torch.device(device).type)
    if key not in _MESHES:  # the entry keeps ``world`` alive: ids stay apart
        dm = init_device_mesh(key[3], tuple(shape),
                              mesh_dim_names=tuple(axes))
        _MESHES[key] = (world, Mesh(shape, axes, dm))
    return _MESHES[key][1]


def make_host_mesh(model: Optional[int] = None,
                   device: str = "cuda") -> Mesh:
    """A (data, model) mesh over every rank of the world (one rank without
    a launcher)."""
    init_distributed()
    n = dist.get_world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"{n} ranks do not split into model {model}")
    return make_mesh((n // model, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production layout as an abstract mesh: 16 x 16
    (data, model), or 2 x 16 x 16 (pod, data, model)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))
