"""Where a kernel call reports itself to a cost counter.

Each entry of ``kernels/ops.py`` and each kernel-backed autograd backward
wraps the call that launches its kernel (or runs the plain version) in
:func:`charge`.  With no counter active that is a null context.  Under
``repro_torch.launch.cost``'s counter, the call is charged as one call of
the kernel with the work of the function it computes, whichever path
runs, and nothing that runs inside it is counted op by op.

Each collective of ``repro_torch/sharding/rules.py`` reports itself the
same way, through :func:`collective`: it is charged its operand's bytes
under its kind (``hlo_cost``'s convention), whether it runs over a process
group or, on an abstract mesh, is not run at all.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Tuple

counters: List = []  # the active counters, innermost last

_NULL = contextlib.nullcontext()


def charge(name: str, work: Callable[[], Tuple[float, int]]):
    """A context around one call of kernel ``name``; ``work()`` gives its
    (FLOPs, bytes) and runs only when a counter is active."""
    return counters[-1].charge(name, work) if counters else _NULL


def collective(kind: str, operand_bytes: int, result_bytes: int):
    """A context around one collective of ``kind`` (``"all-reduce"``,
    ``"all-gather"``, ``"reduce-scatter"``) whose operand and result have
    these sizes on this rank."""
    return (counters[-1].collective(kind, operand_bytes, result_bytes)
            if counters else _NULL)
