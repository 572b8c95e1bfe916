"""Where a kernel call reports itself to a cost counter.

Each entry of ``kernels/ops.py`` and each kernel-backed autograd backward
wraps the call that launches its kernel (or runs the plain version) in
:func:`charge`.  With no counter active that is a null context.  Under
``repro_torch.launch.cost``'s counter, the call is charged as one call of
the kernel with the work of the function it computes, whichever path
runs, and nothing that runs inside it is counted op by op.
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
