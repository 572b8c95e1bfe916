"""PyTorch/CUDA port of the ``repro`` compute stack.

Mirrors the subpackage and module names of ``repro`` so each function has
an obvious counterpart.  It imports ``torch`` and numpy only: nothing from
``jax`` and nothing from ``repro`` (it keeps its own copies of the config
dataclasses it needs).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""
