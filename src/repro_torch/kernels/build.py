"""Builds the hand-written CUDA kernels from ``kernels/csrc`` at first use.

``torch.utils.cpp_extension.load`` compiles every source into one
extension module, with ninja, for ``sm_90a``: the kernels' ``.cu`` files
(plain CUDA, no PyTorch headers) and ``bindings.cpp``, the one file that
includes ``torch/extension.h``.  ``load`` compiles with
``__CUDA_NO_BFLOAT16_CONVERSIONS__``, so the kernels convert through the
``__bfloat162float``/``__float2bfloat16`` intrinsics.

The module lands in ``<repo>/build/repro_torch_kernels`` (listed in
``.gitignore``); ``load`` rebuilds it when a source or a flag changes and
otherwise loads it as it is.  Nothing is downloaded; a failed build
raises.
"""
from __future__ import annotations

import threading
from pathlib import Path
from types import ModuleType
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("bindings.cpp", "rmsnorm.cu", "flash_attention.cu",
           "cross_entropy.cu", "ssd_scan.cu", "adamw.cu", "moe_experts.cu")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas=-v"]

_EXT: Optional[ModuleType] = None
_LOCK = threading.Lock()


def extension(verbose: bool = False) -> ModuleType:
    """Builds (where needed) and loads the kernels' extension module.
    ``verbose`` prints the build's log, with ptxas' register and spill
    counts for each kernel."""
    global _EXT
    with _LOCK:
        if _EXT is None:
            from torch.utils.cpp_extension import load
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _EXT = load("repro_torch_kernels",
                        [str(CSRC / s) for s in SOURCES],
                        build_directory=str(BUILD_DIR),
                        extra_cflags=["-O3"], extra_cuda_cflags=CUDA_FLAGS,
                        verbose=verbose)
        return _EXT
