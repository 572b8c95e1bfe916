"""Times a cold build of the port's CUDA kernels by two routes, on a
machine with a GPU toolchain:

(a) the port's route, ``repro_torch.kernels.build.extension``:
    ``torch.utils.cpp_extension.load`` (with ninja) of the kernels' ``.cu``
    files and ``bindings.cpp``, the one file that includes
    ``torch/extension.h``, into one extension module for ``sm_90a``;
(b) the kernels' ``.cu`` files alone, one ``nvcc`` each, all started
    together, into shared libraries with their plain C entry points (what
    a ``ctypes`` binding would load; no PyTorch headers).

    python3 tools/time_torch_extension_build.py

Both build under ``build/ext_build_probe`` (``build/`` is in .gitignore),
emptied first, so each build is cold.  Prints one JSON line of seconds.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from torch.utils.cpp_extension import CUDA_HOME  # noqa: E402

from repro_torch.kernels import build  # noqa: E402


def main() -> int:
    probe = ROOT / "build" / "ext_build_probe"
    shutil.rmtree(probe, ignore_errors=True)

    build.BUILD_DIR = probe / "extension"
    t0 = time.perf_counter()
    build.extension()
    t_ext = time.perf_counter() - t0

    lib_dir = probe / "shared"
    lib_dir.mkdir(parents=True)
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    cus = [s for s in build.SOURCES if s.endswith(".cu")]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", str(lib_dir / f"lib{s[:-3]}.so"),
         str(build.CSRC / s)]) for s in cus]
    rcs = [p.wait() for p in procs]
    t_nvcc = time.perf_counter() - t0
    if any(rcs):
        print(f"nvcc failed: exit codes {rcs}", file=sys.stderr)
        return 1
    print(json.dumps({"extension_load_s": t_ext, "nvcc_shared_libs_s": t_nvcc,
                      "sources": list(build.SOURCES)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
