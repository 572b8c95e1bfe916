"""Hardware constants of the port's target, one NVIDIA H100 SXM, for the
roofline; the twin of the constants in ``repro/launch/mesh.py``, which
holds TPU v5e ones.

The rates are NVIDIA's data sheet for the H100 SXM5 80 GB, dense (no
structured sparsity): bf16 tensor cores 989 TFLOP/s, f32 on the CUDA
cores 67 TFLOP/s (the f32 instantiations of the kernels, which use no
TF32), HBM3 3.35 TB/s, 80 GB of HBM, and NVLink 4 at 900 GB/s both
directions together, 450 GB/s a direction, in place of the TPU's ICI
rate.  A card set below its 700 W limit runs slower than these under
load.

No mesh is built: every machine the port runs on has one card, and the
device mesh and its sharding rules wait for ROADMAP A9.
"""
from __future__ import annotations

from typing import Tuple

import torch

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
