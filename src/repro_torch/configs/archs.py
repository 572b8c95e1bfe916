"""Import every ported architecture config, populating the registry.

Ported so far: yi-6b (dense, bf16 KV cache, no sliding window),
mamba2-130m (SSM) and zamba2-1.2b (hybrid: Mamba2 blocks with one shared
attention+MLP block, bf16 KV cache).
"""
from repro_torch.configs import mamba2_130m, yi_6b, zamba2_1_2b  # noqa: F401
