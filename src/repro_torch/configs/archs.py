"""Import every ported architecture config, populating the registry.

Only yi-6b (dense, bf16 KV cache, no sliding window) is ported so far.
"""
from repro_torch.configs import yi_6b  # noqa: F401
