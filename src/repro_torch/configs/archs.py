"""Import every ported architecture config, populating the registry.

Ported: the dense archs yi-6b, qwen1.5-4b, qwen1.5-32b (both with an int8
KV cache in their full configs) and starcoder2-15b; mamba2-130m (SSM);
zamba2-1.2b (hybrid: Mamba2 blocks with one shared attention+MLP block);
the MoE archs mixtral-8x7b (sliding window) and qwen3-moe-235b-a22b;
whisper-tiny (encoder-decoder) and llava-next-mistral-7b (VLM).
"""
from repro_torch.configs import (  # noqa: F401
    llava_next_mistral_7b,
    mamba2_130m,
    mixtral_8x7b,
    qwen1_5_4b,
    qwen1_5_32b,
    qwen3_moe_235b,
    starcoder2_15b,
    whisper_tiny,
    yi_6b,
    zamba2_1_2b,
)
