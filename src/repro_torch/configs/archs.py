"""Import every ported architecture config, populating the registry.

Ported: the dense archs yi-6b, qwen1.5-4b, qwen1.5-32b (both with an int8
KV cache in their full configs) and starcoder2-15b; mamba2-130m (SSM);
zamba2-1.2b (hybrid: Mamba2 blocks with one shared attention+MLP block);
the MoE archs mixtral-8x7b (sliding window) and qwen3-moe-235b-a22b;
whisper-tiny (encoder-decoder) and llava-next-mistral-7b (VLM).

The port-only registry (``base.register_port_only``) holds the archs the
JAX package lacks: ``get_config`` resolves them, ``list_archs`` (the JAX
package's list) leaves them out.  It holds granite-4.0-h-small
(``granite_hybrid``: 36 Mamba2 and 4 NoPE attention layers, each
followed by 72 experts top 10 and a shared expert, over a dropless MoE).
"""
from repro_torch.configs import (  # noqa: F401
    granite_4_0_h_small,
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
