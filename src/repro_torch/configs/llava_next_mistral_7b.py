"""llava-next-mistral-7b — VLM, mistral-7b text backbone:
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The vision tower and the anyres tiling are a stub, as in the JAX package:
the model takes precomputed, already projected patch embeddings (B,
num_img_patches, d_model), which go in front of the text embeddings.
2880 patches ~= an anyres 2x2 + base grid of 576-patch CLIP tiles.  A copy
of ``repro/configs/llava_next_mistral_7b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_img_patches=2880,
    gated_mlp=True,
    act="silu",
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)

SMOKE = CONFIG.replace(
    name="llava-next-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_img_patches=16,
)

register(CONFIG, SMOKE)
