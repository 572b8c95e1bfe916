"""qwen3-moe-235b-a22b — MoE, 94L d_model=4096 64H (GQA kv=4) per-expert
d_ff=1536 vocab=151936, 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

~2.5 B weights a layer: one 80 GB card serves it at a cut depth.  A copy
of ``repro/configs/qwen3_moe_235b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    moe_capacity_factor=1.25,
    qkv_bias=False,
    gated_mlp=True,
    act="silu",
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)

SMOKE = CONFIG.replace(
    name="qwen3-moe-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    num_experts_per_tok=2,
)

register(CONFIG, SMOKE)
