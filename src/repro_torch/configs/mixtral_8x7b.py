"""mixtral-8x7b — MoE, 32L d_model=4096 32H (GQA kv=8) per-expert
d_ff=14336 vocab=32000, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

~47 B bf16 weights: one 80 GB card serves it at a cut depth.  A copy of
``repro/configs/mixtral_8x7b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    num_experts_per_tok=2,
    moe_capacity_factor=1.25,
    sliding_window=4096,
    gated_mlp=True,
    act="silu",
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
    source="arXiv:2401.04088; hf",
)

SMOKE = CONFIG.replace(
    name="mixtral-8x7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_experts=4,
    num_experts_per_tok=2,
    sliding_window=64,
)

register(CONFIG, SMOKE)
