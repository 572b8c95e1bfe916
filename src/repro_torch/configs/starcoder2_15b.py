"""starcoder2-15b — dense, 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GQA + RoPE, non-gated GELU MLP with biases. [arXiv:2402.19173; hf]

A copy of ``repro/configs/starcoder2_15b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=True,
    mlp_bias=True,
    gated_mlp=False,
    act="gelu",
    rope_theta=100_000.0,
    norm_eps=1e-5,
    source="arXiv:2402.19173; hf",
)

SMOKE = CONFIG.replace(
    name="starcoder2-15b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)

register(CONFIG, SMOKE)
