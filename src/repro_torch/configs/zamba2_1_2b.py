"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks,
38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000 ssm_state=64.
[arXiv:2411.15242; hf]

As in the JAX package: Mamba2 layers with one weight-shared
attention+MLP block applied every ``attn_every`` SSM layers (the
per-application LoRA adapters of Zamba2 are omitted).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    ssm_conv=4,
    attn_every=6,
    gated_mlp=True,
    act="gelu",
    rope_theta=10_000.0,
    norm_eps=1e-5,
    source="arXiv:2411.15242; hf",
)

SMOKE = CONFIG.replace(
    name="zamba2-1.2b-smoke",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=32,
    attn_every=2,
)

register(CONFIG, SMOKE)
