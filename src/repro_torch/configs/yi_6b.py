"""yi-6b — dense, 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA. [arXiv:2403.04652; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    qkv_bias=False,
    gated_mlp=True,
    act="silu",
    rope_theta=5_000_000.0,
    norm_eps=1e-5,
    source="arXiv:2403.04652; hf",
)

SMOKE = CONFIG.replace(
    name="yi-6b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)

register(CONFIG, SMOKE)
