"""mamba2-130m — attention-free SSM (SSD, state-space duality),
24L d_model=768 vocab=50280 ssm_state=128. [arXiv:2405.21060; unverified]

d_inner = 2*768 = 1536; ssd heads = 1536/64 = 24.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    ssm_conv=4,
    norm_eps=1e-5,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)

SMOKE = CONFIG.replace(
    name="mamba2-130m-smoke",
    num_layers=2,
    d_model=64,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=32,
)

register(CONFIG, SMOKE)
