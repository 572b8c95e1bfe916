"""whisper-tiny — encoder-decoder audio transformer backbone,
4L(enc)+4L(dec) d_model=384 6H d_ff=1536 vocab=51865.
[arXiv:2212.04356; unverified]

The conv mel frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, encoder_frames, d_model).  Positions are
sinusoidal, with no RoPE.  A copy of ``repro/configs/whisper_tiny.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    encoder_layers=4,
    encoder_frames=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    qkv_bias=True,
    mlp_bias=True,
    gated_mlp=False,
    act="gelu",
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
    norm_eps=1e-5,
    source="arXiv:2212.04356; unverified",
)

SMOKE = CONFIG.replace(
    name="whisper-tiny-smoke",
    num_layers=2,
    encoder_layers=2,
    encoder_frames=32,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)

register(CONFIG, SMOKE)
