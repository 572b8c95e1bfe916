"""qwen1.5-4b — dense, 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

The full config keeps its K/V cache in int8 (per token and head, f32
scales; ``models/layers.py::quantize_kv``); the smoke config in bf16.
A copy of ``repro/configs/qwen1_5_4b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    gated_mlp=True,
    act="silu",
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    kv_cache_dtype="int8",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)

SMOKE = CONFIG.replace(
    name="qwen1.5-4b-smoke",
    num_layers=2,
    d_model=48,
    num_heads=3,
    num_kv_heads=3,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    kv_cache_dtype="bfloat16",
)

register(CONFIG, SMOKE)
