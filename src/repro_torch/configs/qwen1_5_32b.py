"""qwen1.5-32b — dense, 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

The full config keeps its K/V cache in int8, as qwen1.5-4b does.  Its
~35 B weights (70 GB in bf16) do not fit one 80 GB card beside their
initialisation: serve it there at a cut depth (``run_serving(...,
num_layers=...)``).  A copy of
``repro/configs/qwen1_5_32b.py``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    gated_mlp=True,
    act="silu",
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    kv_cache_dtype="int8",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)

SMOKE = CONFIG.replace(
    name="qwen1.5-32b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    kv_cache_dtype="bfloat16",
)

register(CONFIG, SMOKE)
