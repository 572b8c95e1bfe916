"""granite-4.0-h-small (Granite 4.0-H Small, 32B total, ~9B active) —
hybrid MoE, 40L d_model=4096: 36 Mamba2 layers (128 heads of 64, state
128, one B/C group, conv 4 with bias) and 4 attention layers (GQA 32/8
heads of 128, no position embedding) at indices 5, 15, 25 and 35; after
every mixer an MoE of 72 SwiGLU experts of width 768, top 10, plus one
shared SwiGLU expert of width 1536; vocab 100352.
[huggingface.co/ibm-granite/granite-4.0-h-small, config.json]

Every published size, and the four scale factors of the model's code:
the embedding times 12, each branch times 0.22 before the residual sum,
softmax scale 1/128, logits divided by 16.  Two settings of the port:
``ssm_chunk`` 128 (published 256; the same sums) and an untied LM head
(published tied; the same shapes and FLOPs, 0.82 GB more).  The MoE is
dropless (``moe_dropless``: routed rows, no capacity), as published.

The JAX package has no such arch: it is registered for the port alone
(``register_port_only``), outside ``list_archs``.
"""
from repro_torch.configs.base import ModelConfig, register_port_only

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="granite_hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    num_experts=72,
    num_experts_per_tok=10,
    shared_expert_d_ff=1536,
    moe_dropless=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    ssm_conv=4,
    attn_layers=(5, 15, 25, 35),
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    use_rope=False,
    gated_mlp=True,
    act="silu",
    norm_eps=1e-5,
    tie_embeddings=False,
    source="huggingface.co/ibm-granite/granite-4.0-h-small",
)

# every kind of layer: Mamba2, attention between Mamba2 layers, 8
# experts top 3 and the shared expert
SMOKE = CONFIG.replace(
    name="granite-4.0-h-small-smoke",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    num_experts_per_tok=3,
    shared_expert_d_ff=48,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=32,
    attn_layers=(1,),
    attention_multiplier=0.0625,
)

register_port_only(CONFIG, SMOKE)
