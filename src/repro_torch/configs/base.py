"""Model / shape / run configuration for the PyTorch port.

``ModelConfig`` and ``ShapeConfig`` are copies of the dataclasses in
``repro/configs/base.py`` (the port imports nothing from ``repro``), with
the same fields, so one arch is described the same way in both packages.
``RunConfig`` keeps only the fields the ported serving and training paths
read, with the JAX defaults.  ``SHAPES``, ``cell_is_runnable`` and
``all_cells`` are copies too: the same four input shapes, the same
documented skips and the same reasons.

``ModelConfig`` adds the fields of the port's own ``granite_hybrid``
family (``attn_layers`` and the four multipliers, ``use_rope``,
``shared_expert_d_ff``, ``moe_dropless``); their defaults leave every
other arch as the JAX package describes it.  An arch the port alone
runs is registered with ``register_port_only``: ``get_config`` and
``get_smoke_config`` resolve it, ``list_archs`` (the JAX package's list)
leaves it out.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention details ---
    qkv_bias: bool = False
    mlp_bias: bool = False
    gated_mlp: bool = True  # SwiGLU-style (llama family); False -> plain MLP
    act: str = "silu"  # silu | gelu
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = full attention

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4

    # --- hybrid (zamba2-style) ---
    attn_every: int = 0

    # --- hybrid (granite-style: attention at these layers, Mamba2 at the
    # rest, each mixer followed by an MoE with a shared expert) ---
    attn_layers: Tuple[int, ...] = ()
    shared_expert_d_ff: int = 0
    moe_dropless: bool = False  # routed rows, no capacity (granite_hybrid)
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0  # softmax scale; 0 -> head_dim ** -0.5
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0  # logits divided by it
    use_rope: bool = True  # False: no position embedding (NoPE)

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_frames: int = 1500

    # --- VLM (llava) ---
    num_img_patches: int = 0

    # --- numerics ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # --- serving ---
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8

    # --- provenance ---
    source: str = ""

    def __post_init__(self) -> None:
        if self.head_dim == 0 and self.num_heads:
            self.head_dim = self.d_model // self.num_heads
        if self.family == "ssm":
            self.attn_every = 0
        self.attn_layers = tuple(self.attn_layers)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass
class RunConfig:
    """Knobs of one run of the ported paths (the JAX defaults of
    ``repro/configs/base.py::RunConfig`` for the fields both have).

    ``use_kernels``: None launches the hand-written kernels exactly when
    the tensors lie on CUDA and uses the plain versions on the CPU; True on
    a CPU tensor raises; False selects the plain versions everywhere (the
    comparison phases of the tests and of ``chip_smoke.py``).
    """

    accum_steps: int = 1  # gradient-accumulation microbatches
    remat: str = "full"  # none | full (checkpoint each block) | dots
    grad_compression: str = "none"  # none | bf16
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1_000
    max_grad_norm: float = 1.0
    seed: int = 0
    attn_block_k: int = 512  # KV chunk of the plain flash reference
    ce_mode: str = "blockwise"  # blockwise | direct
    ce_block_v: int = 8192
    ce_dtype: str = "bfloat16"  # logits matmul input dtype (f32 accum)
    logits_in_fp32: bool = True
    opt_state_dtype: str = "float32"  # float32 | bfloat16
    use_kernels: Optional[bool] = None

    def replace(self, **kw: Any) -> "RunConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE_REGISTRY: Dict[str, ModelConfig] = {}
_PORT_ONLY: Dict[str, ModelConfig] = {}  # archs the JAX package lacks


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def register_port_only(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    """An arch of the port alone: resolved by name, not in ``list_archs``
    (nor in ``all_cells``), which hold the JAX package's archs."""
    _PORT_ONLY[cfg.name] = cfg
    _SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def _ensure_loaded() -> None:
    # importing the arch modules populates the registry
    from repro_torch.configs import archs  # noqa: F401


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name in _PORT_ONLY:
        return _PORT_ONLY[name]
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_REGISTRY) + sorted(_PORT_ONLY)}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _SMOKE_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_SMOKE_REGISTRY)}")
    return _SMOKE_REGISTRY[name]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


# Which (arch, shape) cells are runnable; the rest are documented skips.
PURE_ATTENTION_FAMILIES = ("dense", "moe", "encdec", "vlm")


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Return (runnable, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and cfg.family in PURE_ATTENTION_FAMILIES:
        return False, (
            "long_500k requires sub-quadratic attention / bounded state; "
            f"{cfg.name} is pure full-attention (see DESIGN.md skip list)"
        )
    return True, ""


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """Every (arch, shape) pair with runnability flag + skip reason."""
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, why = cell_is_runnable(cfg, shape)
            out.append((arch, sname, ok, why))
    return out
