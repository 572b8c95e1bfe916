"""Zamba2-style hybrid, ported from ``repro/models/hybrid.py``: a Mamba2
backbone with one SHARED attention+MLP block applied after every
``attn_every`` SSM layers (arXiv:2411.15242; the per-application LoRA
adapters are omitted, as in the JAX package).  Blocks left over after the
last application run at the end.

Each application of the shared block has its own slice of a stacked bf16
KV cache; the Mamba2 conv tails and SSM states are stacked over all
layers.  Both are updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.params import layer

Params = Dict[str, Any]


def n_attn_applications(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def param_defs(cfg: ModelConfig) -> Params:
    return {
        "embed": L.embed_defs(cfg),
        "blocks": M.block_defs(cfg, cfg.num_layers),
        "shared_attn": {
            "ln1": L.norm_defs(0, cfg.d_model),
            "attn": L.attention_defs(cfg, 0),
            "ln2": L.norm_defs(0, cfg.d_model),
            "mlp": L.mlp_defs(cfg, 0),
        },
        "ln_f": L.norm_defs(0, cfg.d_model),
    }


def _shared_attn(p: Params, cfg: ModelConfig, run: RunConfig,
                 x: torch.Tensor, pos: int, cache_l: Optional[Params],
                 kv_len: Optional[int]) -> torch.Tensor:
    """``p``: the shared block's weights, this rank's ``model`` block of
    each (``registry.gather_top``), so attention and the MLP compute their
    block as a transformer block's do."""
    h = L.rmsnorm(p["ln1"], x, cfg, run)
    h, _ = L.attention(p["attn"], cfg, run, h, pos=pos, cache=cache_l,
                       kv_len=kv_len)
    x = x + h
    h = L.rmsnorm(p["ln2"], x, cfg, run)
    return x + L.mlp(p["mlp"], cfg, run, h)


def _run(params: Params, cfg: ModelConfig, run: RunConfig, x: torch.Tensor,
         pos: int, mamba_state: Optional[Params] = None,
         kv_cache: Optional[Params] = None,
         kv_len: Optional[int] = None) -> torch.Tensor:
    """Groups of ``attn_every`` mamba layers, each followed by one
    application of the shared block; then the remaining layers and
    ``ln_f``.  In training the mamba blocks are checkpointed by
    ``M.run_layers``; the shared block is not, as in the JAX package."""
    k = cfg.attn_every
    n_app = n_attn_applications(cfg)
    for g in range(n_app):
        x = M.run_layers(params, cfg, run, x, g * k, (g + 1) * k,
                         mamba_state)
        c_l = None if kv_cache is None else layer(kv_cache, g)
        x = _shared_attn(params["shared_attn"], cfg, run, x, pos, c_l,
                         kv_len)
    x = M.run_layers(params, cfg, run, x, n_app * k, cfg.num_layers,
                     mamba_state)
    return L.rmsnorm(params["ln_f"], x, cfg, run)


def forward(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any]) -> torch.Tensor:
    """Forward over a (B, S) batch -> final hidden states (B, S, d)."""
    x = L.embed(params["embed"], cfg, batch["tokens"])
    return _run(params, cfg, run, x, 0)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return {
        "mamba": M.state_defs(cfg, cfg.num_layers, batch),
        "kv": L.kv_cache_defs(cfg, n_attn_applications(cfg), batch,
                              max_len),
    }


def prefill(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any], cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    """Fills the cache from a (B, S) prompt; returns last-position logits
    (B, 1, V) and the cache (the same object, filled in place)."""
    x = L.embed(params["embed"], cfg, batch["tokens"])
    S = x.shape[1]
    x = _run(params, cfg, run, x, 0, mamba_state=cache["mamba"],
             kv_cache=cache["kv"], kv_len=S)
    return L.logits_out(params["embed"], cfg, run, x[:, -1:]), cache


def decode(params: Params, cfg: ModelConfig, run: RunConfig,
           tokens: torch.Tensor, cache: Params, pos: int
           ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); pos: current length (int)."""
    x = L.embed(params["embed"], cfg, tokens)
    x = _run(params, cfg, run, x, pos, mamba_state=cache["mamba"],
             kv_cache=cache["kv"], kv_len=pos + 1)
    return L.logits_out(params["embed"], cfg, run, x), cache
