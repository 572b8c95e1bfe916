"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), ported from
``repro/models/whisper.py``.

The conv mel frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, F, d_model).  Positions are sinusoidal
and there is no RoPE.  The encoder is non-causal over all F frames.  A
decoder block runs causal self-attention, cross-attention over the
encoder's output and the MLP.  Decode keeps a causal self-attention cache
and the cross-attention K/V, which prefill computes once and decode only
reads.

Both stacks (``enc_blocks``, ``dec_blocks``) are walked by views of their
stacked leaves, or given as lists of per-layer trees, as the training
step passes them.  In training each block of both stacks is
checkpointed whole when ``run.remat`` is not "none": the JAX package
wraps them in a plain ``jax.checkpoint`` for "dots" too.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.sharding import rules as SR

Params = Dict[str, Any]


def param_defs(cfg: ModelConfig) -> Params:
    ne, nd = cfg.encoder_layers, cfg.num_layers
    return {
        "embed": L.embed_defs(cfg),
        "enc_blocks": {
            "ln1": L.norm_defs(ne, cfg.d_model),
            "attn": L.attention_defs(cfg, ne),
            "ln2": L.norm_defs(ne, cfg.d_model),
            "mlp": L.mlp_defs(cfg, ne),
        },
        "enc_ln_f": L.norm_defs(0, cfg.d_model),
        "dec_blocks": {
            "ln1": L.norm_defs(nd, cfg.d_model),
            "self_attn": L.attention_defs(cfg, nd),
            "ln_x": L.norm_defs(nd, cfg.d_model),
            "cross_attn": L.attention_defs(cfg, nd),
            "ln2": L.norm_defs(nd, cfg.d_model),
            "mlp": L.mlp_defs(cfg, nd),
        },
        "dec_ln_f": L.norm_defs(0, cfg.d_model),
    }


def _layer(blocks, i: int) -> Params:
    return blocks[i] if isinstance(blocks, list) else P.layer(blocks, i)


def _call(fn, run: RunConfig, *args):
    """``fn(*args)``, checkpointed whole in training unless remat is
    "none"."""
    if run.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {run.remat!r}")
    if run.remat != "none" and torch.is_grad_enabled():
        return SR.checkpoint(fn, *args)
    return fn(*args)


def _add_positions(x: torch.Tensor, pos: int, cfg: ModelConfig
                   ) -> torch.Tensor:
    positions = pos + torch.arange(x.shape[1], device=x.device)
    return x + L.sinusoidal_positions(positions, cfg.d_model).to(
        x.dtype)[None]


def _gathered(p: Params, cfg: ModelConfig, stack: str) -> Params:
    """A layer of ``stack`` gathered from this rank's blocks, its ``model``
    split kept (under sharding rules; ``p`` itself without)."""
    if not SR.sharded():
        return p
    return SR.gather_params(p, P.unstack(param_defs(cfg)[stack]),
                            keep=("model",))


def _enc_block(p: Params, cfg: ModelConfig, run: RunConfig,
               x: torch.Tensor) -> torch.Tensor:
    p = _gathered(p, cfg, "enc_blocks")
    a = L.rmsnorm(p["ln1"], x, cfg, run)
    a, _ = L.attention(p["attn"], cfg, run, a, pos=0, causal=False,
                       use_rope=False)
    x = x + a
    m = L.rmsnorm(p["ln2"], x, cfg, run)
    return x + L.mlp(p["mlp"], cfg, run, m)


def encode(params: Params, cfg: ModelConfig, run: RunConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d_model) precomputed embeddings (stub frontend), cast
    to the model's dtype (the JAX package keeps the frames' dtype: the same
    for a bf16 model)."""
    x = _add_positions(frames.to(params["embed"]["tok"].dtype), 0, cfg)
    for i in range(cfg.encoder_layers):
        x = _call(_enc_block, run, _layer(params["enc_blocks"], i), cfg,
                  run, x)
    return L.rmsnorm(params["enc_ln_f"], x, cfg, run)


def _dec_block(p: Params, cfg: ModelConfig, run: RunConfig, x: torch.Tensor,
               pos: int, enc_out: Optional[torch.Tensor],
               self_c: Optional[Params], cross_c: Optional[Params],
               kv_len: Optional[int]) -> torch.Tensor:
    p = _gathered(p, cfg, "dec_blocks")
    h = L.rmsnorm(p["ln1"], x, cfg, run)
    h, _ = L.attention(p["self_attn"], cfg, run, h, pos=pos, cache=self_c,
                       kv_len=kv_len, use_rope=False)
    x = x + h
    h = L.rmsnorm(p["ln_x"], x, cfg, run)
    # cross-attention: enc_out given at prefill / training; the cached
    # K/V at decode
    h, _ = L.attention(p["cross_attn"], cfg, run, h, pos=pos, causal=False,
                       xkv=enc_out, cache=cross_c,
                       cache_read_only=enc_out is None, use_rope=False)
    x = x + h
    h = L.rmsnorm(p["ln2"], x, cfg, run)
    return x + L.mlp(p["mlp"], cfg, run, h)


def _run_decoder(params: Params, cfg: ModelConfig, run: RunConfig,
                 tokens: torch.Tensor, enc_out: Optional[torch.Tensor],
                 pos: int, cache: Optional[Params] = None,
                 kv_len: Optional[int] = None) -> torch.Tensor:
    """Every decoder block, then ``dec_ln_f``.  A given cache ({"self",
    "cross"}) is updated in place, each layer's slice a view into its
    stack."""
    x = _add_positions(L.embed(params["embed"], cfg, tokens), pos, cfg)
    for i in range(cfg.num_layers):
        sc = None if cache is None else P.layer(cache["self"], i)
        cc = None if cache is None else P.layer(cache["cross"], i)
        x = _call(_dec_block, run, _layer(params["dec_blocks"], i), cfg,
                  run, x, pos, enc_out, sc, cc, kv_len)
    return L.rmsnorm(params["dec_ln_f"], x, cfg, run)


def forward(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any]) -> torch.Tensor:
    """Training forward -> the decoder's final hidden states (B, S, d)."""
    enc_out = encode(params, cfg, run, batch["frames"])
    return _run_decoder(params, cfg, run, batch["tokens"], enc_out, 0)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return {
        "self": L.kv_cache_defs(cfg, cfg.num_layers, batch, max_len),
        "cross": L.kv_cache_defs(cfg, cfg.num_layers, batch,
                                 cfg.encoder_frames),
    }


def prefill(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any], cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    """Encodes ``frames``, fills the self cache from the (B, S) decoder
    prompt and the cross cache from the encoder's output; returns
    last-position logits (B, 1, V) and the cache (filled in place)."""
    enc_out = encode(params, cfg, run, batch["frames"])
    tokens = batch["tokens"]
    x = _run_decoder(params, cfg, run, tokens, enc_out, 0, cache=cache,
                     kv_len=tokens.shape[1])
    return L.logits_out(params["embed"], cfg, run, x[:, -1:]), cache


def decode(params: Params, cfg: ModelConfig, run: RunConfig,
           tokens: torch.Tensor, cache: Params, pos: int
           ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); pos: current length (int)."""
    x = _run_decoder(params, cfg, run, tokens, None, pos, cache=cache,
                     kv_len=pos + 1)
    return L.logits_out(params["embed"], cfg, run, x), cache
