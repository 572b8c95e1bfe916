"""Decoder-only transformer, dense, MoE and VLM families, ported from
``repro/models/transformer.py``.  An MoE block has ``block["moe"]`` (top-k
experts, ``layers.moe_block``) where a dense one has ``block["mlp"]``.  A
VLM (llava) puts its precomputed patch embeddings (``img_embeds``, cast to
the activations' dtype) in front of the token embeddings; positions run
over the whole sequence, so RoPE covers the patches.

Layers are stacked on a leading L axis as in the JAX tree; a Python loop
over layers takes the place of ``lax.scan``.  ``run.remat="full"`` wraps
each block in ``torch.utils.checkpoint`` as ``jax.checkpoint`` does;
``"dots"`` checkpoints it selectively, saving the outputs of the 2-D
products with no batch dims (the projections ``x @ W``: ``aten.mm`` and
``aten.addmm``) and recomputing everything else, as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does.
Attention's batched products (``bmm``) and the kernels' outputs are
recomputed.
``params["blocks"]`` may also be a list of per-layer trees (views into the
stacks): the training step passes that, so that autograd takes each
layer's gradient on its own view instead of on the whole stack.

Under sharding rules each block gathers its layer's weights from this
rank's blocks when it starts (inside the checkpointed function, so remat
gathers again in the backward), keeping their ``model`` split: attention
and the MLP compute this rank's block (``layers.py``); the MoE block
gathers its own.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import obs
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.sharding import rules as SR

Params = Dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not a decoder-only transformer")


def param_defs(cfg: ModelConfig) -> Params:
    _check_family(cfg)
    n = cfg.num_layers
    block: Params = {
        "ln1": L.norm_defs(n, cfg.d_model),
        "attn": L.attention_defs(cfg, n),
        "ln2": L.norm_defs(n, cfg.d_model),
    }
    if cfg.family == "moe":
        block["moe"] = L.moe_defs(cfg, n)
    else:
        block["mlp"] = L.mlp_defs(cfg, n)
    return {
        "embed": L.embed_defs(cfg),
        "blocks": block,
        "ln_f": L.norm_defs(0, cfg.d_model),
    }


def _block(p_l: Params, cfg: ModelConfig, run: RunConfig, x: torch.Tensor,
           pos: int, cache_l: Optional[Params], kv_len: Optional[int]
           ) -> torch.Tensor:
    with obs.span("block.decoder"):
        out = _decoder_block(p_l, cfg, run, x, pos, cache_l, kv_len)
    obs.grad_span("block.decoder.bwd", x, out)
    return out


def _decoder_block(p_l: Params, cfg: ModelConfig, run: RunConfig,
                   x: torch.Tensor, pos: int, cache_l: Optional[Params],
                   kv_len: Optional[int]) -> torch.Tensor:
    if SR.sharded():
        defs = P.unstack(param_defs(cfg)["blocks"])
        p_l = {k: v if k == "moe" else SR.gather_params(
            v, defs[k], keep=("model",)) for k, v in p_l.items()}
    h = L.rmsnorm(p_l["ln1"], x, cfg, run)
    h, _ = L.attention(p_l["attn"], cfg, run, h, pos=pos, cache=cache_l,
                       kv_len=kv_len)
    x = x + h
    h = L.rmsnorm(p_l["ln2"], x, cfg, run)
    if cfg.family == "moe":
        return x + L.moe_block(p_l["moe"], cfg, run, h)
    return x + L.mlp(p_l["mlp"], cfg, run, h)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _run_blocks(params: Params, cfg: ModelConfig, run: RunConfig,
                x: torch.Tensor, pos: int, cache: Optional[Params] = None,
                kv_len: Optional[int] = None,
                remat: str = "none") -> torch.Tensor:
    """Runs every block, then ``ln_f``.  A given cache is updated in place
    (each layer's slice is a view into the stack).  With grad mode on,
    ``remat="full"`` keeps only each block's input for the backward and
    runs the block again there; ``"dots"`` keeps the projections' outputs
    too and runs the rest of the block again."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        p_l = blocks[i] if isinstance(blocks, list) else P.layer(blocks, i)
        c_l = None if cache is None else P.layer(cache, i)
        if remat != "none" and torch.is_grad_enabled():
            x = SR.checkpoint(
                _block, p_l, cfg, run, x, pos, c_l, kv_len,
                context_fn=_dots_context if remat == "dots" else None)
        else:
            x = _block(p_l, cfg, run, x, pos, c_l, kv_len)
    return L.rmsnorm(params["ln_f"], x, cfg, run)


def _embed_inputs(params: Params, cfg: ModelConfig,
                  batch: Dict[str, Any]) -> torch.Tensor:
    x = L.embed(params["embed"], cfg, batch["tokens"])
    if cfg.family == "vlm" and "img_embeds" in batch:
        x = torch.cat([batch["img_embeds"].to(x.dtype), x], dim=1)
    return x


def forward(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any]) -> torch.Tensor:
    """Forward over a (B, S) batch -> final hidden states (B, S_total, d),
    S_total counting a VLM's patches."""
    _check_family(cfg)
    x = _embed_inputs(params, cfg, batch)
    return _run_blocks(params, cfg, run, x, 0, remat=run.remat)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return L.kv_cache_defs(cfg, cfg.num_layers, batch, max_len)


def prefill(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any], cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    """Fills the cache from a (B, S) prompt (after a VLM's patches);
    returns last-position logits (B, 1, V) and the cache (the same object,
    filled in place)."""
    _check_family(cfg)
    x = _embed_inputs(params, cfg, batch)
    S = x.shape[1]
    x = _run_blocks(params, cfg, run, x, 0, cache=cache, kv_len=S)
    return L.logits_out(params["embed"], cfg, run, x[:, -1:]), cache


def decode(params: Params, cfg: ModelConfig, run: RunConfig,
           tokens: torch.Tensor, cache: Params, pos: int
           ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); pos: current length (int)."""
    _check_family(cfg)
    x = L.embed(params["embed"], cfg, tokens)
    x = _run_blocks(params, cfg, run, x, pos, cache=cache, kv_len=pos + 1)
    return L.logits_out(params["embed"], cfg, run, x), cache
