"""Granite 4.0-H hybrid (Hugging Face ``granitemoehybrid``): a stack of
Mamba2 and attention mixers, each followed by a sparse MoE with a shared
expert, with scale factors on the embedding, the attention scores, both
residual branches and the logits.

    x = embedding_multiplier * E[ids]
    for each layer l:
        h = RMSNorm_in,l(x)
        m = Attn_l(h) if l in attn_layers else Mamba2_l(h)
        x = x + residual_multiplier * m
        h = RMSNorm_post,l(x)
        x = x + residual_multiplier * (MoE_l(h) + Shared_l(h))
    logits = (RMSNorm_f(x) W_head^T) / logits_scaling

Attention is ``layers.attention``: causal GQA, softmax scale
``attention_multiplier``, no rotary (``use_rope`` False: NoPE).  The
Mamba2 mixer is ``mamba2.mixer``, the block without its norm and
residual.  The MoE is ``layers.moe_block`` over the dropless routed-rows
path (``moe_dropless``), whose shared expert every token takes.

Leaves are stacked on a leading ``"layers"`` dim by kind: the Mamba2
mixers over the Mamba2 layers, attention over the attention layers, the
two norms and the MoE over all layers.  The cache is flat: ``k`` and
``v`` stacked over the attention layers, the conv tails and SSM states
over the Mamba2 layers, all updated in place.  ``forward`` returns the
final hidden states; the logits of ``prefill`` and ``decode`` carry the
``logits_scaling``.  One rank: no sharding rule splits this family.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import obs
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.params import layer
from repro_torch.sharding import rules as SR

Params = Dict[str, Any]
_SSM_STATE = ("tail_x", "tail_B", "tail_C", "ssm")
# tokens a Mamba2 mixer takes at once, in whole batch rows: at d 4096
# its temporaries take ~1.3 GB for 8192 tokens, which a card that holds
# the 65 GB of weights has room for (16 x 4096 at once has not)
MIXER_TOKEN_BLOCK = 8_192


def mamba_layers(cfg: ModelConfig) -> List[int]:
    return [i for i in range(cfg.num_layers) if i not in cfg.attn_layers]


def param_defs(cfg: ModelConfig) -> Params:
    n, d = cfg.num_layers, cfg.d_model
    return {
        "embed": L.embed_defs(cfg),
        "blocks": {
            "ln_in": L.norm_defs(n, d),
            "ln_post": L.norm_defs(n, d),
            "mamba": M.mixer_defs(cfg, len(mamba_layers(cfg))),
            "attn": L.attention_defs(cfg, len(cfg.attn_layers)),
            "moe": L.moe_defs(cfg, n),
        },
        "ln_f": L.norm_defs(0, d),
    }


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return {**L.kv_cache_defs(cfg, len(cfg.attn_layers), batch, max_len),
            **M.state_defs(cfg, len(mamba_layers(cfg)), batch)}


def _run(params: Params, cfg: ModelConfig, run: RunConfig, x: torch.Tensor,
         pos: int, cache: Optional[Params] = None,
         kv_len: Optional[int] = None) -> torch.Tensor:
    if SR.sharded():
        raise NotImplementedError("granite_hybrid runs on one rank")
    b, r = params["blocks"], cfg.residual_multiplier
    scale = cfg.attention_multiplier or None
    kv = [k for k in (cache or {}) if k not in _SSM_STATE]
    n_attn = n_mamba = 0
    for i in range(cfg.num_layers):
        h = L.rmsnorm(b["ln_in"][i], x, cfg, run)
        if i in cfg.attn_layers:
            c = None if cache is None else {k: cache[k][n_attn] for k in kv}
            h, _ = L.attention(layer(b["attn"], n_attn), cfg, run, h,
                               pos=pos, cache=c, kv_len=kv_len,
                               use_rope=cfg.use_rope, scale=scale)
            n_attn += 1
        else:
            s = None if cache is None else {k: cache[k][n_mamba]
                                            for k in _SSM_STATE}
            with obs.span("block.mamba2"):
                h = _mamba(layer(b["mamba"], n_mamba), cfg, run, h, s)
            n_mamba += 1
        x = torch.add(x, h, alpha=r)
        h = L.rmsnorm(b["ln_post"][i], x, cfg, run)
        x = torch.add(x, L.moe_block(layer(b["moe"], i), cfg, run, h),
                      alpha=r)
    return L.rmsnorm(params["ln_f"], x, cfg, run)


def _mamba(p: Params, cfg: ModelConfig, run: RunConfig, h: torch.Tensor,
           state: Optional[Params]) -> torch.Tensor:
    """``mamba2.mixer`` over ``MIXER_TOKEN_BLOCK`` tokens' worth of batch
    rows at a time (rows are independent: each has its own state), each
    block under a batch split of its rows."""
    B, S, _ = h.shape
    rows = max(1, MIXER_TOKEN_BLOCK // S)
    if rows >= B:
        return M.mixer(p, cfg, run, h, state)
    split = SR.current_split()
    axes = () if split is None else split[1]
    out = torch.empty_like(h)
    for r0 in range(0, B, rows):
        hb = h[r0:r0 + rows]
        s = None if state is None else {k: v[r0:r0 + rows]
                                        for k, v in state.items()}
        with SR.batch_split(hb.shape[0], axes):
            out[r0:r0 + rows] = M.mixer(p, cfg, run, hb, s)
    return out


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    return L.embed(params["embed"], cfg, tokens) * cfg.embedding_multiplier


def _logits(params: Params, cfg: ModelConfig, run: RunConfig,
            x: torch.Tensor) -> torch.Tensor:
    return L.logits_out(params["embed"], cfg, run, x) / cfg.logits_scaling


def forward(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any]) -> torch.Tensor:
    """Forward over a (B, S) batch -> final hidden states (B, S, d)."""
    return _run(params, cfg, run, _embed(params, cfg, batch["tokens"]), 0)


def prefill(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any], cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    """Fills the cache from a (B, S) prompt; returns last-position logits
    (B, 1, V) and the cache (the same object, filled in place)."""
    x = _embed(params, cfg, batch["tokens"])
    x = _run(params, cfg, run, x, 0, cache, kv_len=x.shape[1])
    return _logits(params, cfg, run, x[:, -1:]), cache


def decode(params: Params, cfg: ModelConfig, run: RunConfig,
           tokens: torch.Tensor, cache: Params, pos: int
           ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); pos: current length (int)."""
    x = _embed(params, cfg, tokens)
    x = _run(params, cfg, run, x, pos, cache, kv_len=pos + 1)
    return _logits(params, cfg, run, x), cache
