"""Serving steps: prefill (fill the cache from a prompt) and greedy decode
(one token), ported from ``repro/serve/engine.py``.  The cache is what
the model family's ``cache_defs`` describe: a KV cache (dense), conv
tails and SSM states (ssm), or both (hybrid)."""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.sharding import rules as SR

Cache = Dict[str, Any]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda") -> Cache:
    """Zeros of ``batch`` rows (under rules: this rank's rows).  With
    ``model`` split over more than one rank, each KV leaf holds this
    rank's ``model`` block of its spec, as ``ShardingRules.spec`` resolves
    it: its positions (``"kv_seq"``, where ``max_len`` divides), else its
    kv heads, else all of it; a stack split over positions is marked with
    them (``layers.mark_kv_positions``: first, count).  Where the mamba
    blocks split (``mamba2.ssm_split``), their states hold the rank's
    block: ``tail_x`` the ``din / n`` channels it convolves (its ``ffn``
    block by SSM heads, or its head-dim channels of every head), ``ssm``
    its ``("heads_ssm", "ssm_p")`` block; the B and C tails stay whole."""
    return _cache(cfg, batch, max_len, device, torch.zeros)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: Union[str, torch.device] = "meta") -> Cache:
    """``init_cache``'s leaves as empty tensors (on ``meta``: nothing
    allocated), for the dry run: under rules the rank's blocks, a stack
    split over positions marked with them."""
    return _cache(cfg, batch, max_len, device, torch.empty)


def _cache(cfg, batch, max_len, device, make) -> Cache:
    defs = registry.cache_defs(cfg, batch, max_len)
    split = SR.model_ranks() > 1
    ssm_split = split and cfg.family in ("ssm", "hybrid") and \
        M.ssm_split(cfg) in ("heads", "p")

    def leaf(d):
        kv = split and "kv_seq" in d.logical
        ssm = ssm_split and ("ffn" in d.logical or "heads_ssm" in d.logical)
        if not (kv or ssm):
            return make(d.shape, dtype=d.dtype, device=device)
        r = SR.current_rules()
        shape = r.local_shape(d.logical, d.shape, keep=("model",))
        t = make(shape, dtype=d.dtype, device=device)
        if kv:
            i = d.logical.index("kv_seq")
            if shape[i] != d.shape[i]:
                L.mark_kv_positions(t, r.mesh.coord("model") * shape[i],
                                    shape[i])
        return t
    return P.tree_map(leaf, defs)


def prefill_step(params, batch: Dict[str, Any], cache: Cache, *,
                 cfg: ModelConfig, run: RunConfig
                 ) -> Tuple[torch.Tensor, Cache]:
    """Prompt (B, S) -> (next-token ids (B, 1), filled cache)."""
    logits, cache = registry.prefill(params, cfg, run, batch, cache)
    return logits[:, -1].argmax(dim=-1, keepdim=True), cache


def decode_step(params, tokens: torch.Tensor, cache: Cache, pos: int, *,
                cfg: ModelConfig, run: RunConfig
                ) -> Tuple[torch.Tensor, Cache]:
    """One greedy decode step.  tokens: (B, 1) ids; pos: current length."""
    logits, cache = registry.decode(params, cfg, run, tokens, cache, pos)
    return logits[:, -1].argmax(dim=-1, keepdim=True), cache
