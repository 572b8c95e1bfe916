"""Serving steps: prefill (fill the cache from a prompt) and greedy decode
(one token), ported from ``repro/serve/engine.py``.  The cache is what
the model family's ``cache_defs`` describe: a KV cache (dense), conv
tails and SSM states (ssm), or both (hybrid)."""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import params as P
from repro_torch.models import registry

Cache = Dict[str, Any]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda") -> Cache:
    defs = registry.cache_defs(cfg, batch, max_len)
    return P.tree_map(
        lambda d: torch.zeros(d.shape, dtype=d.dtype, device=device), defs)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: Union[str, torch.device] = "meta") -> Cache:
    """The cache as empty tensors (on ``meta``: nothing allocated), for
    the dry run."""
    return P.abstract(registry.cache_defs(cfg, batch, max_len), device)


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
