"""Model registry: family -> module dispatch, and input synthesis.

Ported from ``repro/models/registry.py`` for the dense, ssm (mamba2) and
hybrid (zamba2) families; every model module exposes ``param_defs``, ``forward``, ``cache_defs``,
``prefill`` and ``decode`` with the signatures of the JAX package (``pos``
is a Python int).
"""
from __future__ import annotations

from types import ModuleType
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import hybrid, mamba2, transformer

Params = Dict[str, Any]

_FAMILY_MODULES: Dict[str, ModuleType] = {
    "dense": transformer,
    "ssm": mamba2,
    "hybrid": hybrid,
}


def module_for(cfg: ModelConfig) -> ModuleType:
    try:
        return _FAMILY_MODULES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet") from None


def param_defs(cfg: ModelConfig) -> Params:
    return module_for(cfg).param_defs(cfg)


def forward(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any]) -> torch.Tensor:
    return module_for(cfg).forward(params, cfg, run, batch)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return module_for(cfg).cache_defs(cfg, batch, max_len)


def prefill(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any], cache: Params):
    return module_for(cfg).prefill(params, cfg, run, batch, cache)


def decode(params: Params, cfg: ModelConfig, run: RunConfig,
           tokens: torch.Tensor, cache: Params, pos: int):
    return module_for(cfg).decode(params, cfg, run, tokens, cache, pos)


def synth_inputs(generator: torch.Generator, cfg: ModelConfig,
                 shape: ShapeConfig, kind: Optional[str] = None,
                 device: str = "cuda") -> Dict[str, Any]:
    """Random token inputs for one (shape, kind), drawn from
    ``generator`` (which must live on ``device``): ``tokens`` (B, S), and
    for ``"train"`` also ``labels`` (B, S) and a float ``loss_mask`` of
    ones, as in ``repro/models/registry.py::synth_inputs``."""
    kind = kind or shape.kind
    B, S = shape.global_batch, shape.seq_len
    if kind == "decode":
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, 1),
                                        generator=generator, device=device),
                "pos": S // 2}
    if kind not in ("prefill", "train"):
        raise NotImplementedError(f"inputs of kind {kind!r} are not ported")
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                   generator=generator, device=device)}
    if kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab_size, (B, S),
                                      generator=generator, device=device)
        out["loss_mask"] = torch.ones((B, S), dtype=torch.float32,
                                      device=device)
    return out
