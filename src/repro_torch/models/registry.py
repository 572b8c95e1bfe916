"""Model registry: family -> module dispatch, and input synthesis.

Ported from ``repro/models/registry.py`` for every family of the zoo:
dense, moe and vlm (``transformer``), ssm (``mamba2``), hybrid
(``hybrid``) and encdec (``whisper``).  Every model module exposes
``param_defs``, ``forward``, ``cache_defs``, ``prefill`` and ``decode``
with the signatures of the JAX package (``pos`` is a Python int).  The
modality frontends (whisper's mel conv, llava's vision tower) are stubs,
as in the JAX package: the inputs carry precomputed frame or patch
embeddings.

Under sharding rules ``params`` holds this rank's blocks of each weight;
``forward``, ``prefill`` and ``decode`` gather every subtree but the
layer stacks (``gather_top``; the stacks a layer at a time, inside the
blocks), keeping each weight's ``model`` split: the embedding, the LM
head and zamba2's shared block compute this rank's block.
"""
from __future__ import annotations

from types import ModuleType
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import obs
from repro_torch.models import hybrid, mamba2, transformer, whisper
from repro_torch.sharding import rules as SR

Params = Dict[str, Any]

_FAMILY_MODULES: Dict[str, ModuleType] = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": mamba2,
    "hybrid": hybrid,
    "encdec": whisper,
}


def module_for(cfg: ModelConfig) -> ModuleType:
    try:
        return _FAMILY_MODULES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet") from None


def param_defs(cfg: ModelConfig) -> Params:
    return module_for(cfg).param_defs(cfg)


def modality_input(cfg: ModelConfig) -> Optional[Tuple[str, int]]:
    """The precomputed embeddings a family takes beside its tokens, as
    (batch key, length): whisper's ``frames``, a VLM's ``img_embeds``;
    None for the other families."""
    if cfg.family == "encdec":
        return "frames", cfg.encoder_frames
    if cfg.family == "vlm":
        return "img_embeds", cfg.num_img_patches
    return None


def layer_stacks(cfg: ModelConfig) -> Dict[str, int]:
    """The subtrees of the param tree stacked on a leading layer axis,
    with their depths: whisper's encoder and decoder stacks, or every
    other family's ``blocks``."""
    if cfg.family == "encdec":
        return {"enc_blocks": cfg.encoder_layers,
                "dec_blocks": cfg.num_layers}
    return {"blocks": cfg.num_layers}


def gather_top(params: Params, cfg: ModelConfig) -> Params:
    """Under sharding rules, the tree with every subtree but the layer
    stacks gathered over every axis but ``model``; ``params`` itself
    without rules."""
    if not SR.sharded():
        return params
    defs, stacks = param_defs(cfg), layer_stacks(cfg)
    return {k: v if k in stacks else SR.gather_params(v, defs[k],
                                                      keep=("model",))
            for k, v in params.items()}


def forward(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any]) -> torch.Tensor:
    return module_for(cfg).forward(gather_top(params, cfg), cfg, run, batch)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return module_for(cfg).cache_defs(cfg, batch, max_len)


@obs.spanned("serve.prefill")
def prefill(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any], cache: Params):
    return module_for(cfg).prefill(gather_top(params, cfg), cfg, run, batch,
                                   cache)


@obs.spanned("serve.decode")
def decode(params: Params, cfg: ModelConfig, run: RunConfig,
           tokens: torch.Tensor, cache: Params, pos: int):
    return module_for(cfg).decode(gather_top(params, cfg), cfg, run, tokens,
                                  cache, pos)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device: str = "meta") -> Dict[str, Any]:
    """Empty inputs of one step of ``shape.kind`` (on ``meta``: nothing
    allocated), for the dry run, as ``repro/models/registry.py::
    input_specs`` gives them and in the dtypes ``synth_inputs`` draws:
    train ``tokens``, ``labels`` (B, S) and a f32 ``loss_mask``; prefill
    ``tokens``; both with whisper's ``frames`` or a VLM's ``img_embeds``
    (bf16).  Decode: ``tokens`` (B, 1) and ``pos``, the Python int
    ``seq_len - 1``: the new token's position in a cache of seq_len."""
    B, S = shape.global_batch, shape.seq_len

    def empty(*size, dtype=torch.int64):
        return torch.empty(size, dtype=dtype, device=device)

    if shape.kind == "decode":
        return {"tokens": empty(B, 1), "pos": S - 1}
    specs: Dict[str, Any] = {"tokens": empty(B, S)}
    if shape.kind == "train":
        specs["labels"] = empty(B, S)
        specs["loss_mask"] = empty(B, S, dtype=torch.float32)
    extra = modality_input(cfg)
    if extra:
        name, n = extra
        specs[name] = empty(B, n, cfg.d_model, dtype=torch.bfloat16)
    return specs


def synth_inputs(generator: torch.Generator, cfg: ModelConfig,
                 shape: ShapeConfig, kind: Optional[str] = None,
                 device: str = "cuda") -> Dict[str, Any]:
    """Random inputs for one (shape, kind), drawn from ``generator``
    (which must live on ``device``), as in ``repro/models/registry.py::
    synth_inputs``: ``tokens`` (B, S); for ``"train"`` also ``labels``
    (B, S) and a float ``loss_mask`` of ones; for whisper ``frames`` (B,
    encoder_frames, d_model) and for a VLM ``img_embeds`` (B,
    num_img_patches, d_model), bf16, normal times 0.02."""
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
    extra = modality_input(cfg)
    if extra:
        name, n = extra
        out[name] = (torch.randn((B, n, cfg.d_model), generator=generator,
                                 device=device) * 0.02).to(torch.bfloat16)
    return out
