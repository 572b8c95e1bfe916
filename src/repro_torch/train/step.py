"""Training step: gradients (with microbatch accumulation) and the AdamW
update, ported from ``repro/train/step.py``.

The state is a plain dict — params, optimizer moments, step — as in the
JAX package.  Unlike the JAX step, which is pure, ``train_step`` updates
the state IN PLACE (params and moments) and returns it: a yi-6b state
fills most of one card, so no second copy is made.

Gradients are taken on per-layer views.  The params keep their stacked
(L, ...) leaves; for the backward, each layer's slice becomes a leaf of
its own (a view that shares the stack's memory) and a hook adds its
gradient into the layer's slice of one stacked gradient buffer as soon as
autograd has it.  Every stacked subtree of the tree is walked so
(``registry.layer_stacks``: ``blocks``, or whisper's ``enc_blocks`` and
``dec_blocks``).  Indexing the stacks inside the graph instead would make
autograd build a zero tensor of the whole stack for every layer and add
them up: for the 2.9 GB MLP stacks of yi-6b, 32 whole-stack temporaries
per leaf per step.

Under sharding rules (``repro_torch.sharding.use_rules``) the state holds
this rank's blocks (params and moments alike, ZeRO style) and the step
takes the GLOBAL batch, as the JAX step does: each rank runs its rows
(``ShardingRules.rows``: a block of every microbatch), the loss weighs
each rank by the global count of valid tokens, the gradients of its
blocks are summed over the batch axes (the gathers' backward and
``sync_grads``), the global norm adds every block once, and AdamW steps
each rank's blocks.  With ``model`` split over ranks, a weight split over
``model`` gets this rank's block of the gradient from its own block of
the compute (summed over nothing in ``model``); a weight the query-row
attention uses whole is summed over ``model`` by its gather's backward
(``sharding.model_whole``); a weight replicated over ``model`` (norms, a
router, ``b_down``) gets the same gradient on every model rank, since the
split regions' ``enter_model`` / ``leave_model`` keep the residual stream
and its gradient replicated.  At world size 1 this is the step without
rules, bit for bit.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.sharding import rules as S
from repro_torch.train.loss import lm_loss

TrainState = Dict[str, Any]


def init_state(generator: torch.Generator, cfg: ModelConfig,
               run: RunConfig) -> TrainState:
    """Params drawn from ``generator`` on its device (under rules, this
    rank's blocks), zero moments."""
    params = P.materialize(registry.param_defs(cfg), generator,
                           generator.device)
    opt = adamw_init(params, dtype=getattr(torch, run.opt_state_dtype))
    return {"params": params, "opt": opt}


def state_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The ParamDefs of a train state's leaves (the moments share their
    param's; the step is None): where each leaf's blocks lie under
    sharding rules, for checkpoints."""
    defs = registry.param_defs(cfg)
    return {"params": defs, "opt": {"m": defs, "v": defs, "step": None}}


def _add_into(buf: torch.Tensor) -> Callable[[torch.Tensor], None]:
    def hook(leaf: torch.Tensor) -> None:
        buf.add_(leaf.grad)
        leaf.grad = None  # the buffer holds it now
    return hook


def _zip_map(f, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(f, a[k], b[k]) for k in a}
    return f(a, b)


def _grad_leaves(params, bufs, stacks: Dict[str, int]):
    """The params as a tree of fresh leaves that require grad — each
    stacked subtree named in ``stacks`` as a list of per-layer trees of
    views into the stacks — each with a hook that adds its gradient into
    the matching slice of ``bufs``.  Returns (tree, leaves)."""
    leaves: List[torch.Tensor] = []

    def leaf(p: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
        t = p.detach().requires_grad_()
        t.register_post_accumulate_grad_hook(_add_into(buf))
        leaves.append(t)
        return t

    tree = {k: _zip_map(leaf, v, bufs[k])
            for k, v in params.items() if k not in stacks}
    for k, n in stacks.items():
        tree[k] = [_zip_map(lambda p, b: leaf(p[i], b[i]), params[k],
                            bufs[k]) for i in range(n)]
    return tree, leaves


def _split_microbatches(batch: Dict[str, Any],
                        accum: int) -> List[Dict[str, Any]]:
    def split(x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        assert B % accum == 0, (B, accum)
        return x.reshape(accum, B // accum, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def grads_and_metrics(params, cfg: ModelConfig, run: RunConfig,
                      batch: Dict[str, Any]):
    """Loss and gradients, with ``run.accum_steps`` microbatches summed in
    f32 and averaged (one microbatch: gradients in the params' dtypes).
    Under rules ``params`` are this rank's blocks, ``batch`` the global
    batch, and the gradients this rank's blocks of the global ones."""
    accum = max(run.accum_steps, 1)
    r = S.current_rules()
    split = None if r is None else r.local_batch(batch, accum)
    if split is None:
        return _grads_and_metrics(params, cfg, run, batch, accum)
    local, rows, axes = split
    with S.batch_split(rows, axes):
        grads, metrics = _grads_and_metrics(params, cfg, run, local, accum)
        S.sync_grads(grads, registry.param_defs(cfg))
    return grads, metrics


def _grads_and_metrics(params, cfg: ModelConfig, run: RunConfig,
                       batch: Dict[str, Any], accum: int):
    gdtype = (lambda p: p.dtype) if accum == 1 else (
        lambda p: torch.float32)
    grads = P.tree_map(lambda p: torch.zeros(p.shape, dtype=gdtype(p),
                                             device=p.device), params)
    tree, _ = _grad_leaves(params, grads, registry.layer_stacks(cfg))
    if accum == 1:
        loss, aux = lm_loss(tree, cfg, run, batch)
        loss.backward()
        return grads, {"loss": loss.detach(),
                       **{k: v.detach() for k, v in aux.items()}}
    l_sum = torch.zeros((), device=batch["tokens"].device)
    for mb in _split_microbatches(batch, accum):
        loss, aux = lm_loss(tree, cfg, run, mb)
        loss.backward()
        l_sum += aux["loss"].detach()
    inv = 1.0 / accum
    for g in P.tree_leaves(grads):
        g.mul_(inv)
    return grads, {"loss": l_sum * inv}


def train_step(state: TrainState, batch: Dict[str, Any], *,
               cfg: ModelConfig, run: RunConfig
               ) -> Tuple[TrainState, Dict[str, Any]]:
    """One step: gradients, optional bf16 gradient compression, the cosine
    learning rate and AdamW, IN PLACE.  Returns (state, metrics)."""
    params, opt = state["params"], state["opt"]
    grads, metrics = grads_and_metrics(params, cfg, run, batch)
    if run.grad_compression == "bf16":
        grads = P.tree_map(lambda g: g.to(torch.bfloat16), grads)
    lr = cosine_schedule(opt["step"] + 1, base_lr=run.learning_rate,
                         warmup_steps=run.warmup_steps,
                         total_steps=run.total_steps)
    _, _, opt_metrics = adamw_update(
        params, grads, opt, lr=lr, weight_decay=run.weight_decay,
        max_grad_norm=run.max_grad_norm,
        norm_axes=(S.sharded_axes(registry.param_defs(cfg))
                   if S.sharded() else None))
    metrics.update(opt_metrics)
    return state, metrics


def make_train_step(cfg: ModelConfig, run: RunConfig):
    """``(state, batch) -> (state, metrics)`` for this config."""
    return functools.partial(train_step, cfg=cfg, run=run)
