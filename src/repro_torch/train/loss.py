"""LM loss head, ported from ``repro/train/loss.py``.

``ce_blockwise`` is the vocab-blockwise cross entropy with the custom
backward of the JAX package: the forward keeps per-token (max, sumexp,
target logit) statistics over vocab blocks, the backward recomputes each
block's logits and contracts them at once into the hidden and vocab-weight
gradients, so neither pass holds the (T, V) logits.  On CUDA the forward
statistics come from the hand-written CE kernel
(``kernels/cross_entropy.py``); on the CPU from its plain version.  The
backward's per-block products are plain ``torch.matmul`` calls, as they are
plain XLA products outside any Pallas kernel in the JAX package; they run
in f32 on the ``ce_dtype``-rounded inputs, which is exact for bf16 inputs,
so the logits are never rounded to bf16 before the ``exp``.

Under sharding rules that split the LM head's vocab rows over ``model``
(a vocab-parallel CE), each rank holds its rows of the head weight: the
forward's statistics come from them, with the targets shifted by the
shard's first id (a target in another shard adds nothing), as each
token's (max, sumexp, target logit) triple, which the ranks all-gather
and merge (the CE kernel's merge on CUDA); ``denom`` and the loss are
the global ones.  The backward's ``dw`` is this rank's rows, and its
``dh`` a part that the hidden states' ``enter_model`` sums over
``model``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import obs
from repro_torch.kernels import cross_entropy as _kce
from repro_torch.kernels import meter
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.sharding import rules as S


def _masked_mean(nll: torch.Tensor, valid: Optional[torch.Tensor],
                 denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NLL over the valid positions; with ``denom`` (a rank's share
    of a batch split over ranks: the global count of valid positions) the
    local sum over it, which the ranks' sum makes the global mean."""
    if denom is not None:
        return (nll if valid is None else nll * valid).sum() / denom
    if valid is not None:
        return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return nll.mean()


class CEBlockwiseFn(torch.autograd.Function):
    """Mean NLL with the custom backward of ``repro/train/loss.py::
    _ce_bwd``.  ``kernel`` selects the CE kernel for the forward
    statistics, else the plain version.  ``v0`` (a vocab shard's first id,
    None for the whole vocab) shifts the targets; the shards' statistics
    are merged over ``model``."""

    @staticmethod
    def forward(ctx, hidden, w_vocab, targets, valid, block_v: int,
                ce_dtype: torch.dtype, kernel: bool, denom=None, v0=None):
        hc, wc = hidden.to(ce_dtype), w_vocab.to(ce_dtype)
        if kernel:
            hc, wc = hc.contiguous(), wc.contiguous()
        if v0 is not None:
            targets = targets - v0
        with meter.charge("cross_entropy",
                          lambda: _kce.work(hc, wc, stats=v0 is not None)):
            if v0 is None and kernel:
                nll, lse = _kce.cross_entropy_cuda(hc, wc, targets)
            elif v0 is None:
                nll, lse = ref.cross_entropy_stats_ref(hc, wc, targets,
                                                       block_v=block_v)
            elif kernel:
                stats = _kce.cross_entropy_stats_cuda(hc, wc, targets)
            else:
                stats = ref.cross_entropy_partial_ref(hc, wc, targets,
                                                      block_v=block_v)
        if v0 is not None:
            parts = S.current_rules().all_gather(stats[None], 0, ("model",))
            nll, lse = (_kce.ce_merge_cuda(parts) if kernel
                        else ref.ce_merge_ref(parts))
        ctx.block_v, ctx.ce_dtype = block_v, ce_dtype
        ctx.save_for_backward(hidden, w_vocab, targets, valid, lse, denom)
        return _masked_mean(nll, valid, denom)

    @staticmethod
    @obs.spanned("loss.ce_bwd")
    def backward(ctx, g):
        hidden, w_vocab, targets, valid, lse, denom = ctx.saved_tensors
        ce_dtype = ctx.ce_dtype
        T, D = hidden.shape
        V = w_vocab.shape[0]
        bv = min(ctx.block_v, V)
        if denom is not None:
            coef = ((g / denom).expand(T) if valid is None
                    else g * valid / denom)[:, None]
        elif valid is not None:
            coef = (g * valid / torch.clamp(valid.sum(), min=1.0))[:, None]
        else:
            coef = (g / T).expand(T)[:, None]
        hf = hidden.to(ce_dtype).float()
        dh = torch.zeros((T, D), dtype=torch.float32, device=hidden.device)
        dw = torch.empty_like(w_vocab)
        for v0 in range(0, V, bv):
            wb = w_vocab[v0:v0 + bv].to(ce_dtype).float()
            n = wb.shape[0]
            probs = torch.exp(hf @ wb.t() - lse[:, None])  # (T, n) f32
            idx = targets.long()[:, None] - v0
            hit = (idx >= 0) & (idx < n)  # the target lies in this block
            probs.scatter_add_(1, idx.clamp(0, n - 1), -hit.float())
            dlogits = (coef * probs).to(ce_dtype).float()
            dh += dlogits @ wb
            dw[v0:v0 + n] = (dlogits.t() @ hf).to(w_vocab.dtype)
        return (dh.to(hidden.dtype), dw, None, None, None, None, None, None,
                None)


def _vocab_shard(w_vocab: torch.Tensor, cfg: ModelConfig):
    """The first id of this rank's vocab rows where the head is split over
    ``model``, else None."""
    if S.model_ranks() > 1 and w_vocab.shape[0] != cfg.vocab_size:
        return S.model_block(cfg.vocab_size)[0]
    return None


def ce_blockwise(hidden: torch.Tensor, w_vocab: torch.Tensor,
                 targets: torch.Tensor, valid: Optional[torch.Tensor],
                 block_v: int = 8192, ce_dtype: torch.dtype = torch.bfloat16,
                 *, use_kernels: Optional[bool] = None,
                 denom: Optional[torch.Tensor] = None,
                 v0: Optional[int] = None) -> torch.Tensor:
    """Mean NLL over valid positions.  hidden: (T, D); w_vocab: (V, D),
    or a vocab shard's rows from id ``v0`` (the statistics merged over
    ``model``).  The logits come from ``ce_dtype`` inputs with f32
    accumulation.  ``denom``: see :func:`_masked_mean`."""
    kernel = ops._kernel_path(hidden, use_kernels)
    return CEBlockwiseFn.apply(hidden, w_vocab, targets, valid, block_v,
                               ce_dtype, kernel, denom, v0)


def ce_direct(hidden: torch.Tensor, w_vocab: torch.Tensor,
              targets: torch.Tensor, valid: Optional[torch.Tensor],
              denom: Optional[torch.Tensor] = None,
              v0: Optional[int] = None) -> torch.Tensor:
    """Mean NLL from the whole f32 (T, V) logits, differentiated by
    autograd (small vocab / smoke); on a vocab shard from id ``v0``, from
    its (T, V_shard) logits, the max, sum of exps and target logit
    combined over ``model``."""
    logits = hidden.float() @ w_vocab.float().t()
    m = logits.amax(dim=-1, keepdim=True).detach()
    if v0 is not None:
        r = S.current_rules()
        m = r.all_gather(m[None], 0, ("model",)).amax(dim=0)
    se = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    idx = targets[:, None].long() - (v0 or 0)
    hit = (idx >= 0) & (idx < logits.shape[1])
    tgt = torch.where(hit, logits.gather(
        1, idx.clamp(0, logits.shape[1] - 1)), 0.0)[:, 0]
    if v0 is not None:
        se, tgt = S.leave_model(se), S.leave_model(tgt)
    lse = (m + torch.log(se))[:, 0]
    return _masked_mean(lse - tgt, valid, denom)


def _split_count(valid: Optional[torch.Tensor], n: int,
                 device: torch.device) -> Optional[torch.Tensor]:
    """Under a batch split over ranks, the global count of valid positions
    (clamped to 1), summed over the split's axes; None otherwise."""
    r, split = S.current_rules(), S.current_split()
    if r is None or split is None or not r._live(split[1]):
        return None
    count = (valid.detach().sum() if valid is not None
             else torch.tensor(float(n), device=device))
    return torch.clamp(r.all_reduce(count, split[1]), min=1.0)


def lm_loss(params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token LM loss: (loss, {"loss", "tokens"}); a VLM's over its
    text positions only.  Under a batch split over ranks the returned loss
    is this rank's share (its sum over the global count of valid
    positions: the ranks' gradients add up to the global mean's), and
    the aux ``loss`` and ``tokens`` are the global ones."""
    params = registry.gather_top(params, cfg)
    x = registry.forward(params, cfg, run, batch)  # (B, S_total, d)
    if cfg.family == "vlm":
        x = x[:, cfg.num_img_patches:]
    B, S_, D = x.shape
    x = S.constrain(x, "batch", None, None)
    hidden = x.reshape(B * S_, D)
    targets = batch["labels"].reshape(B * S_)
    valid = batch.get("loss_mask")
    valid = valid.reshape(B * S_) if valid is not None else None
    w = L.lm_head_weight(params["embed"], cfg)
    denom = _split_count(valid, B * S_, x.device)
    v0 = _vocab_shard(w, cfg)
    if v0 is not None:
        hidden = S.enter_model(hidden)
    if run.ce_mode == "blockwise":
        loss = ce_blockwise(hidden, w, targets, valid, run.ce_block_v,
                            getattr(torch, run.ce_dtype),
                            use_kernels=run.use_kernels, denom=denom, v0=v0)
    else:
        loss = ce_direct(hidden, w, targets, valid, denom, v0)
    if denom is not None:
        axes = S.current_split()[1]
        return loss, {"loss": S.current_rules().all_reduce(
            loss.detach().clone(), axes), "tokens": denom}
    ntok = (valid.sum() if valid is not None
            else torch.tensor(float(B * S_), device=x.device))
    return loss, {"loss": loss, "tokens": ntok}
