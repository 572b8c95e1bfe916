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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import cross_entropy as _kce
from repro_torch.kernels import meter
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import registry


def _masked_mean(nll: torch.Tensor,
                 valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is not None:
        return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return nll.mean()


class CEBlockwiseFn(torch.autograd.Function):
    """Mean NLL with the custom backward of ``repro/train/loss.py::
    _ce_bwd``.  ``kernel`` selects the CE kernel for the forward
    statistics, else the plain version."""

    @staticmethod
    def forward(ctx, hidden, w_vocab, targets, valid, block_v: int,
                ce_dtype: torch.dtype, kernel: bool):
        hc, wc = hidden.to(ce_dtype), w_vocab.to(ce_dtype)
        if kernel:
            hc, wc = hc.contiguous(), wc.contiguous()
        with meter.charge("cross_entropy", lambda: _kce.work(hc, wc)):
            if kernel:
                nll, lse = _kce.cross_entropy_cuda(hc, wc, targets)
            else:
                nll, lse = ref.cross_entropy_stats_ref(hc, wc, targets,
                                                       block_v=block_v)
        ctx.block_v, ctx.ce_dtype = block_v, ce_dtype
        ctx.save_for_backward(hidden, w_vocab, targets, valid, lse)
        return _masked_mean(nll, valid)

    @staticmethod
    def backward(ctx, g):
        hidden, w_vocab, targets, valid, lse = ctx.saved_tensors
        ce_dtype = ctx.ce_dtype
        T, D = hidden.shape
        V = w_vocab.shape[0]
        bv = min(ctx.block_v, V)
        if valid is not None:
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
        return dh.to(hidden.dtype), dw, None, None, None, None, None


def ce_blockwise(hidden: torch.Tensor, w_vocab: torch.Tensor,
                 targets: torch.Tensor, valid: Optional[torch.Tensor],
                 block_v: int = 8192, ce_dtype: torch.dtype = torch.bfloat16,
                 *, use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Mean NLL over valid positions.  hidden: (T, D); w_vocab: (V, D).
    The logits come from ``ce_dtype`` inputs with f32 accumulation."""
    kernel = ops._kernel_path(hidden, use_kernels)
    return CEBlockwiseFn.apply(hidden, w_vocab, targets, valid, block_v,
                               ce_dtype, kernel)


def ce_direct(hidden: torch.Tensor, w_vocab: torch.Tensor,
              targets: torch.Tensor,
              valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean NLL from the whole f32 (T, V) logits, differentiated by
    autograd (small vocab / smoke)."""
    logits = hidden.float() @ w_vocab.float().t()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = (m + torch.log(torch.exp(logits - m).sum(dim=-1,
                                                    keepdim=True)))[:, 0]
    tgt = logits.gather(1, targets[:, None].long())[:, 0]
    return _masked_mean(lse - tgt, valid)


def lm_loss(params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token LM loss: (loss, {"loss", "tokens"}); a VLM's over its
    text positions only."""
    x = registry.forward(params, cfg, run, batch)  # (B, S_total, d)
    if cfg.family == "vlm":
        x = x[:, cfg.num_img_patches:]
    B, S, D = x.shape
    hidden = x.reshape(B * S, D)
    targets = batch["labels"].reshape(B * S)
    valid = batch.get("loss_mask")
    valid = valid.reshape(B * S) if valid is not None else None
    w = L.lm_head_weight(params["embed"], cfg)
    if run.ce_mode == "blockwise":
        loss = ce_blockwise(hidden, w, targets, valid, run.ce_block_v,
                            getattr(torch, run.ce_dtype),
                            use_kernels=run.use_kernels)
    else:
        loss = ce_direct(hidden, w, targets, valid)
    ntok = (valid.sum() if valid is not None
            else torch.tensor(float(B * S), device=x.device))
    return loss, {"loss": loss, "tokens": ntok}
