"""Plain float32 building blocks of the benchmark's references.

Everything here is plain PyTorch on float32 tensors, with TF32 off
(``strict_f32``), and imports nothing of the program under test.  Each
matrix product goes through :func:`mm`, which in ``"fp8"`` mode rounds
both operands to float8 (e4m3 forward, e5m2 for the gradients, one
scale a tensor, as fp8 training and serving recipes scale them) before an
f32 product: the control of ``correct``, the same model one precision
below the bfloat16 that the configurations state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

NEG_INF = -1e30
F8_FWD, F8_BWD = torch.float8_e4m3fn, torch.float8_e5m2
PRECISIONS = ("f32", "fp8")  # the modes of ``mm``; a family may add faults


def strict_f32() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclass(frozen=True)
class Leaf:
    """One stored weight: shape, dtype, and how the benchmark draws it
    (``normal`` times ``scale``, ``ones``, ``zeros``, ``ssm_a``: log of
    U[1, 16], ``ssm_dt``: inverse softplus of U[1e-3, 1e-1])."""
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"
    scale: float = 0.02


def fan_in(n: int) -> float:
    return 1.0 / math.sqrt(n)


def _q8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (a float8) under one scale that maps its
    largest magnitude to the format's largest, back in f32."""
    s = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / s).to(dtype).to(torch.float32) * s


class _MM8(torch.autograd.Function):
    """a @ b with both operands in e4m3 and the incoming gradient in e5m2
    (the products themselves accumulate in f32)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a, F8_FWD), _q8(b, F8_FWD)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        gq = _q8(g, F8_BWD)
        return gq @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ gq


def mm(a: torch.Tensor, b: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    """The reference's matrix product: f32, or the fp8 control.  A 2-D
    ``b`` takes ``a``'s leading dims as rows."""
    if mode == "f32":
        return a @ b
    if mode != "fp8":
        raise ValueError(f"unknown precision {mode!r}")
    if b.dim() == 2 and a.dim() > 2:
        return _MM8.apply(a.reshape(-1, a.shape[-1]), b).reshape(
            *a.shape[:-1], b.shape[-1])
    return _MM8.apply(a, b)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D) rotated by halves (the NeoX layout)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACTS = {"silu": silu, "gelu": gelu_tanh}


def _attend_block(qb: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q0: int, mode: str) -> torch.Tensor:
    """Causal softmax attention of query rows q0 .. (B, Hkv, G, n, D)
    over keys (B, Hkv, Sk, D)."""
    B, Hkv, G, n, D = qb.shape
    Sk = k.shape[2]
    s = mm(qb.reshape(B, Hkv, G * n, D), k.transpose(-1, -2), mode)
    s = s.reshape(B, Hkv, G, n, Sk) * (D ** -0.5)
    qpos = q0 + torch.arange(n, device=qb.device)
    mask = torch.arange(Sk, device=qb.device)[None, :] <= qpos[:, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return mm(p.reshape(B, Hkv, G * n, Sk), v, mode).reshape(B, Hkv, G, n, D)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mode: str = "f32", block: int = 1024) -> torch.Tensor:
    """Causal GQA attention: q (B, S, Hq, D), k / v (B, S, Hkv, D), query
    head h reading kv head h // (Hq / Hkv).  Query rows go in blocks,
    each recomputed in the backward, so one block's scores live at once."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qh = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    outs = []
    for q0 in range(0, S, block):
        qb = qh[:, :, :, q0:q0 + block]
        kb, vb = kh[:, :, :q0 + qb.shape[3]], vh[:, :, :q0 + qb.shape[3]]
        if torch.is_grad_enabled():
            o = torch.utils.checkpoint.checkpoint(
                _attend_block, qb, kb, vb, q0, mode, use_reentrant=False)
        else:
            o = _attend_block(qb, kb, vb, q0, mode)
        outs.append(o)
    o = torch.cat(outs, dim=3)  # (B, Hkv, G, S, D)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq * D)


def nll(h: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor,
        mode: str = "f32", block: int = 8192) -> torch.Tensor:
    """Per-token negative log-likelihood (T,) of ``labels`` under logits
    ``h @ w_headᵀ``, token blocks recomputed in the backward."""
    def one(hb, lb):
        logits = mm(hb, w_head.t(), mode)
        return torch.logsumexp(logits, dim=-1) - logits.gather(
            1, lb[:, None].long())[:, 0]
    out = []
    for t0 in range(0, h.shape[0], block):
        hb, lb = h[t0:t0 + block], labels[t0:t0 + block]
        out.append(torch.utils.checkpoint.checkpoint(
            one, hb, lb, use_reentrant=False)
            if torch.is_grad_enabled() else one(hb, lb))
    return torch.cat(out)


def cosine_lr(step: int, *, base_lr: float, warmup_steps: int,
              total_steps: int, min_ratio: float = 0.1) -> float:
    """Linear warm-up, then cosine decay to ``min_ratio`` of the base."""
    s = float(step)
    warm = min(s / max(warmup_steps, 1), 1.0)
    prog = min(max((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                   0.0), 1.0)
    return base_lr * warm * (min_ratio + (1.0 - min_ratio) * 0.5
                             * (1.0 + math.cos(math.pi * prog)))


def adamw_slice(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, *, step: int, lr: float, decay: bool,
                wd: float, b1: float = 0.9, b2: float = 0.95,
                eps: float = 1e-8) -> None:
    """One AdamW step of a stored slice ``p`` (in its own dtype) from its
    f32 gradient ``g``, IN PLACE; ``m``, ``v`` f32.  The update runs in
    f32 and is rounded once to ``p``'s dtype."""
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    delta = (m / (1.0 - b1 ** step)) / (
        torch.sqrt(v / (1.0 - b2 ** step)) + eps)
    pf = p.float()
    if decay:
        pf = pf - lr * wd * pf
    p.copy_(pf - lr * delta)


Tree = Dict[str, object]


def tree_from_paths(flat: Dict[Tuple[str, ...], object]) -> Tree:
    out: Tree = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def flatten(tree, prefix: Tuple[str, ...] = ()
            ) -> Dict[Tuple[str, ...], object]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, prefix + (k,)))
    return out


def get(tree: Tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def unit_weights(params: Tree, leaves, requires_grad: bool = False
                 ) -> Dict[Tuple[str, ...], torch.Tensor]:
    """f32 copies of a unit's weights: ``leaves`` lists (path, layer
    index or None)."""
    out = {}
    for path, i in leaves:
        t = get(params, path)
        t = (t if i is None else t[i]).float().clone()
        out[path] = t.requires_grad_(requires_grad)
    return out
