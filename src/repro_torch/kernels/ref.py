"""Plain PyTorch versions of the ported kernels (forward only).

They follow ``repro/kernels/ref.py`` op for op and are the oracles the
hand-written CUDA kernels are held against: nothing here calls
``F.scaled_dot_product_attention`` or any other fused library operator.
On a CPU tensor the kernel wrappers run these.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Row RMSNorm over the last axis: f32 math, output in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype)


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   valid_len: int, causal: bool,
                   sliding_window: int) -> torch.Tensor:
    """(Sq, Sk) boolean mask from positions: key valid (< valid_len),
    causal, sliding window — as the references build it."""
    mask = (k_pos[None, :] < valid_len).expand(q_pos.shape[0], -1)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if sliding_window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - sliding_window)
    return mask


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    sliding_window: int = 0,
    block_k: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked online-softmax attention with GQA (q head h reads kv head
    h // G).  A row whose every key is masked comes out as the plain mean
    over V, zero padding included, because exp(NEG_INF - NEG_INF) = 1."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % max(Hkv, 1):
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    block_k = min(block_k, max(Sk, 1))
    pad = (-Sk) % block_k
    kf, vf = k.float(), v.float()
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
    n_blocks = kf.shape[1] // block_k

    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    valid_len = Sk if kv_len is None else kv_len

    m = torch.full((B, Sq, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, D), device=q.device)
    for j in range(n_blocks):
        kb = kf[:, j * block_k:(j + 1) * block_k]
        vb = vf[:, j * block_k:(j + 1) * block_k]
        k_pos = j * block_k + torch.arange(block_k, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        mask = attention_mask(q_pos, k_pos, valid_len=valid_len,
                              causal=causal, sliding_window=sliding_window)
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd",
                                                     p, vb)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).reshape(B, Sq, Hq, D)
    return out.to(q.dtype)


def attention_naive(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None, sliding_window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """O(Sq*Sk) direct attention — oracle for the oracle (small shapes)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float())
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = attention_mask(q_pos, k_pos,
                          valid_len=Sk if kv_len is None else kv_len,
                          causal=causal, sliding_window=sliding_window)
    s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
