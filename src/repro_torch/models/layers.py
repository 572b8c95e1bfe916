"""Layers of the decoder, ported from ``repro/models/layers.py``.

What the dense and MoE serving paths run: norms, RoPE, GQA attention
(full or sliding window) with a bf16 or int8 KV cache, the MLP, the
top-k MoE block, the embedding and the LM head.  Params are nested dicts
of tensors in the JAX layout; every forward function takes ``(p, cfg,
run, ...)`` with ``p`` the param subtree.  The large projections and the
expert products stay plain ``@`` / ``bmm`` (cuBLAS), as the JAX package
leaves them to XLA outside any kernel; so do the int8 (de)quantisation
and the MoE routing, which it computes in jnp.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, attention_mask
from repro_torch.models.params import pdef

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------


def norm_defs(L: int, d: int):
    return pdef((L, d) if L else (d,), init="ones")


def attention_defs(cfg: ModelConfig, L: int) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    lead = (L,) if L else ()
    out: Params = {
        "wq": pdef(lead + (d, qd), init="scaled"),
        "wk": pdef(lead + (d, kvd), init="scaled"),
        "wv": pdef(lead + (d, kvd), init="scaled"),
        "wo": pdef(lead + (qd, d), init="scaled"),
    }
    if cfg.qkv_bias:
        out["bq"] = pdef(lead + (qd,), init="zeros")
        out["bk"] = pdef(lead + (kvd,), init="zeros")
        out["bv"] = pdef(lead + (kvd,), init="zeros")
    return out


def mlp_defs(cfg: ModelConfig, L: int) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    lead = (L,) if L else ()
    out: Params = {
        "w_up": pdef(lead + (d, f), init="scaled"),
        "w_down": pdef(lead + (f, d), init="scaled"),
    }
    if cfg.gated_mlp:
        out["w_gate"] = pdef(lead + (d, f), init="scaled")
    if cfg.mlp_bias:
        out["b_up"] = pdef(lead + (f,), init="zeros")
        out["b_down"] = pdef(lead + (d,), init="zeros")
    return out


def moe_defs(cfg: ModelConfig, L: int) -> Params:
    """The router is f32, as in the JAX defs; the experts are stacked on
    an E axis: ``w_gate``/``w_up`` (L, E, d, f), ``w_down`` (L, E, f, d)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": pdef((L, d, E), init="scaled", dtype=torch.float32),
        "w_gate": pdef((L, E, d, f), init="scaled"),
        "w_up": pdef((L, E, d, f), init="scaled"),
        "w_down": pdef((L, E, f, d), init="scaled"),
    }


def embed_defs(cfg: ModelConfig) -> Params:
    out = {"tok": pdef((cfg.vocab_size, cfg.d_model))}
    if not cfg.tie_embeddings:
        out["lm_head"] = pdef((cfg.vocab_size, cfg.d_model), init="scaled")
    return out


# ---------------------------------------------------------------------------
# Norm / activations / RoPE
# ---------------------------------------------------------------------------


def rmsnorm(p: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
            run: RunConfig) -> torch.Tensor:
    return ops.rmsnorm(x, p, eps=cfg.norm_eps, use_kernels=run.use_kernels)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    if name == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,).  Rotation in f32, cast back."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[:, None] * freqs  # (S, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache (bf16 or int8-quantised)
# ---------------------------------------------------------------------------


def kv_cache_defs(cfg: ModelConfig, L: int, batch: int,
                  max_len: int) -> Params:
    """One stack of per-layer KV caches: bf16 K/V, or int8 K/V with an f32
    scale per (token, head)."""
    shp = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": pdef(shp, init="zeros", dtype=torch.int8),
                "v": pdef(shp, init="zeros", dtype=torch.int8),
                "k_scale": pdef(shp[:-1], init="zeros", dtype=torch.float32),
                "v_scale": pdef(shp[:-1], init="zeros", dtype=torch.float32)}
    if cfg.kv_cache_dtype != "bfloat16":
        raise NotImplementedError(
            f"kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported")
    return {"k": pdef(shp, init="zeros", dtype=torch.bfloat16),
            "v": pdef(shp, init="zeros", dtype=torch.bfloat16)}


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation per (token, head): x (..., Dh) ->
    (int8 (..., Dh), f32 scale (...)); ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 K/V and their scales back to bf16, as the JAX package reads
    them whatever the model's dtype."""
    return (q.float() * scale[..., None]).to(torch.bfloat16)


def cache_update(cache: Params, k: torch.Tensor, v: torch.Tensor,
                 pos: int) -> Params:
    """Writes new K/V (B, S_new, Hkv, Dh) into a one-layer cache at
    ``pos``, quantised first if the cache holds int8 (it then has
    ``k_scale`` and ``v_scale``).  Unlike the JAX version this writes IN
    PLACE: the layer's cache is a view into the stacked cache, so the
    stack is updated too and no copy of the cache is made."""
    S = k.shape[1]
    for name, x in (("k", k), ("v", v)):
        if name + "_scale" in cache:
            x, cache[name + "_scale"][:, pos:pos + S] = quantize_kv(x)
        cache[name][:, pos:pos + S] = x.to(cache[name].dtype)
    return cache


def cache_read(cache: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole cache's K and V; an int8 cache dequantised to bf16, as
    the JAX package reads it (prefill too attends over the rounded K/V)."""
    if "k_scale" in cache:
        return (dequantize_kv(cache["k"], cache["k_scale"]),
                dequantize_kv(cache["v"], cache["v_scale"]))
    return cache["k"], cache["v"]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attention_kvseq(q, k, v, *, causal: bool, q_offset: int,
                     kv_len: Optional[int], sliding_window: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention (one query chunk over the whole cache), plain
    torch: the JAX package has no kernel for this path either."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // max(Hkv, 1)
    scale = scale if scale is not None else Dh ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float())
    mask = attention_mask(
        q_offset + torch.arange(Sq, device=q.device),
        torch.arange(Sk, device=q.device),
        valid_len=Sk if kv_len is None else kv_len, causal=causal,
        sliding_window=sliding_window)
    s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, Dh).to(q.dtype)


def attention(p: Params, cfg: ModelConfig, run: RunConfig, x: torch.Tensor,
              *, pos: int, causal: bool = True,
              cache: Optional[Params] = None,
              kv_len: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA self-attention with an optional one-layer KV cache.

    x: (B, S, d_model) at absolute positions ``pos .. pos + S - 1``; with a
    cache, the new K/V are written at ``pos`` and attention reads the
    whole cache with ``kv_len`` valid entries.  Returns (out, cache).
    """
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = pos + torch.arange(S, device=x.device)

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(B, S, Hq, Dh), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, Hkv, Dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, Dh)
    if cache is not None:
        cache = cache_update(cache, k, v, pos)
        k, v = cache_read(cache)
    k, v = k.to(q.dtype), v.to(q.dtype)

    if S == 1:
        out = _attention_kvseq(q, k, v, causal=causal, q_offset=pos,
                               kv_len=kv_len,
                               sliding_window=cfg.sliding_window)
    else:
        # GQA inside the kernel: K/V keep Hkv heads (the JAX path repeats
        # them to Hq first; the result is the same).
        out = ops.flash_attention(
            q, k, v, causal=causal, q_offset=pos, kv_len=kv_len,
            sliding_window=cfg.sliding_window, block_k=run.attn_block_k,
            use_kernels=run.use_kernels)
    return out.reshape(B, S, Hq * Dh) @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLP / MoE / embedding / LM head
# ---------------------------------------------------------------------------


def mlp(p: Params, cfg: ModelConfig, run: RunConfig,
        x: torch.Tensor) -> torch.Tensor:
    a = act_fn(cfg.act)
    up = x @ p["w_up"]
    if "b_up" in p:
        up = up + p["b_up"]
    h = a(x @ p["w_gate"]) * up if "w_gate" in p else a(up)
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return y


class MoERoute(NamedTuple):
    """A batch's routing: each token's K (expert, weight) pairs, ordered
    by expert id, and where each pair goes; pairs past an expert's
    capacity ``C`` in its row are dropped (``keep`` False)."""
    experts: torch.Tensor  # (B, S, K) int64, ascending along K
    weights: torch.Tensor  # (B, S, K) f32, renormalised top-k gates
    slot: torch.Tensor  # (B, S, K) row of the (E, B, C) slot grid
    keep: torch.Tensor  # (B, S, K) bool
    capacity: int


def moe_route(p: Params, cfg: ModelConfig, x: torch.Tensor) -> MoERoute:
    """The routing of ``_moe_block_gspmd``: f32 router logits, softmax,
    top-K (ties to the lower expert, as ``lax.top_k``), the weights
    renormalised; then in each batch row a stable sort of the (token, k)
    pairs by expert gives a pair its rank in its expert, and ranks >= C =
    ceil(S K / E * capacity_factor) drop (the row's latest tokens first).
    """
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = max(int(math.ceil(S * K / E * cfg.moe_capacity_factor)), 1)
    gates = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :K], top_e[..., :K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # a token's pairs by expert: the order in which JAX's scatter-add
    # combines them (its stable sort puts a row's pairs in expert order)
    top_e, perm = torch.sort(top_e, dim=-1)
    top_w = top_w.gather(-1, perm)

    flat_e = top_e.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    first = torch.searchsorted(
        se, torch.arange(E, device=x.device).expand(B, E).contiguous())
    rank = torch.arange(S * K, device=x.device) - first.gather(1, se)
    b = torch.arange(B, device=x.device)[:, None]
    # rank and slot back in (token, k) order
    pos = torch.empty_like(rank).scatter_(1, order, rank)
    pos = pos.reshape(B, S, K)
    slot = (top_e * B + b[..., None]) * C + pos
    return MoERoute(top_e, top_w, slot, pos < C, C)


def moe_block(p: Params, cfg: ModelConfig, run: RunConfig,
              x: torch.Tensor) -> torch.Tensor:
    """Top-K MoE with the semantics of ``_moe_block_gspmd`` (one card, no
    mesh).  Kept pairs are copied into an (E, B, C, d) grid; each expert
    runs its gated MLP on its B*C slots in one ``bmm``; a token's kept
    outputs, each times its weight (both in the output dtype), are summed
    in expert order, one rounding a step, as JAX's scatter-add does.  No
    atomics: a row's bits do not vary from run to run."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    a = act_fn(cfg.act)
    r = moe_route(p, cfg, x)
    n_slots = E * B * r.capacity
    # dropped pairs are written to one spare row past the grid
    dest = torch.where(r.keep, r.slot, n_slots).reshape(-1)
    xe = x.new_zeros((n_slots + 1, d))
    xe[dest] = x[:, :, None].expand(B, S, K, d).reshape(-1, d)
    xe = xe[:n_slots].view(E, B * r.capacity, d)
    h = a(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).view(n_slots, d)
    # a dropped pair reads slot 0 at weight 0, as JAX's clipped slot does
    w = torch.where(r.keep, r.weights, 0.0).to(ye.dtype)
    contrib = ye[torch.where(r.keep, r.slot, 0)] * w[..., None]
    y = contrib[:, :, 0]
    for k in range(1, K):
        y = y + contrib[:, :, k]
    return y.to(x.dtype)


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_head_weight(p: Params, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"] if cfg.tie_embeddings else p["lm_head"]


def logits_out(p: Params, cfg: ModelConfig, run: RunConfig,
               x: torch.Tensor) -> torch.Tensor:
    y = x @ lm_head_weight(p, cfg).t()
    return y.float() if run.logits_in_fp32 else y
