"""Layers of the model zoo, ported from ``repro/models/layers.py``.

Norms, RoPE and sinusoidal positions, GQA attention (causal or not, full
or sliding window; self- or cross-attention) with a bf16 or int8 KV
cache, the MLP, the top-k MoE block, the embedding and the LM head.
Params are nested dicts of tensors in the JAX layout; every forward
function takes ``(p, cfg, run, ...)`` with ``p`` the param subtree.  The
large projections and the expert products stay plain ``@`` / ``bmm``
(cuBLAS), as the JAX package leaves them to XLA outside any kernel; so
do the int8 (de)quantisation and the MoE routing, which it computes in
jnp.

Under sharding rules whose ``model`` axis has more than one rank, ``p``
holds this rank's ``model`` block of each weight (``keep=("model",)``)
and each rank computes its block, as GSPMD splits the JAX specs:
attention its heads (or, where the heads do not divide ``model``, its
query rows: ``"q_seq"``), the MLP its ``ffn`` columns, the embedding and
the LM head their vocab rows, the MoE block (prefill and decode) its
experts or its ``ffn`` slice of every expert; a split region starts at
``sharding.enter_model`` and its partial outputs are summed by
``sharding.leave_model`` (``sharding/rules.py``).  The KV cache holds
this rank's block of its spec (``"kv_seq"``, else ``"heads"``, else
whole); decode over a ``kv_seq`` block runs flash-decoding: each rank's
partial softmax over its positions, combined across ``model``.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import obs
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, attention_mask
from repro_torch.models import params as P
from repro_torch.models.params import pdef
from repro_torch.sharding import rules as SR

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------


def norm_defs(L: int, d: int):
    return pdef((L, d) if L else (d,),
                ("layers", None) if L else (None,), init="ones")


def attention_defs(cfg: ModelConfig, L: int) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    lead = (L,) if L else ()
    ll = ("layers",) if L else ()
    out: Params = {
        "wq": pdef(lead + (d, qd), ll + ("embed", "qkv"), init="scaled"),
        "wk": pdef(lead + (d, kvd), ll + ("embed", "qkv"), init="scaled"),
        "wv": pdef(lead + (d, kvd), ll + ("embed", "qkv"), init="scaled"),
        "wo": pdef(lead + (qd, d), ll + ("qkv", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        out["bq"] = pdef(lead + (qd,), ll + ("qkv",), init="zeros")
        out["bk"] = pdef(lead + (kvd,), ll + ("qkv",), init="zeros")
        out["bv"] = pdef(lead + (kvd,), ll + ("qkv",), init="zeros")
    return out


def mlp_defs(cfg: ModelConfig, L: int) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    lead = (L,) if L else ()
    ll = ("layers",) if L else ()
    out: Params = {
        "w_up": pdef(lead + (d, f), ll + ("embed", "ffn"), init="scaled"),
        "w_down": pdef(lead + (f, d), ll + ("ffn", "embed"), init="scaled"),
    }
    if cfg.gated_mlp:
        out["w_gate"] = pdef(lead + (d, f), ll + ("embed", "ffn"),
                             init="scaled")
    if cfg.mlp_bias:
        out["b_up"] = pdef(lead + (f,), ll + ("ffn",), init="zeros")
        out["b_down"] = pdef(lead + (d,), ll + (None,), init="zeros")
    return out


def moe_defs(cfg: ModelConfig, L: int) -> Params:
    """The router is f32, as in the JAX defs; the experts are stacked on
    an E axis: ``w_gate``/``w_up`` (L, E, d, f), ``w_down`` (L, E, f, d).
    Expert weights carry BOTH "expert" and "ffn" tags; the rules shard on
    whichever divides: qwen3-moe (128e) on the expert dim, mixtral (8e <
    16) on the per-expert ffn dim.  With ``shared_expert_d_ff`` a shared
    expert, an MLP of that width that every token takes, under
    ``"shared"``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    out: Params = {
        "router": pdef((L, d, E), ("layers", "embed", None),
                       init="scaled", dtype=torch.float32),
        "w_gate": pdef((L, E, d, f), ("layers", "expert", "embed", "ffn"),
                       init="scaled"),
        "w_up": pdef((L, E, d, f), ("layers", "expert", "embed", "ffn"),
                     init="scaled"),
        "w_down": pdef((L, E, f, d), ("layers", "expert", "ffn", "embed"),
                       init="scaled"),
    }
    if cfg.shared_expert_d_ff:
        out["shared"] = mlp_defs(shared_expert_cfg(cfg), L)
    return out


def shared_expert_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config the shared expert runs as an MLP under: its width."""
    return cfg.replace(d_ff=cfg.shared_expert_d_ff, mlp_bias=False)


def embed_defs(cfg: ModelConfig) -> Params:
    out = {"tok": pdef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["lm_head"] = pdef((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed"), init="scaled")
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


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions: (S,).  Returns the (S, d) f32 table [sin | cos] of
    ``repro/models/layers.py::sinusoidal_positions``; the caller casts it
    to the activations' dtype before adding it."""
    pos = positions.float()[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=positions.device),
                          2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# KV cache (bf16 or int8-quantised)
# ---------------------------------------------------------------------------


def kv_cache_defs(cfg: ModelConfig, L: int, batch: int,
                  max_len: int) -> Params:
    """One stack of per-layer KV caches: bf16 K/V, or int8 K/V with an f32
    scale per (token, head)."""
    shp = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    lg = ("layers", "batch", "kv_seq", "heads", None)
    if cfg.kv_cache_dtype == "int8":
        return {"k": pdef(shp, lg, init="zeros", dtype=torch.int8),
                "v": pdef(shp, lg, init="zeros", dtype=torch.int8),
                "k_scale": pdef(shp[:-1], lg[:-1], init="zeros",
                                dtype=torch.float32),
                "v_scale": pdef(shp[:-1], lg[:-1], init="zeros",
                                dtype=torch.float32)}
    if cfg.kv_cache_dtype != "bfloat16":
        raise NotImplementedError(
            f"kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported")
    return {"k": pdef(shp, lg, init="zeros", dtype=torch.bfloat16),
            "v": pdef(shp, lg, init="zeros", dtype=torch.bfloat16)}


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


# the storage of a KV stack split over "kv_seq" -> (first, count) of the
# positions it holds; an entry lives as long as its stack
_KV_BLOCKS: Dict[int, Tuple[int, int]] = {}


def _storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage, which its views share (not its
    address: every meta storage's is 0)."""
    return t.untyped_storage()._cdata


def mark_kv_positions(stack: torch.Tensor, first: int, count: int) -> None:
    """Records that ``stack`` (a KV leaf, or the stack of them) holds the
    global positions ``first .. first + count - 1``: this rank's block of
    a cache split over ``"kv_seq"``.  Its views (a layer's cache) share
    the record, in inference mode too, where views keep no ``_base``."""
    key = _storage_key(stack)
    _KV_BLOCKS[key] = (first, count)
    weakref.finalize(stack, _KV_BLOCKS.pop, key, None)


def kv_positions(cache: Params) -> Optional[Tuple[int, int]]:
    """(first, count) of the global positions this rank's block of a
    one-layer cache holds, where the cache is split over ``"kv_seq"``
    (``mark_kv_positions``); None where it holds every position."""
    return _KV_BLOCKS.get(_storage_key(cache["k"]))


def _as_cached(cache: Params, x: torch.Tensor) -> torch.Tensor:
    """``x`` as ``cache_read`` returns it once written: rounded to the
    cache's bf16, or int8-quantised and dequantised."""
    if "k_scale" in cache:
        return dequantize_kv(*quantize_kv(x))
    return x.to(cache["k"].dtype)


def _cache_write(cache: Params, k: torch.Tensor, v: torch.Tensor,
                 start: int) -> None:
    """Writes the rows of K/V (B, n, Hc, Dh) at global positions ``start
    .. start + n - 1`` that this rank's block holds (all of them where the
    cache is not split over ``"kv_seq"``)."""
    first, count = kv_positions(cache) or (0, cache["k"].shape[1])
    lo, hi = max(start, first), min(start + k.shape[1], first + count)
    if lo < hi:
        cache_update(cache, k[:, lo - start:hi - start],
                     v[:, lo - start:hi - start], lo - first)


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


@obs.spanned("attention")
def attention(p: Params, cfg: ModelConfig, run: RunConfig, x: torch.Tensor,
              *, pos: int, causal: bool = True,
              cache: Optional[Params] = None,
              kv_len: Optional[int] = None,
              xkv: Optional[torch.Tensor] = None,
              cache_read_only: bool = False, use_rope: bool = True,
              scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention with an optional one-layer KV cache.

    x: (B, S, d_model) at absolute positions ``pos .. pos + S - 1``.  Self-
    attention (``xkv`` None): with a cache, the new K/V are written at
    ``pos`` and attention reads the whole cache with ``kv_len`` valid
    entries.  Cross-attention: K and V come from ``xkv`` (the encoder's
    output), with no RoPE, and a cache is filled from row 0; with
    ``cache_read_only`` (decode) the cache is read as it stands and
    nothing is written.  ``use_rope`` False leaves q and k unrotated;
    ``scale`` is the softmax scale (None: ``head_dim ** -0.5``; one model
    rank only).  Returns (out, cache).
    """
    if SR.model_ranks() > 1:
        if scale is not None:
            raise NotImplementedError("a softmax scale under a model split")
        return _attention_split(p, cfg, run, x, pos=pos, causal=causal,
                                cache=cache, kv_len=kv_len, xkv=xkv,
                                cache_read_only=cache_read_only,
                                use_rope=use_rope)
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = pos + torch.arange(S, device=x.device)

    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, Hq, Dh)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
    if cache_read_only:
        k, v = cache_read(cache)
    else:
        src = x if xkv is None else xkv
        k = src @ p["wk"]
        v = src @ p["wv"]
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        k = k.reshape(B, -1, Hkv, Dh)
        v = v.reshape(B, -1, Hkv, Dh)
        if use_rope and xkv is None:
            k = rope(k, positions, cfg.rope_theta)
        if cache is not None:
            cache = cache_update(cache, k, v, pos if xkv is None else 0)
            k, v = cache_read(cache)
    k, v = k.to(q.dtype), v.to(q.dtype)

    if S == 1:
        out = _attention_kvseq(q, k, v, causal=causal, q_offset=pos,
                               kv_len=kv_len,
                               sliding_window=cfg.sliding_window,
                               scale=scale)
    else:
        # GQA inside the kernel: K/V keep Hkv heads (the JAX path repeats
        # them to Hq first; the result is the same).
        out = ops.flash_attention(
            q, k, v, causal=causal, q_offset=pos, kv_len=kv_len,
            sliding_window=cfg.sliding_window, block_k=run.attn_block_k,
            scale=scale, use_kernels=run.use_kernels)
    y = out.reshape(B, S, Hq * Dh) @ p["wo"]
    return SR.constrain(y, "batch", None, None), cache


def _kv_for_heads(k: torch.Tensor, h0: int, q0: int, hq: int,
                  G: int) -> torch.Tensor:
    """The K (or V) heads that query heads ``q0 .. q0 + hq - 1`` read, from
    ``k`` (B, S, H, Dh) holding kv heads ``h0 ..``: a run of whole groups,
    the one head a part of a group shares, or (groups split unevenly) one
    kv head a query head."""
    if hq % G == 0 or G % hq == 0:
        a = q0 // G - h0
        return k[:, :, a:a + max(hq // G, 1)]
    idx = (q0 + torch.arange(hq, device=k.device)) // G - h0
    return k.index_select(2, idx)


def _attention_partial(q, k, v, *, k_first: int, causal: bool,
                       q_offset: int, kv_len: Optional[int],
                       sliding_window: int) -> torch.Tensor:
    """One rank's part of flash-decoding: the softmax statistics of ``q``
    (B, Sq, Hq, Dh) over keys (B, Sk, Hkv, Dh) at global positions
    ``k_first ..``, f32, packed as (B, Sq, Hkv, G, 2 + Dh): the max, the
    sum of exps and the unnormalised output."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = (q.float() * Dh ** -0.5).reshape(B, Sq, Hkv, Hq // Hkv, Dh)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float())
    mask = attention_mask(
        q_offset + torch.arange(Sq, device=q.device),
        k_first + torch.arange(Sk, device=q.device),
        valid_len=k_first + Sk if kv_len is None else kv_len,
        causal=causal, sliding_window=sliding_window)[None, :, None, None]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return torch.cat([m, p.sum(dim=-1, keepdim=True), o], dim=-1)


def _combine_partials(parts: torch.Tensor, dtype) -> torch.Tensor:
    """The ranks' ``_attention_partial`` statistics (n, B, Sq, Hkv, G, 2 +
    Dh), merged in rank order (the same on every rank) -> (B, Sq, Hq, Dh)."""
    m = parts[..., :1]
    w = torch.exp(m - m.amax(dim=0))
    l = (w * parts[..., 1:2]).sum(dim=0)
    o = (w * parts[..., 2:]).sum(dim=0)
    B, Sq, Hkv, G, Dh = o.shape
    return (o / l).reshape(B, Sq, Hkv * G, Dh).to(dtype)


def _attention_split(p: Params, cfg: ModelConfig, run: RunConfig,
                     x: torch.Tensor, *, pos: int, causal: bool,
                     cache: Optional[Params], kv_len: Optional[int],
                     xkv: Optional[torch.Tensor], cache_read_only: bool,
                     use_rope: bool
                     ) -> Tuple[torch.Tensor, Optional[Params]]:
    """``attention`` with ``model`` split over n > 1 ranks, in the JAX
    package's three cases (``repro/models/layers.py::attention``):

    heads (Hq % n == 0): this rank's Hq / n query heads (its columns of
      ``wq``, ``bq``), the kv heads they read (its own columns of ``wk``,
      ``wv`` where Hkv % n == 0; else taken from the weights made whole),
      the flash kernel on them, and its rows of ``wo``: a partial sum that
      ``leave_model`` adds up;
    rows (``"q_seq"``, S > 1 and S % n == 0): its S / n query rows at
      ``q_offset = pos + r S / n`` against the whole K/V, the weights
      whole (``model_whole``), its output rows gathered;
    whole (the rest: a decode step, or S % n != 0): every rank computes
      the whole, on weights gathered whole.

    Prefill writes this rank's block of the cache and attends over the
    fresh K/V (rounded as the cache holds them), so it must start at
    position 0.  Decode over a cache split over ``"kv_seq"`` computes each
    rank's partial softmax over its positions for all heads and combines
    them across ``model``; over a cache split over heads, or whole, it
    reads the heads it needs."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = Hq // Hkv
    rules = SR.current_rules()
    n, rank = SR.model_ranks(), rules.mesh.coord("model")
    defs = attention_defs(cfg, 0)
    if Hq % n == 0:
        mode = "heads"
    elif S > 1 and S % n == 0:
        mode = "rows"
    else:
        mode = "whole"
    split = mode != "whole"
    own_kv = mode == "heads" and Hkv % n == 0

    def weight(name: str) -> Optional[torch.Tensor]:
        if name not in p:
            return None
        if mode == "whole":
            return SR.gather(p[name], defs[name])
        if mode == "heads" and (name[1] in "qo" or own_kv):
            return p[name]  # this rank's heads
        return SR.model_whole(p[name], defs[name])

    if cache is not None and not cache_read_only and xkv is None \
            and S > 1 and pos != 0:
        raise NotImplementedError(
            "a prefill from position > 0 under a model split would read "
            "the cache's earlier positions")
    xin = SR.enter_model(x) if split else x
    if mode == "rows":
        r0 = rank * (S // n)
        xq, q_off = xin[:, r0:r0 + S // n], pos + r0
    else:
        xq, q_off = xin, pos
    Sq = xq.shape[1]
    q = xq @ weight("wq")
    if "bq" in p:
        q = q + weight("bq")
    q = q.reshape(B, Sq, -1, Dh)
    if use_rope:
        q = rope(q, q_off + torch.arange(Sq, device=x.device),
                 cfg.rope_theta)
    q0, hq = (rank * (Hq // n), Hq // n) if mode == "heads" else (0, Hq)

    from_cache = cache_read_only or (cache is not None and S == 1
                                     and xkv is None)
    if not cache_read_only:
        src = xin if xkv is None else (SR.enter_model(xkv) if split
                                       else xkv)
        k, v = src @ weight("wk"), src @ weight("wv")
        if "bk" in p:
            k, v = k + weight("bk"), v + weight("bv")
        k = k.reshape(B, -1, k.shape[-1] // Dh, Dh)
        v = v.reshape(B, -1, v.shape[-1] // Dh, Dh)
        if use_rope and xkv is None:
            k = rope(k, pos + torch.arange(k.shape[1], device=x.device),
                     cfg.rope_theta)
        k_h0 = rank * (Hkv // n) if own_kv else 0  # first head k holds
        if cache is not None:
            hc = cache["k"].shape[2]  # the heads the cache block holds
            c_h0 = rank * hc if hc < Hkv else 0
            if own_kv and hc == Hkv:  # every head: gather them
                kc = rules.all_gather(k, 2, ("model",))
                vc = rules.all_gather(v, 2, ("model",))
            else:
                kc = k[:, :, c_h0 - k_h0:c_h0 - k_h0 + hc]
                vc = v[:, :, c_h0 - k_h0:c_h0 - k_h0 + hc]
            _cache_write(cache, kc, vc, pos if xkv is None else 0)
            if not from_cache:
                k, v = _as_cached(cache, k), _as_cached(cache, v)

    if from_cache:
        kc, vc = cache_read(cache)
        kc, vc = kc.to(q.dtype), vc.to(q.dtype)
        block = kv_positions(cache)
        opts = dict(causal=causal, q_offset=pos, kv_len=kv_len,
                    sliding_window=cfg.sliding_window)
        if block is not None:  # flash-decoding over the positions
            q_all = q if hq == Hq else rules.all_gather(q, 2, ("model",))
            part = _attention_partial(q_all, kc, vc, k_first=block[0],
                                      **opts)
            out = _combine_partials(
                rules.all_gather(part[None], 0, ("model",)), q.dtype)
            out = out[:, :, q0:q0 + hq]
        else:
            c_h0 = rank * kc.shape[2] if kc.shape[2] < Hkv else 0
            out = _attention_kvseq(
                q, _kv_for_heads(kc, c_h0, q0, hq, G),
                _kv_for_heads(vc, c_h0, q0, hq, G), **opts)
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
        k = _kv_for_heads(k, k_h0, q0, hq, G)
        v = _kv_for_heads(v, k_h0, q0, hq, G)
        if S == 1:
            out = _attention_kvseq(q, k, v, causal=causal, q_offset=q_off,
                                   kv_len=kv_len,
                                   sliding_window=cfg.sliding_window)
        else:
            out = ops.flash_attention(
                q, k, v, causal=causal, q_offset=q_off, kv_len=kv_len,
                sliding_window=cfg.sliding_window,
                block_k=run.attn_block_k, use_kernels=run.use_kernels)
    y = out.reshape(B, Sq, hq * Dh) @ weight("wo")
    if mode == "heads":
        y = SR.leave_model(y)
    elif mode == "rows":
        y = SR.gather_model(y, 1)
    return SR.constrain(y, "batch", None, None), cache


# ---------------------------------------------------------------------------
# MLP / MoE / embedding / LM head
# ---------------------------------------------------------------------------


@obs.spanned("mlp")
def mlp(p: Params, cfg: ModelConfig, run: RunConfig,
        x: torch.Tensor) -> torch.Tensor:
    """The MLP.  Where ``p`` holds this rank's ``ffn`` columns of ``w_up``
    / ``w_gate`` / ``b_up`` and rows of ``w_down`` (a ``model`` split), the
    ranks' partial outputs are summed, and ``b_down`` is added once, after
    the sum."""
    a = act_fn(cfg.act)
    split = SR.model_ranks() > 1 and p["w_up"].shape[-1] != cfg.d_ff
    if split:
        x = SR.enter_model(x)
    up = x @ p["w_up"]
    if "b_up" in p:
        up = up + p["b_up"]
    h = a(x @ p["w_gate"]) * up if "w_gate" in p else a(up)
    y = h @ p["w_down"]
    if split:
        y = SR.leave_model(y)
    if "b_down" in p:
        y = y + p["b_down"]
    return SR.constrain(y, "batch", None, None)


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
    top-K (ties to the lower expert, as ``lax.top_k``); then
    :func:`moe_assign`."""
    gates, top_e = _gates_top(p, cfg, x)
    return moe_assign(cfg, gates, top_e)


def _gates_top(p: Params, cfg: ModelConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 router's softmax gates (..., E) and each token's K most
    probable experts (..., K), ties to the lower expert."""
    gates = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top_e = torch.sort(gates, dim=-1, descending=True, stable=True)[1]
    return gates, top_e[..., :cfg.num_experts_per_tok]


def _top_weights(gates: torch.Tensor, top_e: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A token's K experts in ascending order (..., K) and their gates
    renormalised over the K, in the same order: the order in which JAX's
    scatter-add combines them (its stable sort puts a row's pairs in
    expert order)."""
    top_w = gates.gather(-1, top_e)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    top_e, perm = torch.sort(top_e, dim=-1)
    return top_e, top_w.gather(-1, perm)


def moe_assign(cfg: ModelConfig, gates: torch.Tensor,
               top_e: torch.Tensor) -> MoERoute:
    """The route of each token's K chosen experts ``top_e`` (B, S, K):
    their gates (B, S, E) renormalised over the K; then in each batch row
    a stable sort of the (token, k) pairs by expert gives a pair its rank
    in its expert, and ranks >= C = ceil(S K / E * capacity_factor) drop
    (the row's latest tokens first)."""
    B, S, K = top_e.shape
    E = cfg.num_experts
    C = max(int(math.ceil(S * K / E * cfg.moe_capacity_factor)), 1)
    top_e, top_w = _top_weights(gates, top_e)

    flat_e = top_e.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    first = torch.searchsorted(
        se, torch.arange(E, device=gates.device).expand(B, E).contiguous())
    rank = torch.arange(S * K, device=gates.device) - first.gather(1, se)
    b = torch.arange(B, device=gates.device)[:, None]
    # rank and slot back in (token, k) order
    pos = torch.empty_like(rank).scatter_(1, order, rank)
    pos = pos.reshape(B, S, K)
    slot = (top_e * B + b[..., None]) * C + pos
    return MoERoute(top_e, top_w, slot, pos < C, C)


def _experts_combine(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     r: MoERoute, keep: torch.Tensor, slot: torch.Tensor,
                     n_exp: int, per_exp: int) -> torch.Tensor:
    """Kept pairs of ``x`` (B, S, d) copied into an (n_exp, per_exp, d)
    grid at ``slot``; each expert's gated MLP on its rows in one ``bmm``;
    a token's kept outputs, each times its weight (both in the output
    dtype), summed in expert order, one rounding a step, as JAX's
    scatter-add does.  No atomics: a row's bits do not vary from run to
    run."""
    B, S, d = x.shape
    K = cfg.num_experts_per_tok
    a = act_fn(cfg.act)
    n_slots = n_exp * per_exp
    # dropped pairs are written to one spare row past the grid
    dest = torch.where(keep, slot, n_slots).reshape(-1)
    xe = x.new_zeros((n_slots + 1, d))
    xe[dest] = x[:, :, None].expand(B, S, K, d).reshape(-1, d)
    xe = xe[:n_slots].view(n_exp, per_exp, d)
    h = a(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).view(n_slots, d)
    # a dropped pair reads slot 0 at weight 0, as JAX's clipped slot does
    w = torch.where(keep, r.weights, 0.0).to(ye.dtype)
    contrib = ye[torch.where(keep, slot, 0)] * w[..., None]
    y = contrib[:, :, 0]
    for k in range(1, K):
        y = y + contrib[:, :, k]
    return y


def moe_layer_defs(cfg: ModelConfig) -> Params:
    """The defs of one layer's MoE weights (no layer dim)."""
    return P.unstack(moe_defs(cfg, 1))


def moe_uses_shardmap(x: torch.Tensor) -> bool:
    """The dispatch of ``repro/models/layers.py::moe_block`` at its
    default ``moe_impl``: under rules with a "model" axis, prefill and
    training (S > 1) take the shardmap path; decode (S = 1) and calls
    without rules the gspmd one."""
    r = SR.current_rules()
    return r is not None and "model" in r.mesh.shape and x.shape[1] > 1


@obs.spanned("moe")
def moe_block(p: Params, cfg: ModelConfig, run: RunConfig,
              x: torch.Tensor) -> torch.Tensor:
    """Top-K MoE.  ``p`` is this rank's block of the layer's MoE weights
    (the whole layer without rules); the experts keep their ``model``
    split and the rest is gathered:

    shardmap (``_moe_block_shardmap``, prefill and training): the rank
      routes its B x S tokens as one row;
    gspmd (``_moe_block_gspmd``, decode and calls without rules): each
      batch row routes on its own.

    On either path a rank runs only its block of the expert products (its
    own experts, or all experts on its ffn slice) and one all-reduce over
    "model" adds the ranks' outputs."""
    if SR.sharded():
        p = SR.gather_params(p, moe_layer_defs(cfg), keep=("model",))
    if cfg.moe_dropless:
        y = _moe_block_dropless(p, cfg, run, x)
    else:
        y = (_moe_block_shardmap if moe_uses_shardmap(x)
             else _moe_block_gspmd)(p, cfg, run, x)
    if "shared" in p:
        with obs.span("moe.shared"):
            y = y + mlp(p["shared"], shared_expert_cfg(cfg), run, x)
    return y


# tokens a dropless MoE takes at once: at d 4096 and K 10, a block's
# routed rows out of the experts are 0.67 GB in bf16, and as much again
# while they are gathered by token and combined
MOE_TOKEN_BLOCK = 8_192


class MoERows(NamedTuple):
    """A dropless route of T tokens: their T * K (token, k) pairs sorted
    stably by expert, so that expert e's pairs are rows ``offsets[e] ..
    offsets[e + 1] - 1`` of the sorted order."""
    token: torch.Tensor  # (T * K,) int32: the token of each sorted pair
    offsets: torch.Tensor  # (E + 1,) int32
    where: torch.Tensor  # (T, K): each pair's row in the sorted order
    weights: torch.Tensor  # (T, K) f32, a token's pairs in expert order


def moe_sort(cfg: ModelConfig, top_e: torch.Tensor,
             top_w: torch.Tensor) -> MoERows:
    """The sorted pairs of tokens whose K experts ``top_e`` (T, K) come
    in ascending order with weights ``top_w`` (``_top_weights``)."""
    T, K = top_e.shape
    flat = top_e.reshape(-1)
    order = torch.argsort(flat, stable=True)
    # no host read: bincount would read the largest id back
    offsets = torch.searchsorted(
        flat[order], torch.arange(cfg.num_experts + 1, device=flat.device),
        out_int32=True)
    where = torch.empty_like(order)
    where[order] = torch.arange(order.numel(), device=flat.device)
    return MoERows((order // K).to(torch.int32), offsets, where.view(T, K),
                   top_w)


def _moe_block_dropless(p: Params, cfg: ModelConfig, run: RunConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """Top-K MoE over routed rows, nothing dropped: the tokens routed in
    f32 (as ``moe_route``), then ``MOE_TOKEN_BLOCK`` tokens at a time
    their (token, k) pairs sorted by expert (``moe_sort``), each expert's
    SwiGLU on exactly its rows (``ops.moe_experts``: the grouped kernel
    on CUDA, a loop of per-expert products elsewhere), and each token's
    K outputs times their weights (both in the output dtype) summed in
    expert order, one rounding a step, as ``_experts_combine`` sums
    them.  No atomics: a row's bits do not vary from run to run."""
    if SR.model_ranks() > 1:
        raise NotImplementedError("the dropless MoE under a model split")
    if cfg.act != "silu" or not cfg.gated_mlp:
        raise NotImplementedError("the dropless MoE runs SwiGLU experts")
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    with obs.span("moe.route"):
        top_e, top_w = _top_weights(*_gates_top(p, cfg, xt))
    out = torch.empty_like(xt)
    with obs.span("moe.experts"):
        for t0 in range(0, xt.shape[0], MOE_TOKEN_BLOCK):
            t1 = min(t0 + MOE_TOKEN_BLOCK, xt.shape[0])
            r = moe_sort(cfg, top_e[t0:t1], top_w[t0:t1])
            y = ops.moe_experts(xt[t0:t1], r.token, r.offsets, p["w_gate"],
                                p["w_up"], p["w_down"], decode=S == 1,
                                use_kernels=run.use_kernels)
            contrib = y[r.where]
            del y
            contrib.mul_(r.weights.to(contrib.dtype)[..., None])
            acc = contrib[:, 0]
            for k in range(1, contrib.shape[1]):
                acc = acc + contrib[:, k]
            out[t0:t1] = acc
    return out.view(B, S, d)


def _model_experts(p: Params, cfg: ModelConfig) -> Tuple[bool, int, int]:
    """(split, first expert, experts) of this rank's block of the expert
    weights ``p``: experts ``[m E / n, (m + 1) E / n)`` of model rank m
    where E divides ``model``, else all E on the rank's ffn slice; not
    split where the weights are whole (one model rank, or neither
    divides)."""
    E, E_loc = cfg.num_experts, p["w_gate"].shape[0]
    if SR.model_ranks() > 1 and E_loc < E:
        return True, SR.current_rules().mesh.coord("model") * E_loc, E_loc
    return SR.model_ranks() > 1 and p["w_gate"].shape[-1] < cfg.d_ff, 0, E


def _experts_where_they_lie(p: Params, cfg: ModelConfig,
                            x: torch.Tensor) -> torch.Tensor:
    """Routes each row of ``x`` (B, S, d) on its own and runs the rank's
    block of the experts on its (E, B, C) slot grid: pairs of other
    ranks' experts are not kept, and the ranks' outputs are summed over
    ``model``.  The input and the router are replicated over ``model``;
    each rank's experts give a part of their gradients."""
    split, base, E_loc = _model_experts(p, cfg)
    if split:
        x = SR.enter_model(x)
        p = {**p, "router": SR.enter_model(p["router"])}
    r = moe_route(p, cfg, x)
    per = x.shape[0] * r.capacity  # an expert's slots
    keep = r.keep & (r.experts >= base) & (r.experts < base + E_loc)
    y = _experts_combine(p, cfg, x, r, keep, r.slot - base * per, E_loc,
                         per)
    return SR.leave_model(y) if split else y


def _moe_block_gspmd(p: Params, cfg: ModelConfig, run: RunConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """The semantics of ``_moe_block_gspmd``: each batch row routes its S
    tokens with capacity C = ceil(S K / E * factor).  Kept pairs go into
    an (E, B, C, d) grid; each expert runs its B*C slots in one ``bmm``.
    Under a ``model`` split the rank runs its experts' slots (or every
    expert on its ffn slice), as the JAX products follow the weights'
    sharding there: EP on the expert dim, or TP on the per-expert ffn."""
    y = _experts_where_they_lie(p, cfg, x)
    return SR.constrain(y.to(x.dtype), "batch", None, None)


def _moe_block_shardmap(p: Params, cfg: ModelConfig, run: RunConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """The semantics of ``_moe_block_shardmap``: the rank routes its T =
    B_local * S tokens as one row, with capacity C = ceil(T K / E *
    factor) over them; it runs only its local experts (E % n_model == 0:
    experts ``[m E_loc, (m + 1) E_loc)`` of model rank m) or all E on its
    ffn slice, and one all-reduce over "model" adds the disjoint (or
    f-partial) outputs.  ``p``: the experts' local blocks, the router
    whole."""
    B, Sq, d = x.shape
    E, n_model = cfg.num_experts, SR.model_ranks()
    if n_model > 1 and not _model_experts(p, cfg)[0]:
        raise ValueError(f"the shardmap MoE splits E {E} or d_ff "
                         f"{cfg.d_ff} over model {n_model}: neither divides")
    y = _experts_where_they_lie(p, cfg, x.reshape(1, B * Sq, d))
    return SR.constrain(y.reshape(B, Sq, d).to(x.dtype), "batch", None, None)


def _vocab_split(w: torch.Tensor, cfg: ModelConfig) -> bool:
    """Whether ``w`` holds this rank's ``model`` block of the vocab rows."""
    return SR.model_ranks() > 1 and w.shape[0] != cfg.vocab_size


def embed(p: Params, cfg: ModelConfig, tokens: torch.Tensor
          ) -> torch.Tensor:
    """The token embeddings.  On a table split over ``model`` by vocab
    rows: a lookup of the ids in this rank's rows (zeros for the rest),
    summed over ``model``, which is exact."""
    tok = p["tok"]
    if not _vocab_split(tok, cfg):
        return SR.constrain(tok[tokens], "batch", None, None)
    v0, nv = SR.model_block(cfg.vocab_size)
    ids = tokens - v0
    hit = (ids >= 0) & (ids < nv)
    y = torch.where(hit[..., None], tok[ids.clamp(0, nv - 1)],
                    tok.new_zeros(()))
    return SR.constrain(SR.leave_model(y), "batch", None, None)


def lm_head_weight(p: Params, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"] if cfg.tie_embeddings else p["lm_head"]


def logits_out(p: Params, cfg: ModelConfig, run: RunConfig,
               x: torch.Tensor) -> torch.Tensor:
    """The logits.  With the head split over ``model`` by vocab rows, each
    rank computes its rows and the logits are gathered over ``model`` (at
    serving's last position: B V floats)."""
    w = lm_head_weight(p, cfg)
    split = _vocab_split(w, cfg)
    if split:
        x = SR.enter_model(x)
    y = x @ w.t()
    y = y.float() if run.logits_in_fp32 else y
    if split:
        y = SR.gather_model(y, -1)
    return SR.constrain(y, "batch", None, "vocab")
