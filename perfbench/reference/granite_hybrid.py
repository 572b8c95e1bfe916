"""Plain float32 reference of Granite 4.0-H (Hugging Face
``granitemoehybrid``, the architecture of ibm-granite/granite-4.0-h-small)
as the program runs it:

    x = embedding_multiplier * E[ids]
    for each layer l:
        h = RMSNorm_in,l(x)
        m = Attn_l(h) if l in attn_layers else Mamba2_l(h)
        x = x + residual_multiplier * m
        h = RMSNorm_post,l(x)
        y = sum_k g_k SwiGLU_e(k)(h) + SwiGLU_shared(h)
        x = x + residual_multiplier * y
    logits = (RMSNorm_f(x) W_headᵀ) / logits_scaling

Attention: causal GQA, no rotary (NoPE), softmax scale
``attention_multiplier``, no biases.  Mamba2: the Zamba2 reference's
block without its norm and residual (``zamba2.ssd``: z, x, B, C and dt
projections; the causal depthwise convolution with bias and SiLU on x,
B and C; Δ = softplus(dt + dt_bias); A = -exp(A_log); the SSD
recurrence; + D x; RMSNorm of y SiLU(z) over all of its width; the out
projection); one B / C group.  The router: the softmax over the E f32
logits, each token's K largest renormalised to sum to 1 (``moe.route``,
which is the published softmax over the top-K logits), each expert's
SwiGLU (gate first) on the tokens routed to it only; nothing dropped.
The shared expert is a SwiGLU every token takes.

Departures from the published model, which the program makes too: the
LM head is a weight of its own (``lm_head``; published tied to the
embedding), with the same shapes and products; the SSD chunk is 128
(published 256; the chunks only regroup the sum, exact in f32).

Besides the precisions of ``common.mm`` (``"f32"``, ``"fp8"``; the SSD
stays f32), ``unit_forward`` plants two faults, in f32: ``"top9"``, each
token's 10th expert left out (the other nine keep their weights), and
``"noshared"``, the shared expert left out.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import dense, moe, zamba2
from perfbench.reference.common import (PRECISIONS, Leaf, attention, fan_in,
                                        mm, rmsnorm, silu, unit_weights)

Path = Tuple[str, ...]
FAULTS = ("top9", "noshared")
_MAMBA = ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B", "conv_C",
          "conv_x_b", "conv_B_b", "conv_C_b", "A_log", "D", "dt_bias",
          "norm", "w_out")
_ATTN = ("wq", "wk", "wv", "wo")
_MOE = ("router", "w_gate", "w_up", "w_down")
_SHARED = ("w_up", "w_down", "w_gate")

HEAD_LEAVES = dense.HEAD_LEAVES


def mamba_layers(c: Dict) -> List[int]:
    return [i for i in range(c["num_layers"]) if i not in c["attn_layers"]]


def leaf_specs(c: Dict) -> Dict[Path, Leaf]:
    L, d, f, V = c["num_layers"], c["d_model"], c["d_ff"], c["vocab_size"]
    E, fs = c["num_experts"], c["shared_expert_d_ff"]
    nM, nA = len(mamba_layers(c)), len(c["attn_layers"])
    din, N, H, _, W = zamba2._dims(c)
    qd = c["num_heads"] * c["head_dim"]
    kvd = c["num_kv_heads"] * c["head_dim"]
    f32 = torch.float32
    m, a, e = ("blocks", "mamba"), ("blocks", "attn"), ("blocks", "moe")
    return {
        ("embed", "tok"): Leaf((V, d)),
        ("embed", "lm_head"): Leaf((V, d), scale=fan_in(d)),
        ("blocks", "ln_in"): Leaf((L, d), init="ones"),
        ("blocks", "ln_post"): Leaf((L, d), init="ones"),
        m + ("w_z",): Leaf((nM, d, din), scale=fan_in(d)),
        m + ("w_x",): Leaf((nM, d, din), scale=fan_in(d)),
        m + ("w_B",): Leaf((nM, d, N), scale=fan_in(d)),
        m + ("w_C",): Leaf((nM, d, N), scale=fan_in(d)),
        m + ("w_dt",): Leaf((nM, d, H), scale=fan_in(d)),
        m + ("conv_x",): Leaf((nM, W, din), scale=fan_in(W)),
        m + ("conv_B",): Leaf((nM, W, N), scale=fan_in(W)),
        m + ("conv_C",): Leaf((nM, W, N), scale=fan_in(W)),
        m + ("conv_x_b",): Leaf((nM, din), scale=0.1),
        m + ("conv_B_b",): Leaf((nM, N), scale=0.1),
        m + ("conv_C_b",): Leaf((nM, N), scale=0.1),
        m + ("A_log",): Leaf((nM, H), f32, init="ssm_a"),
        m + ("D",): Leaf((nM, H), f32, init="ones"),
        m + ("dt_bias",): Leaf((nM, H), f32, init="ssm_dt"),
        m + ("norm",): Leaf((nM, din), init="ones"),
        m + ("w_out",): Leaf((nM, din, d), scale=fan_in(din)),
        a + ("wq",): Leaf((nA, d, qd), scale=fan_in(d)),
        a + ("wk",): Leaf((nA, d, kvd), scale=fan_in(d)),
        a + ("wv",): Leaf((nA, d, kvd), scale=fan_in(d)),
        a + ("wo",): Leaf((nA, qd, d), scale=fan_in(qd)),
        e + ("router",): Leaf((L, d, E), f32, scale=fan_in(d)),
        e + ("w_gate",): Leaf((L, E, d, f), scale=fan_in(d)),
        e + ("w_up",): Leaf((L, E, d, f), scale=fan_in(d)),
        e + ("w_down",): Leaf((L, E, f, d), scale=fan_in(f)),
        e + ("shared", "w_up"): Leaf((L, d, fs), scale=fan_in(d)),
        e + ("shared", "w_down"): Leaf((L, fs, d), scale=fan_in(fs)),
        e + ("shared", "w_gate"): Leaf((L, d, fs), scale=fan_in(d)),
        ("ln_f",): Leaf((d,), init="ones"),
    }


def units(c: Dict) -> List[Tuple[str, int]]:
    return [("layer", i) for i in range(c["num_layers"])]


def unit_leaves(c: Dict, unit: Tuple[str, int]
                ) -> List[Tuple[Path, Optional[int]]]:
    i = unit[1]
    if i in c["attn_layers"]:
        mixer = [(("blocks", "attn", k), c["attn_layers"].index(i))
                 for k in _ATTN]
    else:
        mixer = [(("blocks", "mamba", k), mamba_layers(c).index(i))
                 for k in _MAMBA]
    return ([(("blocks", "ln_in"), i), (("blocks", "ln_post"), i)] + mixer
            + [(("blocks", "moe", k), i) for k in _MOE]
            + [(("blocks", "moe", "shared", k), i) for k in _SHARED])


def _attn(c: Dict, w: Dict[Path, torch.Tensor], h: torch.Tensor,
          mode: str) -> torch.Tensor:
    """Causal GQA over h (B, S, d), no rotary, softmax scale
    ``attention_multiplier`` (``common.attention`` scales by D^-1/2, so q
    is scaled by the rest first)."""
    B, S, _ = h.shape
    Hq, Hkv, D = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    g = lambda k: w[("blocks", "attn", k)]  # noqa: E731
    q = mm(h, g("wq"), mode).reshape(B, S, Hq, D)
    q = q * (c["attention_multiplier"] * D ** 0.5)
    k = mm(h, g("wk"), mode).reshape(B, S, Hkv, D)
    v = mm(h, g("wv"), mode).reshape(B, S, Hkv, D)
    return mm(attention(q, k, v, mode), g("wo"), mode)


def _mamba(c: Dict, w: Dict[Path, torch.Tensor], h: torch.Tensor,
           mode: str) -> torch.Tensor:
    """The Mamba2 mixer over the normed h (B, S, d)."""
    B, S, _ = h.shape
    din, N, H, P, _ = zamba2._dims(c)
    g = lambda k: w[("blocks", "mamba", k)]  # noqa: E731
    z = mm(h, g("w_z"), mode)
    xs = zamba2._conv(mm(h, g("w_x"), mode), g("conv_x"), g("conv_x_b"))
    Bm = zamba2._conv(mm(h, g("w_B"), mode), g("conv_B"), g("conv_B_b"))
    Cm = zamba2._conv(mm(h, g("w_C"), mode), g("conv_C"), g("conv_C_b"))
    dt = F.softplus(mm(h, g("w_dt"), mode) + g("dt_bias"))
    xh = xs.reshape(B, S, H, P)
    y = zamba2.ssd(xh, dt, -torch.exp(g("A_log")), Bm, Cm, c["ssm_chunk"])
    y = (y + xh * g("D")[:, None]).reshape(B, S, din) * silu(z)
    return mm(rmsnorm(y, g("norm"), c["norm_eps"]), g("w_out"), mode)


def _experts(c: Dict, w: Dict[Path, torch.Tensor], h: torch.Tensor,
             mode: str, keep: int) -> torch.Tensor:
    """The routed experts over tokens h (T, d): each token's ``keep``
    most probable of its K experts, at their weights renormalised over
    the K."""
    pre = ("blocks", "moe")
    e, wt = moe.route(c, h, w[pre + ("router",)], mode)
    e, wt = e[:, :keep], wt[:, :keep]
    out = torch.zeros_like(h)
    for x in range(c["num_experts"]):
        tok, k = torch.nonzero(e == x, as_tuple=True)
        if tok.numel() == 0:
            continue
        hx = h[tok]
        a = silu(mm(hx, w[pre + ("w_gate",)][x], mode)) * mm(
            hx, w[pre + ("w_up",)][x], mode)
        out.index_add_(0, tok, mm(a, w[pre + ("w_down",)][x], mode)
                       * wt[tok, k, None])
    return out


def _shared(c: Dict, w: Dict[Path, torch.Tensor], h: torch.Tensor,
            mode: str) -> torch.Tensor:
    g = lambda k: w[("blocks", "moe", "shared", k)]  # noqa: E731
    return mm(silu(mm(h, g("w_gate"), mode)) * mm(h, g("w_up"), mode),
              g("w_down"), mode)


def unit_forward(c: Dict, unit: Tuple[str, int], w: Dict[Path, torch.Tensor],
                 x: torch.Tensor, mode: str) -> torch.Tensor:
    """One layer: the mixer, then the MoE and shared expert, each a
    pre-normed branch scaled by ``residual_multiplier``."""
    if mode not in PRECISIONS + FAULTS:
        raise ValueError(f"unknown mode {mode!r}")
    prec = mode if mode in PRECISIONS else "f32"
    r, eps = c["residual_multiplier"], c["norm_eps"]
    h = rmsnorm(x, w[("blocks", "ln_in")], eps)
    mix = _attn if unit[1] in c["attn_layers"] else _mamba
    x = x + r * mix(c, w, h, prec)
    h = rmsnorm(x, w[("blocks", "ln_post")], eps)
    B, S, d = h.shape
    ht = h.reshape(B * S, d)
    K = c["num_experts_per_tok"]
    y = _experts(c, w, ht, prec, K - 1 if mode == "top9" else K)
    if mode != "noshared":
        y = y + _shared(c, w, ht, prec)
    return x + r * y.reshape(B, S, d)


def embed(c: Dict, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return dense.embed(c, params, tokens) * c["embedding_multiplier"]


def head_hidden(c: Dict, w: Dict[Path, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """The final norm over ``logits_scaling``: the logits are
    ``head_hidden @ lm_headᵀ``."""
    return rmsnorm(x, w[("ln_f",)], c["norm_eps"]) / c["logits_scaling"]


@torch.no_grad()
def cache_v(c: Dict, params: Dict, tokens: torch.Tensor,
            mode: str = "f32", rows: int = 4) -> torch.Tensor:
    """The first attention layer's V over ``tokens`` (n, T), as a KV cache
    holds it: (n, T, Hkv, D) f32 (every product in ``mode``), the layers
    before it run ``rows`` requests at a time."""
    a0 = c["attn_layers"][0]
    x = embed(c, params, tokens)
    for i in range(a0):
        w = unit_weights(params, unit_leaves(c, ("layer", i)))
        for r in range(0, x.shape[0], rows):
            x[r:r + rows] = unit_forward(c, ("layer", i), w, x[r:r + rows],
                                         mode)
        del w
    w = unit_weights(params, [(("blocks", "ln_in"), a0),
                              (("blocks", "attn", "wv"), 0)])
    h = rmsnorm(x, w[("blocks", "ln_in")], c["norm_eps"])
    n, T = tokens.shape
    return mm(h, w[("blocks", "attn", "wv")], mode).reshape(
        n, T, c["num_kv_heads"], c["head_dim"])


def ssd_shape(c: Dict, B: int, S: int) -> Dict:
    return zamba2.ssd_shape(c, B, S)


def forward_flops(c: Dict, B: int, S: int, ops) -> float:
    """Model FLOPs of one forward over (B, S) tokens: 2 a token and
    weight of every product a token takes part in (the Mamba2
    projections and the depthwise convolutions' 2 a tap; attention's
    projections; the router, the K experts it goes to and the shared
    expert; the head; the embedding gather is none), the attention over
    the visible causal pairs and the SSD scan's counted work (``ops``:
    the op classes)."""
    d, f, V = c["d_model"], c["d_ff"], c["vocab_size"]
    din, N, H, P, W = zamba2._dims(c)
    qd = c["num_heads"] * c["head_dim"]
    kvd = c["num_kv_heads"] * c["head_dim"]
    nM, nA, L = len(mamba_layers(c)), len(c["attn_layers"]), c["num_layers"]
    mamba = d * (2 * din + 2 * N + H) + din * d + W * (din + 2 * N)
    attn_proj = 2 * d * qd + 2 * d * kvd
    expert = d * c["num_experts"] + c["num_experts_per_tok"] * 3 * d * f \
        + 3 * d * c["shared_expert_d_ff"]
    mats = nM * mamba + nA * attn_proj + L * expert + V * d
    attn = ops["flash_fwd"].work(B=B, Sq=S, Sk=S, Hq=c["num_heads"],
                                 Hkv=c["num_kv_heads"], D=c["head_dim"])[0]
    scan = ops["ssd_fwd"].work(**ssd_shape(c, B, S))[0]
    return 2.0 * mats * B * S + nA * attn + nM * scan


def kernel_calls(c: Dict, kind: str, B: int, S: int, max_len: int = 0,
                 ranks: int = 1) -> List[Tuple[str, Dict]]:
    """The kernel work a prefill over a cache of ``max_len`` positions
    needs, counted once, in the program's order: a layer's mixer (a flash
    forward, or an SSD scan forward), then its routed experts over the
    batch's B S tokens (the shared expert is a plain product)."""
    if kind != "prefill" or ranks != 1:
        raise ValueError(f"the granite cells serve on one rank, not "
                         f"{kind!r} on {ranks}")
    flash = ("flash_fwd", dict(B=B, Sq=S, Sk=max_len, kv_len=S,
                               Hq=c["num_heads"], Hkv=c["num_kv_heads"],
                               D=c["head_dim"]))
    scan = ("ssd_fwd", ssd_shape(c, B, S))
    experts = ("moe_experts", dict(T=B * S, K=c["num_experts_per_tok"],
                                   E=c["num_experts"], d=c["d_model"],
                                   f=c["d_ff"]))
    out: List[Tuple[str, Dict]] = []
    for i in range(c["num_layers"]):
        out += [flash if i in c["attn_layers"] else scan, experts]
    return out
