"""Plain float32 reference of a sparse mixture-of-experts decoder (the
architecture that Mixtral-8x7B publishes, arXiv:2401.04088): the dense
decoder's RMSNorm, RoPE and causal GQA attention (``dense.attn_part``),
then in place of the MLP a router and E SwiGLU experts, each token going
to its top K.

The router's probabilities are the softmax over the E logits; a token
takes the K largest and renormalises them to sum to 1, which is
Mixtral's softmax over its top-K logits.  Each expert runs its SwiGLU on
the tokens routed to it only, and a token's output is the weighted sum
of its K experts'.  Nothing is dropped: every token reaches its K
experts, as in Mixtral (the program's capacity, which at the cells'
shapes drops nothing, is its own).  The weights are laid out as the
program stores them: experts stacked on an E axis, ``w_gate`` / ``w_up``
(L, E, d, f), ``w_down`` (L, E, f, d), the router (L, d, E) in f32.

Besides the precisions of ``common.mm`` (``"f32"``, ``"fp8"``),
``unit_forward`` takes the fault ``"top1"``: each token's second expert
dropped (its first keeps its renormalised weight), in f32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from perfbench.reference import dense
from perfbench.reference.common import ACTS, Leaf, fan_in, mm, rmsnorm

Path = Tuple[str, ...]
_MOE = ("router", "w_gate", "w_up", "w_down")

HEAD_LEAVES = dense.HEAD_LEAVES
embed = dense.embed
head_hidden = dense.head_hidden
cache_v = dense.cache_v


def leaf_specs(c: Dict) -> Dict[Path, Leaf]:
    L, d, f, E = (c["num_layers"], c["d_model"], c["d_ff"],
                  c["num_experts"])
    out = {p: l for p, l in dense.leaf_specs(c).items()
           if p[:2] != ("blocks", "mlp")}
    out.update({
        ("blocks", "moe", "router"): Leaf((L, d, E), torch.float32,
                                          scale=fan_in(d)),
        ("blocks", "moe", "w_gate"): Leaf((L, E, d, f), scale=fan_in(d)),
        ("blocks", "moe", "w_up"): Leaf((L, E, d, f), scale=fan_in(d)),
        ("blocks", "moe", "w_down"): Leaf((L, E, f, d), scale=fan_in(f)),
    })
    return out


def units(c: Dict) -> List[Tuple[str, int]]:
    return [("block", i) for i in range(c["num_layers"])]


def unit_leaves(c: Dict, unit: Tuple[str, int]
                ) -> List[Tuple[Path, Optional[int]]]:
    b = ("blocks",)
    paths = ([b + ("ln1",)] + [b + ("attn", k) for k in dense._ATTN]
             + [b + ("ln2",)] + [b + ("moe", k) for k in _MOE])
    return [(p, unit[1]) for p in paths]


def route(c: Dict, h: torch.Tensor, router: torch.Tensor, mode: str
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's K experts (T, K), the most probable first, and their
    weights (T, K), renormalised over the K."""
    gates = torch.softmax(mm(h, router, mode), dim=-1)
    w, e = torch.topk(gates, c["num_experts_per_tok"], dim=-1)
    return e, w / w.sum(dim=-1, keepdim=True)


def experts(c: Dict, w: Dict[Path, torch.Tensor], h: torch.Tensor,
            mode: str, drop_second: bool = False) -> torch.Tensor:
    """The MoE layer over tokens ``h`` (T, d): each expert's SwiGLU on the
    tokens routed to it, summed with the tokens' weights."""
    pre = ("blocks", "moe")
    e, wt = route(c, h, w[pre + ("router",)], mode)
    if drop_second:
        e, wt = e[:, :1], wt[:, :1]
    act = ACTS[c["act"]]
    out = torch.zeros_like(h)
    for x in range(c["num_experts"]):
        tok, k = torch.nonzero(e == x, as_tuple=True)
        if tok.numel() == 0:
            continue
        hx = h[tok]
        a = act(mm(hx, w[pre + ("w_gate",)][x], mode)) * mm(
            hx, w[pre + ("w_up",)][x], mode)
        y = mm(a, w[pre + ("w_down",)][x], mode)
        out.index_add_(0, tok, y * wt[tok, k, None])
    return out


def unit_forward(c: Dict, unit: Tuple[str, int], w: Dict[Path, torch.Tensor],
                 x: torch.Tensor, mode: str) -> torch.Tensor:
    """One layer: x + attention, then + the MoE layer, both pre-normed."""
    prec = "f32" if mode == "top1" else mode
    x = dense.attn_part(c, w, ("blocks",), x, prec)
    h = rmsnorm(x, w[("blocks", "ln2")], c["norm_eps"])
    B, S, d = h.shape
    y = experts(c, w, h.reshape(B * S, d), prec, drop_second=mode == "top1")
    return x + y.reshape(B, S, d)


def forward_flops(c: Dict, B: int, S: int, ops) -> float:
    """Model FLOPs of one forward over (B, S) tokens: 2 a token and
    weight of every product a token takes part in (the router, and the
    K experts it goes to; the embedding gather is none), and the
    attention over the visible causal pairs (``ops``: the op classes)."""
    d, f, V = c["d_model"], c["d_ff"], c["vocab_size"]
    qd = c["num_heads"] * c["head_dim"]
    kvd = c["num_kv_heads"] * c["head_dim"]
    per_layer = d * qd * 2 + d * kvd * 2 + d * c["num_experts"] \
        + c["num_experts_per_tok"] * 3 * d * f
    mats = c["num_layers"] * per_layer + V * d
    attn = ops["flash_fwd"].work(B=B, Sq=S, Sk=S, Hq=c["num_heads"],
                                 Hkv=c["num_kv_heads"], D=c["head_dim"],
                                 sliding_window=c.get("sliding_window", 0)
                                 )[0]
    return 2.0 * mats * B * S + c["num_layers"] * attn


def kernel_calls(c: Dict, kind: str, B: int, S: int, max_len: int = 0,
                 ranks: int = 1) -> List[Tuple[str, Dict]]:
    """The attention work a prefill over a cache of ``max_len`` positions
    needs, a flash forward a layer, counted once; over ``ranks`` ranks
    splitting the heads, one rank's share: its query and KV heads."""
    if kind != "prefill":
        raise ValueError(f"the MoE cells serve only, not {kind!r}")
    return c["num_layers"] * [("flash_fwd", dict(
        B=B, Sq=S, Sk=max_len, kv_len=S, Hq=c["num_heads"] // ranks,
        Hkv=c["num_kv_heads"] // ranks, D=c["head_dim"],
        sliding_window=c.get("sliding_window", 0)))]
