"""Plain float32 reference of a dense decoder-only transformer with GQA
(the Llama architecture that Yi-6B publishes, arXiv:2403.04652): RMSNorm,
RoPE over the head halves, causal grouped-query attention, a SwiGLU MLP,
an untied LM head.

The weights are laid out as the program under test stores them (layers
stacked on a leading axis, ``x @ W`` with ``W`` of shape (d_in, d_out)),
so that the benchmark draws one tree and hands the same to both sides.
Departures from the published model: none in the mathematics; positions
run over a whole packed row (no reset at a document boundary), as the
program trains them.

A model is a sequence of *units* (here one a layer), each a function of
the residual stream and its own weights, between ``embed`` and ``head``;
``reference/train_ref.py`` and ``reference/serve_ref.py`` run any family
that gives these functions.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from perfbench.reference.common import (ACTS, Leaf, attention, fan_in, mm,
                                        rmsnorm, rope, unit_weights)

Path = Tuple[str, ...]
_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_up", "w_down", "w_gate")


def leaf_specs(c: Dict) -> Dict[Path, Leaf]:
    L, d, f, V = c["num_layers"], c["d_model"], c["d_ff"], c["vocab_size"]
    qd = c["num_heads"] * c["head_dim"]
    kvd = c["num_kv_heads"] * c["head_dim"]
    return {
        ("embed", "tok"): Leaf((V, d)),
        ("embed", "lm_head"): Leaf((V, d), scale=fan_in(d)),
        ("blocks", "ln1"): Leaf((L, d), init="ones"),
        ("blocks", "attn", "wq"): Leaf((L, d, qd), scale=fan_in(d)),
        ("blocks", "attn", "wk"): Leaf((L, d, kvd), scale=fan_in(d)),
        ("blocks", "attn", "wv"): Leaf((L, d, kvd), scale=fan_in(d)),
        ("blocks", "attn", "wo"): Leaf((L, qd, d), scale=fan_in(qd)),
        ("blocks", "ln2"): Leaf((L, d), init="ones"),
        ("blocks", "mlp", "w_up"): Leaf((L, d, f), scale=fan_in(d)),
        ("blocks", "mlp", "w_down"): Leaf((L, f, d), scale=fan_in(f)),
        ("blocks", "mlp", "w_gate"): Leaf((L, d, f), scale=fan_in(d)),
        ("ln_f",): Leaf((d,), init="ones"),
    }


def block_paths(prefix: Path) -> List[Path]:
    """The leaves of one attention + MLP block under ``prefix``."""
    return ([prefix + ("ln1",)] + [prefix + ("attn", k) for k in _ATTN]
            + [prefix + ("ln2",)] + [prefix + ("mlp", k) for k in _MLP])


def units(c: Dict) -> List[Tuple[str, int]]:
    return [("block", i) for i in range(c["num_layers"])]


def unit_leaves(c: Dict, unit: Tuple[str, int]
                ) -> List[Tuple[Path, Optional[int]]]:
    return [(p, unit[1]) for p in block_paths(("blocks",))]


HEAD_LEAVES: List[Tuple[Path, Optional[int]]] = [
    (("ln_f",), None), (("embed", "lm_head"), None)]


def attn_mlp_block(c: Dict, w: Dict[Path, torch.Tensor], pre: Path,
                   x: torch.Tensor, mode: str) -> torch.Tensor:
    """x + attention, then + MLP, both pre-normed (weights under ``pre``)."""
    x = attn_part(c, w, pre, x, mode)
    h = rmsnorm(x, w[pre + ("ln2",)], c["norm_eps"])
    act = ACTS[c["act"]]
    a = act(mm(h, w[pre + ("mlp", "w_gate")], mode)) * mm(
        h, w[pre + ("mlp", "w_up")], mode)
    return x + mm(a, w[pre + ("mlp", "w_down")], mode)


def attn_part(c: Dict, w: Dict[Path, torch.Tensor], pre: Path,
              x: torch.Tensor, mode: str) -> torch.Tensor:
    """x + pre-normed causal GQA attention (weights under ``pre``)."""
    B, S, _ = x.shape
    Hq, Hkv, D = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    pos = torch.arange(S, device=x.device)
    h = rmsnorm(x, w[pre + ("ln1",)], c["norm_eps"])
    q = rope(mm(h, w[pre + ("attn", "wq")], mode).reshape(B, S, Hq, D), pos,
             c["rope_theta"])
    k = rope(mm(h, w[pre + ("attn", "wk")], mode).reshape(B, S, Hkv, D), pos,
             c["rope_theta"])
    v = mm(h, w[pre + ("attn", "wv")], mode).reshape(B, S, Hkv, D)
    return x + mm(attention(q, k, v, mode), w[pre + ("attn", "wo")], mode)


def unit_forward(c: Dict, unit: Tuple[str, int], w: Dict[Path, torch.Tensor],
                 x: torch.Tensor, mode: str) -> torch.Tensor:
    return attn_mlp_block(c, w, ("blocks",), x, mode)


def embed(c: Dict, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["tok"][tokens.long()].float()


def cache_v(c: Dict, params: Dict, tokens: torch.Tensor,
            mode: str = "f32") -> torch.Tensor:
    """The first layer's V over ``tokens`` (n, T), as a KV cache holds
    it: (n, T, Hkv, D) f32 (its product in ``mode``)."""
    w = unit_weights(params, [(("blocks", "ln1"), 0),
                              (("blocks", "attn", "wv"), 0)])
    h = rmsnorm(embed(c, params, tokens), w[("blocks", "ln1")],
                c["norm_eps"])
    n, T = tokens.shape
    return mm(h, w[("blocks", "attn", "wv")], mode).reshape(
        n, T, c["num_kv_heads"], c["head_dim"])


def head_hidden(c: Dict, w: Dict[Path, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """The final norm; the logits are ``head_hidden @ lm_headᵀ``."""
    return rmsnorm(x, w[("ln_f",)], c["norm_eps"])


def forward_flops(c: Dict, B: int, S: int, ops) -> float:
    """Model FLOPs of one forward over (B, S) tokens: 2 a token and
    weight of every product (the embedding gather is none), and the
    attention over the visible causal pairs (``ops``: the op classes)."""
    d, f, V = c["d_model"], c["d_ff"], c["vocab_size"]
    qd = c["num_heads"] * c["head_dim"]
    kvd = c["num_kv_heads"] * c["head_dim"]
    per_layer = d * qd * 2 + d * kvd * 2 + 3 * d * f
    mats = c["num_layers"] * per_layer + V * d
    attn = ops["flash_fwd"].work(B=B, Sq=S, Sk=S, Hq=c["num_heads"],
                                 Hkv=c["num_kv_heads"], D=c["head_dim"])[0]
    return 2.0 * mats * B * S + c["num_layers"] * attn


def kernel_calls(c: Dict, kind: str, B: int, S: int, max_len: int = 0,
                 ranks: int = 1) -> List[Tuple[str, Dict]]:
    """The attention work one step needs, counted once: training a
    forward (writing ``lse``) and a backward a layer; a prefill over a
    cache of ``max_len`` positions a forward a layer.  Over ``ranks``
    ranks splitting the heads, one rank's share: its query and KV
    heads."""
    a = dict(B=B, Sq=S, Hq=c["num_heads"] // ranks,
             Hkv=c["num_kv_heads"] // ranks, D=c["head_dim"])
    if kind == "train":
        return c["num_layers"] * [("flash_fwd", dict(a, Sk=S, lse=True)),
                                  ("flash_bwd", dict(a, Sk=S))]
    return c["num_layers"] * [("flash_fwd", dict(a, Sk=max_len, kv_len=S))]
