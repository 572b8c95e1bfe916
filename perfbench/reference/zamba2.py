"""Plain float32 reference of the Zamba2 hybrid (arXiv:2411.15242) as the
program runs it: a backbone of Mamba2 blocks (arXiv:2405.21060: in
projections z, x, B, C, dt; a causal depthwise convolution of x, B and C
with SiLU; the SSD recurrence h[t] = exp(dt A) h[t-1] + dt B[t] x[t],
y[t] = C[t] h[t] + D x[t]; y gated by SiLU(z), RMSNorm, out projection),
with one shared attention + MLP block (``dense.attn_mlp_block``, GELU)
applied after every ``attn_every`` Mamba2 blocks.

Departures from the published model, which the program makes too: the
shared block reads the residual stream alone (the published one also
takes the original embeddings, concatenated), and its per-application
LoRA adapters are left out; one B / C group.  The SSD is the plain
chunked form (exact in f32: the chunks only regroup the sum), and stays
in f32 in the fp8 control too, whose products are the projections and
attention's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import dense
from perfbench.reference.common import Leaf, fan_in, mm, rmsnorm, silu

Path = Tuple[str, ...]
_MAMBA = ("ln", "w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B",
          "conv_C", "conv_x_b", "conv_B_b", "conv_C_b", "A_log", "D",
          "dt_bias", "norm", "w_out")

HEAD_LEAVES = dense.HEAD_LEAVES
embed = dense.embed
head_hidden = dense.head_hidden


def _dims(c: Dict) -> Tuple[int, int, int, int, int]:
    din = c["ssm_expand"] * c["d_model"]
    return din, c["ssm_state"], din // c["ssm_head_dim"], \
        c["ssm_head_dim"], c["ssm_conv"]


def leaf_specs(c: Dict) -> Dict[Path, Leaf]:
    L, d, f, V = c["num_layers"], c["d_model"], c["d_ff"], c["vocab_size"]
    din, N, H, _, W = _dims(c)
    qd = c["num_heads"] * c["head_dim"]
    kvd = c["num_kv_heads"] * c["head_dim"]
    f32 = torch.float32
    b = ("blocks",)
    s = ("shared_attn",)
    return {
        ("embed", "tok"): Leaf((V, d)),
        ("embed", "lm_head"): Leaf((V, d), scale=fan_in(d)),
        b + ("ln",): Leaf((L, d), init="ones"),
        b + ("w_z",): Leaf((L, d, din), scale=fan_in(d)),
        b + ("w_x",): Leaf((L, d, din), scale=fan_in(d)),
        b + ("w_B",): Leaf((L, d, N), scale=fan_in(d)),
        b + ("w_C",): Leaf((L, d, N), scale=fan_in(d)),
        b + ("w_dt",): Leaf((L, d, H), scale=fan_in(d)),
        b + ("conv_x",): Leaf((L, W, din), scale=fan_in(W)),
        b + ("conv_B",): Leaf((L, W, N), scale=fan_in(W)),
        b + ("conv_C",): Leaf((L, W, N), scale=fan_in(W)),
        b + ("conv_x_b",): Leaf((L, din), init="zeros"),
        b + ("conv_B_b",): Leaf((L, N), init="zeros"),
        b + ("conv_C_b",): Leaf((L, N), init="zeros"),
        b + ("A_log",): Leaf((L, H), f32, init="ssm_a"),
        b + ("D",): Leaf((L, H), f32, init="ones"),
        b + ("dt_bias",): Leaf((L, H), f32, init="ssm_dt"),
        b + ("norm",): Leaf((L, din), init="ones"),
        b + ("w_out",): Leaf((L, din, d), scale=fan_in(din)),
        s + ("ln1",): Leaf((d,), init="ones"),
        s + ("attn", "wq"): Leaf((d, qd), scale=fan_in(d)),
        s + ("attn", "wk"): Leaf((d, kvd), scale=fan_in(d)),
        s + ("attn", "wv"): Leaf((d, kvd), scale=fan_in(d)),
        s + ("attn", "wo"): Leaf((qd, d), scale=fan_in(qd)),
        s + ("ln2",): Leaf((d,), init="ones"),
        s + ("mlp", "w_up"): Leaf((d, f), scale=fan_in(d)),
        s + ("mlp", "w_down"): Leaf((f, d), scale=fan_in(f)),
        s + ("mlp", "w_gate"): Leaf((d, f), scale=fan_in(d)),
        ("ln_f",): Leaf((d,), init="ones"),
    }


def n_applications(c: Dict) -> int:
    return c["num_layers"] // c["attn_every"]


def units(c: Dict) -> List[Tuple[str, int]]:
    k, out = c["attn_every"], []
    for g in range(n_applications(c)):
        out += [("mamba", i) for i in range(g * k, (g + 1) * k)]
        out.append(("shared", g))
    return out + [("mamba", i)
                  for i in range(n_applications(c) * k, c["num_layers"])]


def unit_leaves(c: Dict, unit: Tuple[str, int]
                ) -> List[Tuple[Path, Optional[int]]]:
    if unit[0] == "shared":
        return [(p, None) for p in dense.block_paths(("shared_attn",))]
    return [(("blocks", k), unit[1]) for k in _MAMBA]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD recurrence in chunked form, f32, one B / C group, from a
    zero state: x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N)."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    C_ = x.shape[1] // chunk
    xc = x.reshape(B_, C_, chunk, H, P)
    dtc = dt.reshape(B_, C_, chunk, H)
    Bc = Bm.reshape(B_, C_, chunk, N)
    Cc = Cm.reshape(B_, C_, chunk, N)
    dA = dtc * A
    dA_cs = torch.cumsum(dA, dim=2)
    Lm = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))          # (B,C,H,Q,Q)
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)[:, :, None]  # (B,C,1,Q,Q)
    y = torch.einsum("bchls,bcsh,bcshp->bclhp", CB * Lm, dtc, xc)
    decay = torch.exp(dA_cs[:, :, -1:] - dA_cs)               # (B,C,Q,H)
    states = torch.einsum("bcsn,bcsh,bcsh,bcshp->bchpn", Bc, decay, dtc, xc)
    chunk_decay = torch.exp(dA.sum(dim=2))                    # (B,C,H)
    h = torch.zeros((B_, H, P, N), dtype=x.dtype, device=x.device)
    prev = []
    for i in range(C_):
        prev.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    prev = torch.stack(prev, dim=1)                           # (B,C,H,P,N)
    y = y + torch.einsum("bcln,bclh,bchpn->bclhp", Cc, torch.exp(dA_cs),
                         prev)
    return y.reshape(B_, C_ * chunk, H, P)[:, :S]


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution: x (B, S, C), w (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return silu(sum(xp[:, j:j + S] * w[j] for j in range(W)) + b)


def mamba_block(c: Dict, w: Dict[Path, torch.Tensor], x: torch.Tensor,
                mode: str) -> torch.Tensor:
    B, S, _ = x.shape
    din, N, H, P, _ = _dims(c)
    g = lambda k: w[("blocks", k)]  # noqa: E731
    h = rmsnorm(x, g("ln"), c["norm_eps"])
    z = mm(h, g("w_z"), mode)
    xs = _conv(mm(h, g("w_x"), mode), g("conv_x"), g("conv_x_b"))
    Bm = _conv(mm(h, g("w_B"), mode), g("conv_B"), g("conv_B_b"))
    Cm = _conv(mm(h, g("w_C"), mode), g("conv_C"), g("conv_C_b"))
    dt = F.softplus(mm(h, g("w_dt"), mode) + g("dt_bias"))
    xh = xs.reshape(B, S, H, P)
    y = ssd(xh, dt, -torch.exp(g("A_log")), Bm, Cm, c["ssm_chunk"])
    y = (y + xh * g("D")[:, None]).reshape(B, S, din) * silu(z)
    return x + mm(rmsnorm(y, g("norm"), c["norm_eps"]), g("w_out"), mode)


def unit_forward(c: Dict, unit: Tuple[str, int], w: Dict[Path, torch.Tensor],
                 x: torch.Tensor, mode: str) -> torch.Tensor:
    if unit[0] == "shared":
        return dense.attn_mlp_block(c, w, ("shared_attn",), x, mode)
    return mamba_block(c, w, x, mode)


def ssd_shape(c: Dict, B: int, S: int) -> Dict:
    din, N, H, P, _ = _dims(c)
    return dict(B=B, S=S, H=H, P=P, G=1, N=N, chunk=c["ssm_chunk"])


def forward_flops(c: Dict, B: int, S: int, ops) -> float:
    """Model FLOPs of one forward over (B, S) tokens: 2 a token and
    weight of every product (the shared block's once an application,
    the depthwise convolutions' 2 a tap), the shared block's attention
    over the visible causal pairs, and the SSD scan's counted work."""
    d, f, V = c["d_model"], c["d_ff"], c["vocab_size"]
    din, N, H, P, W = _dims(c)
    qd = c["num_heads"] * c["head_dim"]
    kvd = c["num_kv_heads"] * c["head_dim"]
    mamba = d * (2 * din + 2 * N + H) + din * d + W * (din + 2 * N)
    shared = 2 * d * qd + 2 * d * kvd + 3 * d * f
    n_app = n_applications(c)
    mats = c["num_layers"] * mamba + n_app * shared + V * d
    attn = ops["flash_fwd"].work(B=B, Sq=S, Sk=S, Hq=c["num_heads"],
                                 Hkv=c["num_kv_heads"], D=c["head_dim"])[0]
    scan = ops["ssd_fwd"].work(**ssd_shape(c, B, S))[0]
    return 2.0 * mats * B * S + n_app * attn + c["num_layers"] * scan


def kernel_calls(c: Dict, kind: str, B: int, S: int,
                 max_len: int = 0) -> List[Tuple[str, Dict]]:
    """The attention and SSD work one step needs, counted once (a
    training step: a forward and a backward of each; a prefill: a
    forward of each)."""
    a = dict(B=B, Sq=S, Hq=c["num_heads"], Hkv=c["num_kv_heads"],
             D=c["head_dim"])
    scan = ssd_shape(c, B, S)
    n_app, L = n_applications(c), c["num_layers"]
    if kind == "train":
        return (n_app * [("flash_fwd", dict(a, Sk=S, lse=True)),
                         ("flash_bwd", dict(a, Sk=S))]
                + L * [("ssd_fwd", scan), ("ssd_bwd", scan)])
    return (n_app * [("flash_fwd", dict(a, Sk=max_len, kv_len=S))]
            + L * [("ssd_fwd", scan)])
