"""Plain PyTorch versions of the ported kernels, forward and backward.

They follow ``repro/kernels/ref.py`` (and the custom VJPs there) op for op
and are the oracles the hand-written CUDA kernels are held against:
nothing here calls ``F.scaled_dot_product_attention``,
``F.cross_entropy`` or any other fused library operator.  On a CPU
tensor the kernel wrappers and autograd Functions run these.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Row RMSNorm over the last axis: f32 math, output in x's dtype."""
    return rmsnorm_fwd_ref(x, w, eps)[0]


def rmsnorm_fwd_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_rmsnorm_fwd_math``: (y in x's dtype, per-row f32 ``inv`` of
    shape ``x.shape[:-1]``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = xf * inv * w.float()
    return y.to(x.dtype), inv[..., 0]


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                    g: torch.Tensor, *,
                    compute_dtype: torch.dtype = torch.float32,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_rmsnorm_vjp_bwd``: (dx in x's dtype, dw in w's dtype) from the
    saved x, w, per-row ``inv`` and the cotangent g, in f32.
    ``compute_dtype`` float64 evaluates the same formula in f64 (a
    yardstick for the f32 versions' dw, a sum over every row) and still
    rounds the results as above."""
    xf, gf, wf, inv = (t.to(compute_dtype) for t in (x, g, w, inv))
    xhat = xf * inv[..., None]
    gw = gf * wf
    dx = inv[..., None] * (gw - xhat * (gw * xhat).mean(dim=-1,
                                                        keepdim=True))
    dw = (gf * xhat).sum(dim=tuple(range(x.dim() - 1)))
    return dx.to(x.dtype), dw.to(w.dtype)


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


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pads axis 1 of a (B, S, H, D) tensor by ``pad`` rows."""
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


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
    return flash_attention_fwd_ref(
        q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
        sliding_window=sliding_window, block_k=block_k, scale=scale)[0]


def flash_attention_fwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, q_offset: int = 0, kv_len: Optional[int] = None,
    sliding_window: int = 0, block_k: int = 512,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_flash_fwd_inner``: (out in q's dtype, f32 ``lse = m + log(max(l,
    1e-30))`` of shape (B, Sq, Hq))."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % max(Hkv, 1):
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    block_k = min(block_k, max(Sk, 1))
    pad = (-Sk) % block_k
    kf, vf = _pad_rows(k.float(), pad), _pad_rows(v.float(), pad)
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
    lse = (m + torch.log(l)).reshape(B, Sq, Hq)
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
    q_offset: int = 0, kv_len: Optional[int] = None,
    sliding_window: int = 0, block_k: int = 512,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_flash_bwd_inner``: p recomputed per KV block from ``lse``,
    ``delta = rowsum(dout * out)``; dk and dv summed over the G q heads of
    each kv head.  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    block_k = min(block_k, max(Sk, 1))
    pad = (-Sk) % block_k
    kf, vf = _pad_rows(k.float(), pad), _pad_rows(v.float(), pad)
    n_blocks = kf.shape[1] // block_k

    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    dof = dout.float().reshape(B, Sq, Hkv, G, D)
    of = out.float().reshape(B, Sq, Hkv, G, D)
    delta = (dof * of).sum(dim=-1)  # (B, Sq, Hkv, G)
    lse = lse.reshape(B, Sq, Hkv, G)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    valid_len = Sk if kv_len is None else kv_len

    dq = torch.zeros((B, Sq, Hkv, G, D), device=q.device)
    dks, dvs = [], []
    for j in range(n_blocks):
        kb = kf[:, j * block_k:(j + 1) * block_k]
        vb = vf[:, j * block_k:(j + 1) * block_k]
        k_pos = j * block_k + torch.arange(block_k, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        mask = attention_mask(q_pos, k_pos, valid_len=valid_len,
                              causal=causal, sliding_window=sliding_window)
        mask = mask[None, :, None, None, :]
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
        dvs.append(torch.einsum("bqhgk,bqhgd->bkhd", p, dof))
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vb)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", ds, kb)
        dks.append(torch.einsum("bqhgk,bqhgd->bkhd", ds, qf))
    dq = (dq * scale).reshape(B, Sq, Hq, D)
    dk = torch.cat(dks, dim=1)[:, :Sk]
    dv = torch.cat(dvs, dim=1)[:, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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



# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality): the chunked scan and its oracles
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q).  (..., Q, Q) with out[..., i, j] = sum_{j<s<=i} x[s]
    for j <= i and -inf above the diagonal (the log of the decay matrix
    L)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_ref(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)   (post-softplus, positive)
    A: torch.Tensor,   # (H,)        (negative)
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    return_state: bool = False,
):
    """Chunked SSD: y[t] = C[t] . h[t], h[t] = exp(dt[t] A) h[t-1] +
    dt[t] B[t] x[t], in f32, y in x's dtype; with ``return_state`` also
    the f32 (B, H, P, N) state after the last token.  Heads map to the G
    B/C groups as h // (H / G).  The tail is zero-padded to a whole chunk
    (dt = 0 there: decay 1, no injection)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    assert H % G == 0
    HG = H // G
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Sp = x.shape[1]
    C_ = Sp // chunk

    xc = x.float().reshape(B_, C_, chunk, H, P)
    dtc = dt.float().reshape(B_, C_, chunk, H)
    Bc = Bm.float().reshape(B_, C_, chunk, G, N)
    Cc = Cm.float().reshape(B_, C_, chunk, G, N)
    Af = A.float()

    dA = dtc * Af[None, None, None, :]            # (B, C, Q, H)
    dA_cs = torch.cumsum(dA, dim=2)               # cumulative within chunk

    # intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (B, C, H, Q, Q)
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)  # (B, C, G, Q, Q)
    CB = torch.repeat_interleave(CB, HG, dim=2)      # (B, C, H, Q, Q)
    M = CB * L
    y_intra = torch.einsum("bchls,bcsh,bcshp->bclhp", M, dtc, xc)

    # chunk states
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (B, C, Q, H)
    Br = torch.repeat_interleave(Bc, HG, dim=3)            # (B, C, Q, H, N)
    states = torch.einsum("bcshn,bcsh,bcsh,bcshp->bchpn",
                          Br, decay_to_end, dtc, xc)

    # inter-chunk recurrence (lax.scan in the JAX version)
    chunk_decay = torch.exp(dA.sum(dim=2))  # (B, C, H)
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_prev = []
    for c in range(C_):
        h_prev.append(h)  # the state BEFORE chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B, C, H, P, N)

    # inter-chunk output
    in_decay = torch.exp(dA_cs)                    # (B, C, Q, H)
    Cr = torch.repeat_interleave(Cc, HG, dim=3)    # (B, C, Q, H, N)
    y_inter = torch.einsum("bclhn,bclh,bchpn->bclhp", Cr, in_decay, h_prev)

    y = (y_intra + y_inter).reshape(B_, Sp, H, P)[:, :S].to(x.dtype)
    if return_state:
        return y, h
    return y


def ssd_bwd_ref(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,   # (H,)
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    dy: torch.Tensor,  # (B, S, H, P), the cotangent of y
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    d_state: Optional[torch.Tensor] = None,     # (B, H, P, N)
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`ssd_ref`, chunk by chunk in f32, from the
    formulas below (the JAX package autodiffs ``ssd_ref``; the tests hold
    this against ``jax.vjp``).  ``d_state`` is the cotangent of the final
    state (None: zero).  Returns (dx, ddt, dA, dB, dC, d_init): dx, dB and
    dC rounded once to the inputs' dtypes, the rest f32; d_init is the
    cotangent of the initial state (zeros or not).  ``compute_dtype``
    float64 evaluates the same formulas in f64 (a yardstick for the f32
    versions at large shapes) and still rounds the results as above.

    In a chunk of Q tokens, with cs the inclusive cumsum of a = dt A, H_c
    the state before the chunk, Ĥ the cotangent of the state after it,
    L_ij = exp(cs_i - cs_j) (j <= i), ȳ = dy and e_j = exp(cs_Q - cs_j):

      Ĥ_c   = exp(cs_Q) Ĥ + sum_i exp(cs_i) ȳ_i C_iᵀ;   d_init = Ĥ_0
      dx_j  = dt_j [sum_i (C_i.B_j) L_ij ȳ_i + e_j Ĥ B_j]
      dC_i  = sum_j (ȳ_i.x_j) L_ij dt_j B_j + exp(cs_i) H_cᵀ ȳ_i
      dB_j  = dt_j [sum_i (ȳ_i.x_j) L_ij C_i + e_j Ĥᵀ x_j]  (over the
              heads of the group)
      ddt_j = sum_i (ȳ_i.x_j)(C_i.B_j) L_ij + e_j x_jᵀ Ĥ B_j + A dā_j
      dā_s  = sum_{k >= s} dcs_k,  dA = sum dt_s dā_s

    with dcs_k = sum_j s_kj - sum_i s_ik + t_k - u_k + [k = Q](sum_j u_j
    + w), s_ij = (ȳ_i.x_j)(C_i.B_j) L_ij dt_j, t_k = exp(cs_k) ȳ_kᵀ H_c
    C_k, u_j = e_j dt_j x_jᵀ Ĥ B_j and w = exp(cs_Q) <Ĥ, H_c>."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    HG = H // G
    pad = (-S) % chunk
    if pad:
        x, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    C_ = x.shape[1] // chunk
    shp, cd = (B_, C_, chunk), compute_dtype
    xc = x.to(cd).reshape(*shp, H, P)
    dyc = dy.to(cd).reshape(*shp, H, P)
    dtc = dt.to(cd).reshape(*shp, H)
    Br = torch.repeat_interleave(Bm.to(cd).reshape(*shp, G, N), HG, dim=3)
    Cr = torch.repeat_interleave(Cm.to(cd).reshape(*shp, G, N), HG, dim=3)
    Af = A.to(cd)

    cs = torch.cumsum(dtc * Af, dim=2)             # (B, C, Q, H)
    cs_end = cs[:, :, -1]                          # (B, C, H)
    ecs = torch.exp(cs)
    e = torch.exp(cs_end[:, :, None] - cs)         # exp(cs_Q - cs_j)

    # the states before each chunk, and the cotangents after each chunk
    inject = torch.einsum("bcshn,bcsh,bcshp->bchpn", Br, e * dtc, xc)
    back = torch.einsum("bcshn,bcsh,bcshp->bchpn", Cr, ecs, dyc)
    decay = torch.exp(cs_end)[..., None, None]     # (B, C, H, 1, 1)
    h = (torch.zeros((B_, H, P, N), dtype=cd, device=x.device)
         if init_state is None else init_state.to(cd))
    hs = []
    for c in range(C_):
        hs.append(h)
        h = h * decay[:, c] + inject[:, c]
    g = (torch.zeros((B_, H, P, N), dtype=cd, device=x.device)
         if d_state is None else d_state.to(cd))
    gs = [None] * C_
    for c in reversed(range(C_)):
        gs[c] = g
        g = g * decay[:, c] + back[:, c]
    Hc, Hn = torch.stack(hs, dim=1), torch.stack(gs, dim=1)  # (B,C,H,P,N)

    # the decay-weighted (i, j) products, j <= i
    seg = _segsum((dtc * Af).permute(0, 1, 3, 2))  # (B, C, H, Q, Q)
    L = torch.exp(seg)
    CB = torch.einsum("bcihn,bcjhn->bchij", Cr, Br) * L
    YX_raw = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    YX = YX_raw * L
    sL = CB * YX_raw                                # s_ij / dt_j
    s = sL * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]

    V = torch.einsum("bcjhn,bchpn->bcjhp", Br, Hn)  # Ĥ B_j
    xV = (xc * V).sum(-1)                           # x_jᵀ Ĥ B_j
    dx = dtc[..., None] * (torch.einsum("bchij,bcihp->bcjhp", CB, dyc)
                           + e[..., None] * V)
    dC_inter = ecs[..., None] * torch.einsum("bcihp,bchpn->bcihn", dyc, Hc)
    dC = torch.einsum("bchij,bcjh,bcjhn->bcihn", YX, dtc, Br) + dC_inter
    dB = dtc[..., None] * (
        torch.einsum("bchij,bcihn->bcjhn", YX, Cr)
        + e[..., None] * torch.einsum("bcjhp,bchpn->bcjhn", xc, Hn))

    t = (Cr * dC_inter).sum(-1)                     # (B, C, Q, H)
    u = e * dtc * xV
    w = torch.exp(cs_end) * (Hn * Hc).sum((-1, -2))  # (B, C, H)
    dcs = (s.sum(-1) - s.sum(-2)).permute(0, 1, 3, 2) + t - u
    dcs[:, :, -1] += u.sum(2) + w
    da = torch.flip(torch.cumsum(torch.flip(dcs, [2]), dim=2), [2])
    ddt = sL.sum(-2).permute(0, 1, 3, 2) + e * xV + Af * da
    dA = (dtc * da).sum((0, 1, 2))

    def out(t, dtype, n):  # (B, C, Q, ..) -> (B, S, ..) in dtype
        return t.reshape(B_, C_ * chunk, *n)[:, :S].to(dtype)

    return (out(dx, x.dtype, (H, P)), out(ddt, torch.float32, (H,)),
            dA.float(), out(dB.reshape(*shp, G, HG, N).sum(4), Bm.dtype,
                            (G, N)),
            out(dC.reshape(*shp, G, HG, N).sum(4), Cm.dtype, (G, N)),
            g.float())


def ssd_decode_ref(
    x: torch.Tensor,   # (B, H, P)  one token
    dt: torch.Tensor,  # (B, H)
    A: torch.Tensor,   # (H,)
    Bm: torch.Tensor,  # (B, G, N)
    Cm: torch.Tensor,  # (B, G, N)
    h: torch.Tensor,   # (B, H, P, N) state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the SSD recurrence: (y in x's dtype, new f32
    state)."""
    H = x.shape[1]
    HG = H // Bm.shape[1]
    dtf = dt.float()
    dA = torch.exp(dtf * A.float()[None, :])  # (B, H)
    Br = torch.repeat_interleave(Bm.float(), HG, dim=1)  # (B, H, N)
    Cr = torch.repeat_interleave(Cm.float(), HG, dim=1)
    h_new = h * dA[:, :, None, None] + (
        dtf[:, :, None, None] * x.float()[:, :, :, None]
        * Br[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h_new, Cr)
    return y.to(x.dtype), h_new


def ssd_sequential_ref(x, dt, A, Bm, Cm, *, init_state=None):
    """Token-by-token recurrence — oracle for ssd_ref (small shapes)."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        y, h = ssd_decode_ref(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), h


def _masked_mean_bool(nll: torch.Tensor,
                      valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return nll.mean()
    nll = torch.where(valid.bool(), nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp(valid.sum().float(), min=1.0)


def cross_entropy_partial_ref(hidden: torch.Tensor, w_vocab: torch.Tensor,
                              targets: torch.Tensor, *, block_v: int = 2048
                              ) -> torch.Tensor:
    """Per-token f32 (m, l, target logit), (T, 3), over vocab blocks with
    online statistics: the plain version of the CE kernel on one vocab
    shard (``cross_entropy_stats_cuda``).  A target outside [0, V) adds
    nothing (it lies in another shard).  Inputs are read in their own
    dtype and multiplied in f32, which is exact for bf16 inputs, as a bf16
    product with f32 accumulation is."""
    T, D = hidden.shape
    V = w_vocab.shape[0]
    block_v = min(block_v, V)
    hf = hidden.float()
    m = torch.full((T,), NEG_INF, device=hidden.device)
    l = torch.zeros((T,), device=hidden.device)
    tgt = torch.zeros((T,), device=hidden.device)
    for v0 in range(0, V, block_v):
        logits = hf @ w_vocab[v0:v0 + block_v].float().t()  # (T, <=bv)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        hit = (targets >= v0) & (targets < v0 + logits.shape[1])
        idx = (targets - v0).clamp(0, logits.shape[1] - 1)
        tgt = tgt + torch.where(
            hit, logits.gather(1, idx[:, None].long())[:, 0],
            torch.zeros_like(tgt))
    return torch.stack([m, l, tgt], dim=-1)


def ce_merge_ref(parts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merges n shards' (m, l, target logit) triples, (n, T, 3), in shard
    order, as ``ce_merge_kernel`` does -> per-token f32 (nll, lse)."""
    m, l, tgt = parts.unbind(dim=-1)
    M = m.amax(dim=0)
    L = (l * torch.exp(m - M)).sum(dim=0)
    lse = M + torch.log(torch.clamp(L, min=1e-30))
    return lse - tgt.sum(dim=0), lse


def cross_entropy_stats_ref(hidden: torch.Tensor, w_vocab: torch.Tensor,
                            targets: torch.Tensor, *, block_v: int = 2048
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token f32 (nll, lse) over vocab blocks with online (max,
    sumexp, target logit) statistics: the plain version of the CE kernel
    (``_ce_kernel`` and ``train/loss.py::_ce_fwd_stats``); a target
    outside [0, V) adds nothing, as in the kernel."""
    return ce_merge_ref(cross_entropy_partial_ref(
        hidden, w_vocab, targets, block_v=block_v)[None])


def cross_entropy_direct_ref(hidden: torch.Tensor, w_vocab: torch.Tensor,
                             targets: torch.Tensor,
                             valid: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Mean NLL from the whole (T, V) f32 logit matrix (small shapes)."""
    logits = hidden.float() @ w_vocab.float().t()
    m = logits.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(logits - m).sum(dim=-1,
                                                    keepdim=True)))[:, 0]
    tgt = logits.gather(1, targets[:, None].long())[:, 0]
    return _masked_mean_bool(lse - tgt, valid)


def cross_entropy_blockwise_ref(hidden: torch.Tensor, w_vocab: torch.Tensor,
                                targets: torch.Tensor,
                                valid: Optional[torch.Tensor] = None, *,
                                block_v: int = 2048) -> torch.Tensor:
    """Mean NLL from the vocab-blockwise statistics."""
    nll, _ = cross_entropy_stats_ref(hidden, w_vocab, targets,
                                     block_v=block_v)
    return _masked_mean_bool(nll, valid)
