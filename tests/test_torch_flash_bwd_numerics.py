"""The bf16 flash-attention backward's rounding, emulated on the CPU.

The tensor-core backward (``csrc/flash_attention.cu``) computes S and dP
from bf16 operands with f32 sums, forms P = exp(S * scale - lse) and
dS = P * (dP - delta) in f32, and rounds P and dS to bf16 only as the A
operands of dV = P^T dO, dK = dS^T Q and dQ = dS K (f32 sums, scale
applied to dK and dQ in f32 at the end).  The f32-FMA kernel it replaced
never rounded P or dS.  This test repeats that arithmetic on top of
``ref.flash_attention_bwd_ref``'s math, at one kv head of the yi-6b
training shape, and holds it against the plain f32 backward at the
tolerance ``chip_smoke.py`` holds the card's bf16 rows to (2e-2 +
2e-2 * |ref|): the precision design can pass the card's check before any
card runs it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

TOL = 2e-2  # chip_smoke.py's bf16 tolerance, absolute and relative


def _emulated_bwd(q, k, v, o, lse, dout, *, causal, window):
    """(dq, dk, dv) in bf16 with P and dS rounded to bf16 where the kernel
    rounds them.  q, dout: (B, S, Hq, D); k, v: (B, S, Hkv, D), bf16."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, dout))
    kf = kf.repeat_interleave(G, dim=2)
    vf = vf.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    pos = torch.arange(S)
    mask = ref.attention_mask(pos, pos, valid_len=S, causal=causal,
                              sliding_window=window)
    p = torch.where(mask, torch.exp(s - lse.permute(0, 2, 1)[..., None]),
                    torch.zeros(()))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kf) * scale
    # the G q heads of a kv head summed in f32 (the partials' sum)
    dk = dk.reshape(B, S, Hkv, G, D).sum(3)
    dv = dv.reshape(B, S, Hkv, G, D).sum(3)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("window", [0, 128])
def test_bf16_p_and_ds_rounding_meets_card_tolerance(window):
    rng = np.random.default_rng(14)
    B, S, Hq, Hkv, D = 1, 512, 8, 1, 128
    q, dout = (torch.from_numpy(rng.standard_normal((B, S, Hq, D),
                                                    dtype=np.float32))
               .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D),
                                                 dtype=np.float32))
            .bfloat16() for _ in range(2))
    kw = dict(causal=True, sliding_window=window)
    o, lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, **kw)
    got = _emulated_bwd(q, k, v, o, lse, dout, causal=True, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        assert bool((err <= TOL + TOL * b.abs()).all()), (
            f"{name}: max err {float(err.max())}, worst excess "
            f"{float((err - TOL * b.abs()).max())}")
    # the rounding is really there: P in bf16 moves dv off the f32 result
    assert not torch.equal(got[2], want[2])
