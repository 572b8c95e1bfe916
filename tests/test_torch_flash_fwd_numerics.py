"""The bf16 flash-attention forward's rounding, emulated on the CPU.

The tensor-core forward (``csrc/flash_attention.cu``,
``flash_fwd_tc_kernel``) computes S = Q K^T from bf16 operands with f32
sums, scales S in f32 by scale * log2(e), and runs the online softmax
per 64-key step in f32 with exp2: running max m, row sum l of the f32
P, and O = O * alpha + P V, where P is rounded to bf16 as the A operand
of P V (f32 sums).  The output is O / max(l, 1e-30) and lse = m * ln 2 +
log(max(l, 1e-30)).  The f32-FMA kernel it replaced never rounded P.
This test repeats that arithmetic and holds it against the plain f32
forward (``ref.flash_attention_fwd_ref``, output rounded to bf16 as the
kernel's is) at one kv head of the yi-6b training shape and one head of
the zamba2-1.2b prefill shape, at the tolerances the card holds the
kernel to: 2e-2 + 2e-2 * |ref| for the output (``chip_smoke.py``) and
3e-5 + 3e-5 * |ref| for lse (``tests/test_torch_cuda.py``).  So the
precision design can pass the card's checks before any card runs it.
``pytest -s`` prints the largest errors.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

TOL = 2e-2      # chip_smoke.py's bf16 tolerance, absolute and relative
LSE_TOL = 3e-5  # the card tests' lse tolerance, absolute and relative
STEP = 64       # keys of one step of the kernel
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30


def _emulated_fwd(q, k, v, *, causal, kv_len):
    """(out in bf16, f32 lse) as the tensor-core kernel rounds them.
    q: (B, Sq, Hq, D), k, v: (B, Sk, Hkv, D), bf16; q_offset 0."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    f32 = torch.float32
    # scale and log2(e) as f32 constants, their product rounded to f32
    sl2 = torch.tensor(D ** -0.5, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    mask_log2 = torch.tensor(NEG_INF, dtype=f32) * torch.tensor(LOG2E,
                                                                dtype=f32)
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(Sq)
    m = torch.full((B, Sq, Hkv, G), float(mask_log2))
    l = torch.zeros((B, Sq, Hkv, G))
    acc = torch.zeros((B, Sq, Hkv, G, D))
    for k0 in range(0, kv_len, STEP):
        kb, vb = kf[:, k0:k0 + STEP], vf[:, k0:k0 + STEP]
        k_pos = k0 + torch.arange(kb.shape[1])
        x = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb) * sl2
        mask = ref.attention_mask(q_pos, k_pos, valid_len=kv_len,
                                  causal=causal, sliding_window=0)
        x = torch.where(mask[None, :, None, None, :], x, mask_log2)
        mx = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.bfloat16().float(), vb)
        m = mx
    den = torch.clamp(l, min=1e-30)
    out = (acc / den[..., None]).reshape(B, Sq, Hq, D).bfloat16()
    lse = (m * LN2 + torch.log(den)).reshape(B, Sq, Hq)
    return out, lse


def _excess(got, want, tol):
    """Largest error and largest excess over tol + tol * |want|."""
    err = (got.float() - want.float()).abs()
    return float(err.max()), float((err - tol - tol * want.float().abs())
                                   .max())


@pytest.mark.parametrize("shape", [
    # B, Sq, Sk, Hq, Hkv, D, kv_len: one kv head of the yi-6b training
    # shape; one head of the zamba2-1.2b prefill over its 2088-row cache
    (1, 512, 512, 8, 1, 128, 512),
    (1, 2048, 2088, 1, 1, 64, 2048),
], ids=["yi6b_train", "zamba2_prefill"])
def test_bf16_p_rounding_meets_card_tolerance(shape):
    B, Sq, Sk, Hq, Hkv, D, kv_len = shape
    rng = np.random.default_rng(15)
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hq, D),
                                             dtype=np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, Hkv, D),
                                                 dtype=np.float32))
            .bfloat16() for _ in range(2))
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=True,
                                                 kv_len=kv_len)
    got, got_lse = _emulated_fwd(q, k, v, causal=True, kv_len=kv_len)
    assert got.shape == want.shape and got.dtype == want.dtype
    err, excess = _excess(got, want, TOL)
    lse_err, lse_excess = _excess(got_lse, want_lse, LSE_TOL)
    print(f"{shape}: out max err {err:.6g}, lse max err {lse_err:.6g}")
    assert excess <= 0, f"out: max err {err}, worst excess {excess}"
    assert lse_excess <= 0, f"lse: max err {lse_err}, worst excess " \
                            f"{lse_excess}"
    # the rounding is really there: P in bf16 moves the output
    assert not torch.equal(got, want)
