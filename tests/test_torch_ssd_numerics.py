"""The bf16 SSD chunked scan's rounding, emulated on the CPU.

The tensor-core scan (``csrc/ssd_scan.cu``, ``ssd_scan_tc_kernel``) walks
the chunks of each (batch, head) in order and, per chunk of Q tokens with
cs the f32 cumsum of dt * A (taken in log2 units, exp by exp2):

- S = C Bᵀ from bf16 C and B with f32 sums;
- M = S * 2^(cs2_i - cs2_j) * dt_j for j <= i, split into hi = bf16(M)
  and lo = bf16(M - hi), as the A operands of y_intra = M_hi x + M_lo x
  (f32 sums);
- y_inter = (C hᵀ) * 2^(cs2_i), with the f32 state h split into hi + lo
  bf16 copies as B operands likewise;
- y = y_inter + y_intra, rounded to bf16;
- h = 2^(cs2_end) h + (x * w)ᵀ B with w = dt * 2^(cs2_end - cs2), x * w
  split into hi + lo bf16 A operands likewise; h itself stays f32.

The f32-FMA kernel it replaced rounded only y.  This test repeats that
arithmetic and holds y and the final state against the plain f32 scan
(``ref.ssd_ref``, y rounded to bf16 as the kernel's is) at the tolerance
the card holds the kernel to, 3e-2 + 3e-2 * |ref| (``chip_smoke.py``):
on four heads of the zamba2-1.2b and mamba2-130m prefill shapes (S =
2048, chunk 128) with ``chip_smoke.py``'s input recipe, and on its
two-call ``init_state`` chain.  Beside the kernel's design it emulates
the first one, which rounded M, x * w and the state's copy once each (w
folded into x or into B): that passes the elementwise tolerance too, but
its M rounding moves y (before y's own rounding) by as much as y's
rounding does, which on the card failed the models' end-to-end check
against the plain path, and its state copy moves y by ~1e-3 at the
first token of each chunk, where decode against a longer prefill
compares.  ``pytest -s`` prints the largest errors.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

TOL = 3e-2  # chip_smoke.py's bf16 SSD tolerance, absolute and relative
LOG2E = 1.4426950408889634


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _split(t: torch.Tensor) -> torch.Tensor:
    """hi + lo, each rounded to bf16 (the kernel's two products)."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _emulated_ssd(x, dt, A, Bm, Cm, *, chunk, init_state=None,
                  design="split"):
    """(f32 y before its bf16 rounding, f32 state) as the tensor-core
    kernel computes them.  ``design``: "split" (the kernel: M, x * w and
    the state's copy as hi + lo bf16), "single_x" / "single_B" (each
    rounded once, w folded into x or into B) or "exact" (no rounding but
    the operands').  x:
    (B, S, H, P), Bm, Cm: (B, S, G, N) bf16; dt: (B, S, H), A: (H,)
    f32."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rnd = (lambda t: t) if design == "exact" else _bf16
    rnd = _split if design == "split" else rnd
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    xf = x.float()
    Bf = Bm.float().repeat_interleave(H // G, dim=2)  # (B, S, H, N)
    Cf = Cm.float().repeat_interleave(H // G, dim=2)
    h = (torch.zeros((B_, H, P, N)) if init_state is None
         else init_state.float().clone())
    ys = []
    for t0 in range(0, S, chunk):
        xc, bc, cc = (t[:, t0:t0 + chunk] for t in (xf, Bf, Cf))
        dtc = dt[:, t0:t0 + chunk].float()
        Q = xc.shape[1]
        cs = torch.cumsum(dtc * A.float(), dim=1)  # (B, Q, H)
        cs2 = cs * log2e
        end2 = cs2[:, -1]  # (B, H)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", cc, rnd(h)) \
            * torch.exp2(cs2)[..., None]
        s = torch.einsum("bihn,bjhn->bhij", cc, bc)
        c2 = cs2.permute(0, 2, 1)  # (B, H, Q)
        causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
        diff = (c2[..., :, None] - c2[..., None, :]).masked_fill(
            ~causal, float("-inf"))
        m = s * torch.exp2(diff) * dtc.permute(0, 2, 1)[..., None, :]
        y_intra = torch.einsum("bhij,bjhp->bihp", rnd(m), xc)
        ys.append(y_inter + y_intra)
        w = dtc * torch.exp2(end2[:, None, :] - cs2)  # (B, Q, H)
        if design == "single_B":
            upd = torch.einsum("bqhp,bqhn->bhpn", xc, rnd(bc * w[..., None]))
        else:
            upd = torch.einsum("bqhp,bqhn->bhpn", rnd(xc * w[..., None]), bc)
        h = h * torch.exp2(end2)[..., None, None] + upd
    return torch.cat(ys, dim=1), h


def _inputs(shape, seed):
    """chip_smoke.py's recipe: x * 0.5, B and C * 0.3 in bf16, softplus dt,
    A = -exp(0.3 randn); numpy-seeded."""
    B_, S, H, P, G, N = shape
    rng = np.random.default_rng(seed)

    def rn(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32))

    return ((rn(B_, S, H, P) * 0.5).bfloat16(), F.softplus(rn(B_, S, H)),
            -torch.exp(rn(H) * 0.3), (rn(B_, S, G, N) * 0.3).bfloat16(),
            (rn(B_, S, G, N) * 0.3).bfloat16())


def _excess(got, want):
    """Largest error and largest excess over TOL + TOL * |want|."""
    err = (got.float() - want.float()).abs()
    return float(err.max()), float((err - TOL - TOL * want.float().abs())
                                   .max())


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("design", ["split", "single_x", "single_B"])
@pytest.mark.parametrize("shape", [
    # B, S, H, P, G, N: four heads of the zamba2-1.2b and mamba2-130m
    # prefill shapes (chunk 128) and one token more, as the decode check's
    # longer prefill
    (1, 2049, 4, 64, 1, 64),
    (1, 2049, 4, 64, 1, 128),
], ids=["zamba2_prefill", "mamba2_prefill"])
def test_bf16_ssd_rounding_meets_card_tolerance(shape, design):
    x, dt, A, Bm, Cm = _inputs(shape, 16)
    want_y, want_h = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=128,
                                 return_state=True)
    # the plain scan in f32 throughout: y before its rounding
    want_y32 = ref.ssd_ref(x.float(), dt, A, Bm.float(), Cm.float(),
                           chunk=128)
    y32, got_h = _emulated_ssd(x, dt, A, Bm, Cm, chunk=128, design=design)
    got_y = y32.bfloat16()
    first = list(range(128, shape[1], 128))  # the first token of chunks
    assert got_y.shape == want_y.shape and got_y.dtype == want_y.dtype
    err_y, excess_y = _excess(got_y, want_y)
    err_h, excess_h = _excess(got_h, want_h)
    rel_y, rel_h = _rel_l2(y32, want_y32), _rel_l2(got_h, want_h)
    rel_first = _rel_l2(y32[:, first], want_y32[:, first])
    rel_round = _rel_l2(want_y, want_y32)  # y's own bf16 rounding
    print(f"{shape} {design}: y max err {err_y:.6g} (|ref| max "
          f"{float(want_y.float().abs().max()):.4g}), state max err "
          f"{err_h:.6g}; rel L2 before y's rounding {rel_y:.3g} (y's "
          f"rounding {rel_round:.3g}; first tokens of chunks "
          f"{rel_first:.3g}), state {rel_h:.3g}")
    assert excess_y <= 0, f"y: max err {err_y}, worst excess {excess_y}"
    assert excess_h <= 0, f"state: max err {err_h}, worst excess {excess_h}"
    exact_y32, exact_h = _emulated_ssd(x, dt, A, Bm, Cm, chunk=128,
                                       design="exact")
    # the roundings are really there: they move the state
    assert not torch.equal(got_h, exact_h)
    if design == "split":
        # y's own rounding stays the largest error, at the first tokens of
        # chunks too, and the state keeps about 16 bits
        assert rel_y <= 0.25 * rel_round, (rel_y, rel_round)
        assert rel_first <= 0.05 * rel_round, (rel_first, rel_round)
        assert rel_h <= 1e-4, rel_h
    else:
        # one rounding of M moves y as much as y's rounding does
        assert rel_y >= 0.5 * rel_round, (rel_y, rel_round)


def test_bf16_ssd_rounding_init_state_chain():
    """chip_smoke.py's chain: (2, 300, 8, 64, 1, 64), chunk 128, two calls
    cut at 137 through the state, against one plain call over the whole
    from the same initial state."""
    shape, cut = (2, 300, 8, 64, 1, 64), 137
    x, dt, A, Bm, Cm = _inputs(shape, 17)
    rng = np.random.default_rng(18)
    h0 = torch.from_numpy(rng.standard_normal((2, 8, 64, 64),
                                              dtype=np.float32)) * 0.1
    want_y, want_h = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=128,
                                 init_state=h0, return_state=True)
    y1, h1 = _emulated_ssd(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                           Cm[:, :cut], chunk=128, init_state=h0)
    y2, h2 = _emulated_ssd(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                           Cm[:, cut:], chunk=128, init_state=h1)
    err_y, excess_y = _excess(torch.cat([y1, y2], 1).bfloat16(), want_y)
    err_h, excess_h = _excess(h2, want_h)
    print(f"init_state chain: y max err {err_y:.6g}, state max err "
          f"{err_h:.6g}")
    assert excess_y <= 0, f"y: max err {err_y}, worst excess {excess_y}"
    assert excess_h <= 0, f"state: max err {err_h}, worst excess {excess_h}"
