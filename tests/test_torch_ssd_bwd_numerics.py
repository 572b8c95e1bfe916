"""The bf16 SSD backward's rounding, emulated on the CPU.

The tensor-core backward (``csrc/ssd_scan.cu``: ``ssd_bwd_state_tc_kernel``
forward and reverse, ``ssd_bwd_row_tc_kernel``, ``ssd_bwd_col_tc_kernel``)
follows the formulas of ``ref.ssd_bwd_ref`` chunk by chunk, with cs the
f32 cumsum of dt * A taken in log2 units (exp by exp2).  Its operands:

- the state passes: H (the state before each chunk) and Ĥ (the cotangent
  of the state after it) are f32 and never rounded; their updates take x
  * w (w = dt exp(cs_Q - cs)) and dy * exp(cs) as hi + lo bf16 A
  operands against bf16 B and C (two products into one f32 sum), as the
  forward scan does.  Each chunk's H and Ĥ go to the chunk kernels as hi +
  lo bf16 copies, which are also what w = exp(cs_Q) <Ĥ, H> reads;
- S1 = C Bᵀ and S2 = dy xᵀ (and their transposes B Cᵀ, x dyᵀ) from bf16
  operands with f32 sums, exact;
- M = S2 o L o dt_j (the A operand of dC's sum over j <= i and of dB's
  over i >= j) and S1 o L (dx's) split into hi + lo bf16 A operands;
- the inter-chunk terms dy_i H, Ĥ B_j and Ĥᵀ x_j take the states' hi +
  lo copies as B operands (two products), then the f32 scales exp(cs_i),
  e_j, e_j dt_j;
- dx, and dB and dC after the sum over the heads of a group, rounded to
  bf16 once; ddt, dA and d_init f32.

This test repeats that arithmetic and holds every output against the
plain f32 backward (``ref.ssd_bwd_ref``) at the tolerance the card holds
the kernel to, 3e-2 + 3e-2 * |ref| elementwise and dA at relative L2
3e-2 (``chip_smoke.py``'s phase "ssd_bwd"): on four heads of the
zamba2-1.2b and mamba2-130m training shapes (S = 2048, chunk 128) with
``chip_smoke.py``'s input recipe, without and with an initial state and a
final-state cotangent, and on a G = 2 case.  Beside the chosen plan it
emulates the single roundings it considered and did not take: the Q x Q
tiles (M and S1 o L) rounded once, the states' copies rounded once, and
the state passes' x * w and dy * exp(cs) rounded once.  ``pytest -s``
prints each plan's largest error as a share of the tolerance and the
relative L2 of each output against the exact arithmetic's.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

TOL = 3e-2  # chip_smoke.py's bf16 SSD tolerance, absolute and relative
LOG2E = 1.4426950408889634
NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_init")
PLANS = ("split", "single_M", "single_state", "single_w")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _split(t: torch.Tensor) -> torch.Tensor:
    """hi + lo, each rounded to bf16 (the kernel's two products)."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _rounders(plan: str):
    """(tiles, states, pass operands): how each f32 operand enters the
    tensor cores under ``plan``."""
    if plan == "exact":
        return (lambda t: t,) * 3
    return tuple(_bf16 if plan == f"single_{r}" else _split
                 for r in ("M", "state", "w"))


def _emulated_ssd_bwd(x, dt, A, Bm, Cm, dy, *, chunk, init_state=None,
                      d_state=None, plan="split"):
    """(dx, ddt, dA, dB, dC, d_init) as the tensor-core kernels compute
    them under ``plan`` (see the module's note; "exact" rounds nothing
    but the outputs).  x, dy: (B, S, H, P), Bm, Cm: (B, S, G, N) bf16;
    dt: (B, S, H), A: (H,), init_state, d_state: (B, H, P, N) f32."""
    r_tile, r_state, r_pass = _rounders(plan)
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    HG = H // G
    pad = -S % chunk
    xf, dyf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (x, dy))
    Bf, Cf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(
        HG, dim=2) for t in (Bm, Cm))            # (B, S', H, N)
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    nc, Q = xf.shape[1] // chunk, chunk
    xc, dyc = (t.reshape(B_, nc, Q, H, P) for t in (xf, dyf))
    Bc, Cc = (t.reshape(B_, nc, Q, H, N) for t in (Bf, Cf))
    dtc = dtf.reshape(B_, nc, Q, H)
    Af = A.float()
    cs2 = torch.cumsum(dtc * Af, dim=2) * LOG2E   # (B, nc, Q, H)
    end2 = cs2[:, :, -1]                          # (B, nc, H)
    ecs = torch.exp2(cs2)
    e = torch.exp2(end2[:, :, None] - cs2)        # exp(cs_Q - cs_j)
    decay = torch.exp2(end2)[..., None, None]

    # the state passes: f32 states, the update's A operand as the plan has
    # it, each chunk's state handed on as its copy
    h = (torch.zeros((B_, H, P, N)) if init_state is None
         else init_state.float().clone())
    hs = []
    for c in range(nc):
        hs.append(r_state(h))
        w = dtc[:, c] * e[:, c]                   # (B, Q, H)
        h = h * decay[:, c] + torch.einsum(
            "bqhp,bqhn->bhpn", r_pass(xc[:, c] * w[..., None]), Bc[:, c])
    g = (torch.zeros((B_, H, P, N)) if d_state is None
         else d_state.float().clone())
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = r_state(g)
        g = g * decay[:, c] + torch.einsum(
            "bqhp,bqhn->bhpn", r_pass(dyc[:, c] * ecs[:, c, :, :, None]),
            Cc[:, c])
    d_init = g
    Hc, Hn = torch.stack(hs, 1), torch.stack(gs, 1)  # (B, nc, H, P, N)

    # the chunk kernels: exact Q x Q products, L in f32, j <= i
    S1 = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    S2 = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    c2 = cs2.permute(0, 1, 3, 2)                     # (B, nc, H, Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    diff = (c2[..., :, None] - c2[..., None, :]).masked_fill(
        ~causal, float("-inf"))
    L = torch.exp2(diff)
    dtj = dtc.permute(0, 1, 3, 2)[..., None, :]      # dt_j over columns
    sL = S1 * S2 * L                                 # s_ij / dt_j
    M = r_tile(S2 * L * dtj)                         # dC's and dB's tile
    T1 = r_tile(S1 * L)                              # dx's tile

    # the row kernel: dC, and r_k = rowsum(s) + t - colsum(s)
    dC_inter = ecs[..., None] * torch.einsum("bcihp,bchpn->bcihn", dyc, Hc)
    dC = torch.einsum("bchij,bcjhn->bcihn", M, Bc) + dC_inter
    t = (Cc * dC_inter).sum(-1)                      # (B, nc, Q, H)
    colsum_sL = sL.sum(-2).permute(0, 1, 3, 2)
    rows = (sL * dtj).sum(-1).permute(0, 1, 3, 2) + t \
        - colsum_sL * dtc
    # the column kernel: dx, dB, u, ddt, dA
    V = torch.einsum("bcjhn,bchpn->bcjhp", Bc, Hn)   # Ĥ B_j
    xV = (xc * V).sum(-1)
    dx = dtc[..., None] * (e[..., None] * V + torch.einsum(
        "bchij,bcihp->bcjhp", T1, dyc))
    dB = (e * dtc)[..., None] * torch.einsum("bcjhp,bchpn->bcjhn", xc, Hn) \
        + torch.einsum("bchij,bcihn->bcjhn", M, Cc)
    u = e * dtc * xV
    w = torch.exp2(end2) * (Hn * Hc).sum((-1, -2))   # (B, nc, H)
    dcs = rows - u
    dcs[:, :, -1] += u.sum(2) + w
    da = torch.flip(torch.cumsum(torch.flip(dcs, [2]), dim=2), [2])
    ddt = colsum_sL + e * xV + Af * da
    dA = (dtc * da).sum((0, 1, 2))

    def out(v, n):  # (B, nc, Q, ..) -> (B, S, ..)
        return v.reshape(B_, nc * Q, *n)[:, :S]

    def group(v):  # the sum over the heads of a group, then bf16
        return out(v, (H, N)).reshape(B_, S, G, HG, N).sum(3).bfloat16()

    return (out(dx, (H, P)).bfloat16(), out(ddt, (H,)), dA, group(dB),
            group(dC), d_init)


def _inputs(shape, seed, state: bool):
    """chip_smoke.py's recipe: x * 0.5, B and C * 0.3 in bf16, softplus dt,
    A = -exp(0.3 randn), dy unit normal in bf16, the initial state and the
    final state's cotangent * 0.1; numpy-seeded."""
    B_, S, H, P, G, N = shape
    rng = np.random.default_rng(seed)

    def rn(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32))

    x = (rn(B_, S, H, P) * 0.5).bfloat16()
    dt, A = F.softplus(rn(B_, S, H)), -torch.exp(rn(H) * 0.3)
    Bm, Cm = ((rn(B_, S, G, N) * 0.3).bfloat16() for _ in range(2))
    dy = rn(B_, S, H, P).bfloat16()
    kw = {}
    if state:
        kw = dict(init_state=rn(B_, H, P, N) * 0.1,
                  d_state=rn(B_, H, P, N) * 0.1)
    return (x, dt, A, Bm, Cm, dy), kw


def _share(got, want) -> float:
    """The largest |got - want| / (TOL + TOL |want|): at most 1 within the
    tolerance."""
    err = (got.float() - want.float()).abs()
    return float((err / (TOL + TOL * want.float().abs())).max())


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


CASES = {
    # B, S, H, P, G, N: four heads of the zamba2-1.2b and mamba2-130m
    # training shapes (chunk 128), and two groups of two heads
    "zamba2_train": (1, 2048, 4, 64, 1, 64),
    "mamba2_train": (1, 2048, 4, 64, 1, 128),
    "groups2": (2, 300, 4, 64, 2, 64),
}


@pytest.mark.parametrize("state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_ssd_bwd_rounding_meets_card_tolerance(case, state):
    args, kw = _inputs(CASES[case], 21, state)
    want = ref.ssd_bwd_ref(*args, chunk=128, **kw)
    exact = _emulated_ssd_bwd(*args, chunk=128, plan="exact", **kw)
    shares, drift = {}, {}
    for plan in PLANS:
        got = _emulated_ssd_bwd(*args, chunk=128, plan=plan, **kw)
        shares[plan], drift[plan] = {}, {}
        for name, a, b, c in zip(NAMES, got, want, exact):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            shares[plan][name] = (_rel_l2(a, b) / TOL if name == "dA"
                                  else _share(a, b))
            drift[plan][name] = _rel_l2(a, c)
        print(f"{case} {'state' if state else 'zero'} {plan}: share of "
              f"the tolerance " + ", ".join(
                  f"{k} {v:.3f}" for k, v in shares[plan].items())
              + "; rel L2 against exact " + ", ".join(
                  f"{k} {v:.2e}" for k, v in drift[plan].items()))
        if plan == "split" and state:
            assert not torch.equal(got[5], exact[5])
    # the kernel's plan: every output within half the tolerance, and the
    # f32 outputs (no rounding of their own) close to the exact
    # arithmetic's: the hi + lo operands keep ~16 bits
    assert max(shares["split"].values()) <= 0.5, shares["split"]
    for name in ("ddt", "dA", "d_init"):
        assert drift["split"][name] <= 1e-4, (name, drift["split"][name])
    # the Q x Q tiles rounded once: dB or dC past half the tolerance (the
    # rule for a single rounding), at ~25x the split tiles' drift
    assert max(shares["single_M"]["dB"], shares["single_M"]["dC"]) > 0.5
    # the states' copies or the passes' operands rounded once stay within
    # half the tolerance, but move ddt and dA, which nothing rounds, by
    # two orders of magnitude more: the gradients of A_log and dt_bias
    for plan in ("single_state", "single_w"):
        assert max(shares[plan].values()) <= 0.5, (plan, shares[plan])
        assert drift[plan]["ddt"] >= 30 * drift["split"]["ddt"], plan
