"""The frozen work formulas of ``perfbench/ops`` and the model FLOPs of
the references against counts made by hand at one shape each."""
import pytest

from perfbench import bench
from perfbench.reference import dense, moe, zamba2
from perfbench.workmath import bound_s, causal_pairs, visible

OPS = bench.ops()


def test_visible_pairs_by_hand():
    # 4 queries over 4 keys, causal: 1 + 2 + 3 + 4 visible pairs
    assert visible(4, 4) == (10, 4)
    # a cache of 8 positions of which 3 are written: 1 + 2 + 3
    assert visible(3, 8, kv_len=3) == (6, 3)
    # not causal: every pair of the 3 valid keys
    assert visible(2, 8, causal=False, kv_len=3) == (6, 3)
    assert causal_pairs(5, 2) == 3 + 3 + 1


def test_flash_by_hand():
    B, S, Hq, Hkv, D = 2, 4, 4, 2, 8
    f, b = OPS["flash_fwd"].work(B=B, Sq=S, Sk=S, Hq=Hq, Hkv=Hkv, D=D,
                                 lse=True)
    assert f == 4 * B * Hq * 10 * D
    assert b == 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D) \
        + 4 * B * S * Hq
    f, b = OPS["flash_bwd"].work(B=B, Sq=S, Sk=S, Hq=Hq, Hkv=Hkv, D=D)
    assert f == 10 * B * Hq * 10 * D
    assert b == 2 * (4 * B * S * Hq * D + 4 * B * S * Hkv * D) \
        + 4 * B * S * Hq


def test_ssd_by_hand():
    k = dict(B=1, S=4, H=2, P=3, G=1, N=5, chunk=2)
    pairs = 3 + 3
    f, b = OPS["ssd_fwd"].work(**k)
    assert f == 2 * pairs * 5 + 2 * 2 * pairs * 3 + 4 * 2 * 4 * 5 * 3
    assert b == 2 * 4 * 2 * 3 * 2 + 4 * 4 * 2 + 2 * 4 * 5 * 2 + 4 * 2 * 3 * 5
    f, b = OPS["ssd_bwd"].work(**k)
    assert f == 2 * pairs * 5 + 2 * 2 * pairs * (2 * 3 + 2 * 5) \
        + 10 * 2 * 4 * 5 * 3
    assert b == 3 * 4 * 2 * 3 * 2 + 8 * 4 * 2 + 4 * 4 * 5 * 2


def test_kernel_patterns_cover_the_port_kernels():
    names = ["void flash_fwd_tc_kernel<128>(x)", "flash_bwd_dq_tc_kernel<64>",
             "flash_bwd_delta_kernel", "ssd_scan_tc_kernel<64>",
             "ssd_bwd_state_tc_kernel<64, true>", "ssd_state_pass_kernel"]
    owner = {n: [o for o, op in OPS.items()
                 if any(p in n for p in op.patterns)] for n in names}
    assert all(len(v) == 1 for v in owner.values()), owner


def test_dense_forward_flops_by_hand():
    c = dict(num_layers=2, d_model=8, num_heads=2, num_kv_heads=1,
             head_dim=4, d_ff=16, vocab_size=10)
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    mats = 2 * per_layer + 10 * 8
    attn = 4 * 1 * 2 * 10 * 4  # B Hq pairs(4) D
    assert dense.forward_flops(c, 1, 4, OPS) == 2 * mats * 4 + 2 * attn


def test_zamba2_forward_flops_by_hand():
    c = dict(num_layers=3, d_model=8, num_heads=2, num_kv_heads=2,
             head_dim=4, d_ff=16, vocab_size=10, ssm_state=4, ssm_expand=2,
             ssm_head_dim=4, ssm_chunk=2, ssm_conv=3, attn_every=2)
    din, N, H, W = 16, 4, 4, 3
    mamba = 8 * (2 * din + 2 * N + H) + din * 8 + W * (din + 2 * N)
    shared = 2 * 8 * 8 + 2 * 8 * 8 + 3 * 8 * 16
    mats = 3 * mamba + 1 * shared + 10 * 8
    attn = 4 * 1 * 2 * 10 * 4
    scan = OPS["ssd_fwd"].work(B=1, S=4, H=H, P=4, G=1, N=N, chunk=2)[0]
    assert zamba2.forward_flops(c, 1, 4, OPS) == 2 * mats * 4 + attn \
        + 3 * scan


def test_moe_forward_flops_by_hand():
    # the router and the K = 2 experts a token goes to, not all E = 4
    c = dict(num_layers=2, d_model=8, num_heads=2, num_kv_heads=1,
             head_dim=4, d_ff=16, vocab_size=10, num_experts=4,
             num_experts_per_tok=2)
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 8 * 4 + 2 * 3 * 8 * 16
    mats = 2 * per_layer + 10 * 8
    attn = 4 * 1 * 2 * 10 * 4
    assert moe.forward_flops(c, 1, 4, OPS) == 2 * mats * 4 + 2 * attn


@pytest.mark.parametrize("fam", [dense, moe])
def test_kernel_calls_a_ranks_share_of_the_heads(fam):
    c = dict(num_layers=3, num_heads=32, num_kv_heads=8, head_dim=128)
    whole = fam.kernel_calls(c, "prefill", 2, 64, 72)
    part = fam.kernel_calls(c, "prefill", 2, 64, 72, ranks=4)
    assert len(whole) == len(part) == 3
    for (n, a), (m, b) in zip(whole, part):
        assert n == m == "flash_fwd"
        assert (b["Hq"], b["Hkv"]) == (8, 2)
        fa, ba = OPS[n].work(**a)
        fb, bb = OPS[m].work(**b)
        assert fb * 4 == fa and bb * 4 == ba


@pytest.mark.parametrize("flops,nbytes,which", [(989e12, 1.0, "ops"),
                                                (1.0, 3.35e12, "bytes")])
def test_bound_takes_the_larger_term(flops, nbytes, which):
    peaks = bench.load_json(bench.ROOT / "perfbench" / "peaks.json")
    assert bound_s(flops, nbytes, peaks) == pytest.approx(1.0)


class _Event:
    def __init__(self, name, start, dur, kind="CUDA", annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._k, self._a = kind, annotation

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._k}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_trace_counts_operations_not_ranges_over_them(monkeypatch):
    """NCCL's ``nccl:*`` ranges lie on the device beside its kernels: busy
    time and the kernels' time count the kernels once."""
    import torch
    from perfbench import devtrace
    events = [_Event("ncclDevKernel_AllReduce_Sum_bf16", 0, 400),
              _Event("nccl:all_reduce", 0, 900, annotation=True),
              _Event("gemm", 1000, 500),
              _Event("cudaLaunchKernel", 0, 10, kind="CPU")]
    monkeypatch.setattr(devtrace, "_events", lambda prof: events)
    t = devtrace.DeviceTrace(torch.device("cuda"))
    t.t0, t.t1 = 0.0, 2e-6
    s = t.summary()
    assert s["busy_s"] == pytest.approx(900e-9)
    assert set(s["kernels"]) == {"ncclDevKernel_AllReduce_Sum_bf16", "gemm"}
    assert devtrace.kernel_seconds(s, ("nccl",)) == pytest.approx(400e-9)
