"""The port's cost model (``repro_torch.launch.cost``) against the JAX
package's HLO walker (``repro.launch.hlo_cost``), on the CPU.

- the twins of tests/test_hlo_cost.py: a product's FLOPs exact, a loop
  of n products (the twin of a scan's trip count) and a nested loop
  exact, the bytes of a 1024² f32 product in the same range; each equal
  to ``hlo_cost.analyze`` of the JAX program;
- ``mode="plain"`` (the plain path op by op) against ``hlo_cost.analyze``
  of the compiled JAX step, exactly, for every family's smoke prefill and
  decode and yi-6b's train step at remat "none" with CE "direct";
- each remaining difference asserted as its exact size with its cause:
  SSM decode (XLA rewrites the one-row depthwise convolution into a
  multiply and a reduce, which ``hlo_cost`` does not count), the
  blockwise CE backward's logits recompute and remat "full"'s Q Kᵀ (XLA
  merges each recompute with the identical product in one program; the
  port's eager backward computes it again), and the SSD backward (the
  port's hand-derived ``ssd_bwd_ref`` is not autodiff of ``ssd_ref``) with
  the depthwise convolution's backward (the port counts the forward's
  FLOPs per gradient; ``hlo_cost`` estimates XLA's weight-gradient
  convolution as a dense one);
- kernel mode: one count on meta and on the CPU, with ``use_kernels``
  None or False; AdamW's calls charged their formula bytes;
- ``calls`` against the launch formulas of ``chip_smoke.py`` for yi-6b,
  zamba2-1.2b and whisper-tiny at smoke size.

Inputs are abstract (shapes and dtypes) on both sides, but for the CPU
counts, whose values come from numpy with a seed.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.launch import hlo_cost
from repro.models import params as JP
from repro.models import registry as jreg
from repro.serve import engine as jengine
from repro.train import step as jstep
from repro_torch.configs.base import RunConfig, ShapeConfig, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import cost, dryrun
from repro_torch.models import params as TP
from repro_torch.models import registry as treg
from repro_torch.optim import adamw_init
from repro_torch.train import step as tstep

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 64  # the smoke cells: batch 2, 64 tokens
FAMILIES = ["yi-6b", "qwen1.5-4b", "mixtral-8x7b", "mamba2-130m",
            "zamba2-1.2b", "whisper-tiny", "llava-next-mistral-7b"]
SSM = ("mamba2-130m", "zamba2-1.2b")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _compile(f, *specs):
    return jax.jit(f).lower(*specs).compile()


def _jax_step(arch: str, kind: str, **run_kw):
    """The compiled JAX step of one smoke cell, as ``lower_cell`` builds
    it (no mesh)."""
    cfg = j_smoke(arch)
    run = JRunConfig(**run_kw)
    specs = jreg.input_specs(cfg, JShapeConfig("s", S, B, kind))
    if kind == "train":
        return _compile(jstep.make_train_step(cfg, run),
                        jstep.abstract_state(cfg, run), specs)
    params = JP.abstract(jreg.param_defs(cfg))
    if kind == "prefill":
        cache = jengine.abstract_cache(cfg, B, S + cfg.num_img_patches + 8)
        return _compile(jengine.make_prefill_step(cfg, run), params, specs,
                        cache)
    cache = jengine.abstract_cache(cfg, B, S)
    return _compile(jengine.make_decode_step(cfg, run), params,
                    specs["tokens"], cache, specs["pos"])


def _port_step(arch: str, kind: str, mode: str = "plain", **run_kw):
    return dryrun.count_cell(get_smoke_config(arch),
                             ShapeConfig("s", S, B, kind),
                             RunConfig(**run_kw), mode=mode)


class _ConvOnly(hlo_cost.CostWalker):
    """``hlo_cost``'s walk with every dot at zero FLOPs: the FLOPs of the
    program's convolutions alone."""

    def _dot_flops(self, comp, inst):
        return 0.0


def _jax_conv_flops(text: str) -> float:
    comps, entry = hlo_cost.parse_module(text)
    return _ConvOnly(comps, entry).comp_costs(entry).flops


def _conv_fwd_flops(cfg, tokens: int) -> float:
    """FLOPs of the forward depthwise causal convolutions of one step's
    mamba blocks: x over ssm_inner channels, B and C over ssm_state each
    (one group), 2 x W a channel and output row."""
    blocks = cfg.num_layers
    return 2.0 * tokens * cfg.ssm_conv * (cfg.ssm_inner + 2 * cfg.ssm_state) \
        * blocks


# --- the twins of tests/test_hlo_cost.py ---------------------------------

def test_single_matmul_flops():
    x = jax.ShapeDtypeStruct((128, 256), jnp.float32)
    w = jax.ShapeDtypeStruct((256, 64), jnp.float32)
    want = hlo_cost.analyze(_compile(lambda a, b: a @ b, x, w).as_text())
    res = cost.analyze(lambda a, b: a @ b,
                       torch.empty(128, 256, device="meta"),
                       torch.empty(256, 64, device="meta"))
    assert res["flops"] == 2 * 128 * 256 * 64 == want["flops"]


@pytest.mark.parametrize("n", [1, 4, 9])
def test_loop_multiplies_by_trip_count(n):
    def jf(x, ws):
        def body(c, w):
            return c @ w, None
        y, _ = jax.lax.scan(body, x, ws)
        return y

    def tf(x, ws):
        for i in range(n):
            x = x @ ws[i]
        return x

    want = hlo_cost.analyze(_compile(
        jf, jax.ShapeDtypeStruct((64, 64), jnp.float32),
        jax.ShapeDtypeStruct((n, 64, 64), jnp.float32)).as_text())
    res = cost.analyze(tf, torch.empty(64, 64, device="meta"),
                       torch.empty(n, 64, 64, device="meta"))
    assert res["flops"] == n * 2 * 64 ** 3 == want["flops"]


def test_nested_loop():
    def jf(x, ws):
        def outer(c, w):
            def inner(ci, wi):
                return ci @ wi, None
            y, _ = jax.lax.scan(inner, c, w)
            return y, None
        y, _ = jax.lax.scan(outer, x, ws)
        return y

    def tf(x, ws):
        for i in range(ws.shape[0]):
            for j in range(ws.shape[1]):
                x = x @ ws[i, j]
        return x

    want = hlo_cost.analyze(_compile(
        jf, jax.ShapeDtypeStruct((32, 32), jnp.float32),
        jax.ShapeDtypeStruct((3, 5, 32, 32), jnp.float32)).as_text())
    res = cost.analyze(tf, torch.empty(32, 32, device="meta"),
                       torch.empty(3, 5, 32, 32, device="meta"))
    assert res["flops"] == 15 * 2 * 32 ** 3 == want["flops"]


def test_bytes_nonzero_and_sane():
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal((1024, 1024),
                                                 dtype=np.float32))
            for _ in range(2))
    spec = jax.ShapeDtypeStruct((1024, 1024), jnp.float32)
    want = hlo_cost.analyze(_compile(lambda x, y: x @ y, spec,
                                     spec).as_text())
    # a product reads 2 x 4 MB and writes 4 MB
    for res in (cost.analyze(lambda x, y: x @ y, a, b),
                cost.analyze(lambda x, y: x @ y, a.to("meta"), b.to("meta"))):
        assert 12e6 <= res["hbm_bytes"] <= 20e6
        assert res["hbm_bytes"] == 3 * 4 * 1024 ** 2
        assert res["flops"] == want["flops"]
        # peak: both arguments and the product
        assert res["peak_bytes"] == 3 * 4 * 1024 ** 2
    assert 12e6 <= want["hbm_bytes"] <= 20e6


def test_peak_follows_frees_views_and_in_place_ops():
    x = torch.empty(1000, device="meta")  # 4000 bytes

    def f(x):
        a = x * 2  # +4000
        a.add_(1)  # in place: nothing new
        v = a.view(10, 100)  # a view: nothing new
        del a
        b = v + 1  # +4000 (a lives on through v)
        del v, b  # both freed
        return x * 3  # +4000

    res = cost.analyze(f, x)
    assert res["argument_bytes"] == 4000
    assert res["peak_bytes"] == 3 * 4000
    assert res["output_bytes"] == res["new_output_bytes"] == 4000
    # x * 2, add_ (a read and written), v + 1, x * 3: two tensors each
    assert res["hbm_bytes"] == 8 * 4000


# --- plain mode against hlo_cost on the smoke steps ----------------------

@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_plain_serving_steps_equal_hlo_cost(arch, kind):
    compiled = _jax_step(arch, kind)
    want = hlo_cost.analyze(compiled.as_text())["flops"]
    got = _port_step(arch, kind)["flops"]
    if arch in SSM and kind == "decode":
        # XLA rewrites decode's depthwise convolution (one output row)
        # into a multiply and a reduce: no convolution is left for
        # hlo_cost to count, while the port runs F.conv1d, 2 x W FLOPs a
        # channel and row
        assert _jax_conv_flops(compiled.as_text()) == 0
        assert got - want == _conv_fwd_flops(get_smoke_config(arch), B)
    else:
        assert got == want


def test_plain_train_step_equals_hlo_cost():
    kw = dict(remat="none", ce_mode="direct")
    want = hlo_cost.analyze(_jax_step("yi-6b", "train", **kw).as_text())
    got = _port_step("yi-6b", "train", **kw)
    assert got["flops"] == want["flops"] == 83_886_080


def test_plain_blockwise_ce_recomputes_the_logits_once_more():
    """The blockwise CE backward recomputes each block's logits, ``hf @
    wbᵀ`` (``train/loss.py``); XLA merges ``_ce_bwd``'s recompute with
    the forward's identical product in one compiled program, the eager
    port cannot: one extra 2 T D V."""
    kw = dict(remat="none", ce_mode="blockwise")
    want = hlo_cost.analyze(_jax_step("yi-6b", "train", **kw).as_text())
    got = _port_step("yi-6b", "train", **kw)
    cfg = get_smoke_config("yi-6b")
    assert got["flops"] - want["flops"] == \
        2 * B * S * cfg.d_model * cfg.vocab_size == 4_194_304


def test_plain_remat_full_recomputes_q_kt_once_more():
    """Under remat "full" each block's forward runs again in the
    backward, and the flash backward recomputes Q Kᵀ from the same q and
    k: XLA merges the two identical products, the port's eager
    checkpoint computes both.  One Q Kᵀ a layer (the plain reference's
    one KV block of 64 keys: B x Hq x S x S x head_dim, 2 FLOPs each)."""
    kw = dict(remat="full", ce_mode="direct")
    want = hlo_cost.analyze(_jax_step("yi-6b", "train", **kw).as_text())
    got = _port_step("yi-6b", "train", **kw)
    cfg = get_smoke_config("yi-6b")
    assert got["flops"] - want["flops"] == (
        cfg.num_layers * 2 * B * cfg.num_heads * S * S * cfg.head_dim) \
        == 2_097_152


def _ssd_fwd_bwd(chunk: int, shapes):
    """FLOPs of one SSD forward and backward at ``shapes``: autodiff of
    ``ssd_ref`` (JAX) and ``SSDFn`` on its plain path, whose backward is
    the hand-derived ``ssd_bwd_ref`` (port)."""
    (xs, dts, As, bs) = shapes
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}

    def jf(x, dt, A, Bm, Cm, dy):
        y, vjp = jax.vjp(lambda *a: jref.ssd_ref(*a, chunk=chunk), x, dt, A,
                         Bm, Cm)
        return y, vjp(dy)

    specs = [jax.ShapeDtypeStruct(s, jdt[d]) for s, d in
             (xs, dts, As, bs, bs, xs)]
    want = hlo_cost.analyze(_compile(jf, *specs).as_text())["flops"]

    def tf(x, dt, A, Bm, Cm, dy):
        ops.ssd(x, dt, A, Bm, Cm, chunk=chunk).backward(dy)

    ts = [torch.empty(s, dtype=d, device="meta").requires_grad_(g)
          for (s, d), g in zip((xs, dts, As, bs, bs, xs),
                               (True,) * 5 + (False,))]
    return cost.analyze(tf, *ts, mode="plain")["flops"], want


def test_plain_ssm_train_step_differs_by_the_ssd_and_conv_backwards():
    """mamba2-130m at remat "none", CE "direct": the products differ by
    the SSD backward a layer (``ssd_bwd_ref``'s hand-derived formulas
    against XLA's autodiff of ``ssd_ref``, counted alone at the layer's
    shapes); the convolutions by the depthwise backward (the port: the
    forward's FLOPs for each of the input and weight gradients; hlo_cost:
    its estimate of XLA's transposed and weight-gradient convolutions,
    which counts a depthwise weight gradient as dense)."""
    arch = "mamba2-130m"
    kw = dict(remat="none", ce_mode="direct")
    text = _jax_step(arch, "train", **kw).as_text()
    want = hlo_cost.analyze(text)["flops"]
    j_conv = _jax_conv_flops(text)
    got = _port_step(arch, "train", **kw)["flops"]
    cfg = get_smoke_config(arch)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    t_ssd, j_ssd = _ssd_fwd_bwd(cfg.ssm_chunk, (
        ((B, S, H, P), torch.bfloat16), ((B, S, H), torch.float32),
        ((H,), torch.float32), ((B, S, 1, N), torch.bfloat16)))
    t_conv = 3 * _conv_fwd_flops(cfg, B * S)  # forward, dx, dw
    assert t_ssd != j_ssd and t_conv != j_conv
    assert got - want == (cfg.num_layers * (t_ssd - j_ssd)
                          + (t_conv - j_conv))


# --- kernel mode ----------------------------------------------------------

def _cpu_tree(tree, rng):
    """``tree`` (meta tensors) as CPU tensors of numpy draws."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point:
            a = rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.02
            return torch.from_numpy(a).to(t.dtype)
        return torch.from_numpy(rng.integers(0, 64, tuple(t.shape)))
    return TP.tree_map(leaf, tree)


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-1.2b"])
def test_kernel_mode_count_is_one_on_meta_and_cpu(arch):
    """One train step in kernel mode: the same FLOPs, bytes, peak and
    calls on meta and on CPU tensors, with ``use_kernels`` None (the
    plain versions, since the tensors are not on CUDA) or False."""
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("s", S, B, "train")
    counts = []
    for use_kernels in (None, False):
        run = RunConfig(use_kernels=use_kernels)
        for device in ("meta", "cpu"):
            rng = np.random.default_rng(0)
            params = TP.abstract(treg.param_defs(cfg))
            batch = treg.input_specs(cfg, shape)
            if device == "cpu":
                params, batch = _cpu_tree(params, rng), _cpu_tree(batch, rng)
            state = {"params": params, "opt": adamw_init(params)}
            res = cost.analyze(tstep.make_train_step(cfg, run), state, batch)
            counts.append({k: res[k] for k in ("flops", "hbm_bytes",
                                               "peak_bytes", "calls")})
    assert all(c == counts[0] for c in counts[1:]), counts
    assert counts[0]["flops"] < _port_step(arch, "train")["flops"]


def test_kernel_charge_is_the_work_formula():
    """A kernel call is charged its ``work`` and counts nothing inside:
    the flash reference over a causal 64 x 64 computes the whole block
    (plain mode), the charge only the visible pairs."""
    q = torch.empty(2, 64, 4, 16, device="meta")
    k = torch.empty(2, 64, 2, 16, device="meta")

    def f(q, k):
        return ops.flash_attention(q, k, k, causal=True)

    kern = cost.analyze(f, q, k)
    plain = cost.analyze(f, q, k, mode="plain")
    pairs = 64 * 65 // 2
    assert kern["flops"] == 4 * 2 * 4 * pairs * 16
    assert plain["flops"] == 2 * (2 * 2 * 4 * 64 * 64 * 16)
    assert kern["calls"] == plain["calls"] == {"flash_attention": 1}
    assert kern["hbm_bytes"] == (2 * q.numel() + 2 * 2 * 64 * 2 * 16) * 4


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_kernel_mode_charges_adamw_its_bytes(device):
    """An AdamW step in kernel mode, bf16 params and gradients, f32
    moments: a leaf's ``adamw_norm`` call is charged g read once and its
    row of f32 partials written, the finalize's ``adamw_norm`` call the
    partials read and each leaf's sum written, a leaf's ``adamw`` call p,
    g, m and v read and p, m and v written (22 bytes an element); nothing
    inside the calls is counted op by op.  The norm and the clip scale,
    taken from the sums by PyTorch ops outside the calls, are counted op
    by op, as those ops alone count."""
    from repro_torch.kernels.adamw import PARTS
    from repro_torch.optim import adamw_update
    from repro_torch.optim.adamw import _finish
    shapes = {"w": (32, 64), "b": (64,)}
    tree = lambda: {k: torch.zeros(s, dtype=torch.bfloat16, device=device)
                    for k, s in shapes.items()}
    params, grads = tree(), tree()
    opt = adamw_init(params)
    res = cost.analyze(lambda p, g, o: adamw_update(p, g, o, lr=1e-3),
                       params, grads, opt)
    n = {k: math.prod(s) for k, s in shapes.items()}
    total = sum(n.values())
    assert res["calls"] == {"adamw_norm": len(shapes) + 1,
                            "adamw": len(shapes)}
    L = len(shapes)
    finish = cost.analyze(lambda s: _finish(s, 1.0),
                          torch.zeros(L, device=device))
    assert finish["calls"] == {} and finish["hbm_bytes"] > 0
    assert res["hbm_bytes"] == (22 * total + (2 * total + 4 * PARTS * L)
                                + 4 * L * (PARTS + 1) + finish["hbm_bytes"])
    # the update's 14 FLOPs, the clip's 1, the decay's 2 on the 2-D leaf;
    # the norm's 2; the finalize's add a partial
    assert res["flops"] == (17 * n["w"] + 15 * n["b"] + 2 * total
                            + PARTS * L + finish["flops"])


# --- calls against chip_smoke.py's launch formulas -------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-1.2b", "whisper-tiny"])
def test_calls_equal_the_launch_formulas(arch):
    smoke = _chip_smoke()
    cfg = get_smoke_config(arch)
    gen = 5
    prefill = _port_step(arch, "prefill", mode="kernel")["calls"]
    decode = _port_step(arch, "decode", mode="kernel")["calls"]
    want = smoke.serving_launches(cfg, gen)
    for name, n in want.items():
        assert prefill.get(name, 0) + (gen - 1) * decode.get(name, 0) == n, \
            name
    train = dryrun.count_cell(cfg, ShapeConfig("s", S, B, "train"),
                              RunConfig(), mode="kernel")["calls"]
    want = smoke.training_launches(cfg.num_layers, 1, cfg=cfg)
    assert {k: train.get(k, 0) for k in want} == want


def test_work_formulas_count_what_the_masks_leave():
    """``flash_attention.visible`` against the masks built as (Sq, Sk)
    tensors."""
    from repro_torch.kernels import flash_attention as kflash
    for Sq, Sk, causal, window, q_off, kv_len in [
            (64, 64, True, 0, 0, None), (100, 160, True, 0, 0, None),
            (1, 256, True, 0, 200, 201), (48, 96, True, 16, 40, 90),
            (30, 50, False, 0, 0, 40), (4608, 4648, True, 4096, 0, 4608)]:
        qp = q_off + torch.arange(Sq)[:, None]
        kp = torch.arange(Sk)[None, :]
        m = (kp < (Sk if kv_len is None else kv_len)).expand(Sq, Sk)
        if causal:
            m = m & (kp <= qp)
        if window:
            m = m & (kp > qp - window)
        assert kflash.visible(Sq, Sk, causal=causal, q_offset=q_off,
                              kv_len=kv_len, sliding_window=window) == (
            int(m.sum()), int(m.any(0).sum()))
    assert math.isclose(kflash.visible(512, 552, kv_len=512)[0],
                        512 * 513 / 2)
