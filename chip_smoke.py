"""Drives the PyTorch port's serving and training paths on one NVIDIA GPU
and holds every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no final result line):

1. device: ``nvidia-smi`` name and power limit, torch / CUDA / nvcc versions;
2. build: every source in ``src/repro_torch/kernels/csrc`` compiled into
   one extension module by ``torch.utils.cpp_extension.load``, with its
   time and ptxas' register counts; then the CUDA runtime's registers,
   local (spill) bytes, shared memory and resident blocks a SM of each
   redesigned kernel: the tensor-core flash forward and backward, CE
   forward and SSD scan, the RMSNorm forward and backward (fails if one
   uses local memory);
3. kernel against plain: each kernel and its plain version on the same
   inputs, at the main paths' shapes and the sweep of tests/test_kernels.py
   (tolerance 2e-2 in bf16, 3e-5 in f32; the SSD scan 3e-2 and 3e-4), with
   the kernel's time, the plain version's time and one library call's time
   (CUDA graph + events, median), warm (inputs in L2) and, at the models'
   shapes, cold (inputs rotated past L2), and the bound of the work the
   call needs.  Forward kernels (RMSNorm, flash attention, cross entropy;
   RMSNorm and flash also at the zamba2-1.2b / mamba2-130m prefill
   shapes and at the prefills of SERVE_ARCHS: RMSNorm at D 2560, 5120,
   6144; flash at G 1, 12, 16 and mixtral's 4608 queries, window 4096)
   and, for training, the RMSNorm and flash-attention backward
   kernels (the latter's device time split by kernel under the
   profiler) and the flash forward's ``lse``; then the SSD chunked scan
   (phase "ssd": ``y`` and the final state against ``ssd_ref`` on the
   SSD_CASES of tests/test_kernels.py, S < chunk, an ``init_state`` chain
   of two calls against one, and both models' prefill shapes; no library
   call computes it).  The library yardstick of a backward is the library
   forward plus backward less the forward;
4. serving: ``run_serving(arch, smoke=False, prompt_len=P, gen=32,
   batch=4)`` at full width and depth for yi-6b (P = 512), zamba2-1.2b
   and mamba2-130m (P = 2048; phases "serving_zamba2", "serving_mamba2"),
   then at full width for SERVE_ARCHS (phases "serving_qwen1_5_4b",
   "serving_starcoder2_15b", "serving_qwen1_5_32b", "serving_mixtral_8x7b",
   "serving_qwen3_moe"): qwen1.5-4b
   (int8 KV cache) and starcoder2-15b at full depth, qwen1.5-32b (int8)
   at 32 of 64 layers, mixtral-8x7b at 12 of 32 (batch 1, P = 4608) and
   qwen3-moe-235b-a22b at 6 of 94 through ``num_layers`` (their bf16
   weights and the f32 temporaries of their initialisation would not fit
   the card); launch counters reset just before each and read just
   after, and held against the counts the code implies;
5. end to end, each model as it was served: (a) prefill logits through
   the kernels against ``use_kernels=False``; (b) decode at position S
   after a prefill of S tokens against a prefill of S + 1 tokens (for
   the SSM models S + 1 = 2049, one past a chunk boundary; for the MoE
   models at capacity factor E / K, where nothing drops: a longer
   prefill may drop its last token from a full expert, decode never
   does); both at relative L2 <= 5e-2.  MoE rows also log the share of
   (token, expert) pairs (a)'s prefill dropped and the top-K choices
   that differ between its two paths.  Beside (a), not checked: both
   paths against the plain path with the same weights in f32, to show
   how far bf16 rounding alone moves the logits of the random model,
   where that copy fits on the card (skipped, and logged so, where not);
6. breakdown: ``torch.profiler`` over one warm prefill and four warm decode
   steps of each model (wall time, device time, busy share, top kernels
   by device time; for SERVE_ARCHS the top operators too); then, for
   the MoE and int8-cache models, phase "parts_*": the routing, the
   expert products (with their bound) and the whole MoE block at the
   prefill's and a decode step's tokens, and the int8 quantisation and
   dequantisation of one layer's K, each timed alone (CUDA events);
7. training: ``run_training("yi-6b", smoke=False, steps=3, seq_len=512,
   global_batch=4, carousel=False)`` at full width and depth, launch
   counters reset just before and read just after and held against the
   counts the code implies; losses, step time of steps 2-3, tokens/s and
   peak memory; then ``torch.profiler`` over one more (warm) step (with
   the device time of the flash, RMSNorm-backward and CE kernels picked
   out), and the wall time of each half (gradients, AdamW) of HALF_STEPS
   more, with the allocator's retries (``num_alloc_retries``) counted
   through the phase;
8. end to end, training, at full width and 2 layers: one
   ``grads_and_metrics`` through the kernels against one through
   ``use_kernels=False``, loss within relative 1e-2 and every gradient leaf
   within relative L2 5e-2;
9. training_carousel: ``run_training`` on the Data Carousel, as its
   defaults run it (8 shards, 4 drives, 1 ms a tape read, fault rate
   0.02), at full width and depth, 3 steps of 4 x 512 tokens; launches
   held against the training formula; time to the first batch by the
   delivery's clock and by ``run_training``'s, each step's wait in
   ``next()``, the tape's reads and failed reads, hedges, rows delivered
   and received, step times beside phase 7's, tokens/s, peak memory;
10. carousel_fine_vs_coarse: full width, 2 layers, 6 steps, one tape
   drive at 0.4 s a shard, fine delivery then coarse: coarse's first
   batch must come more than 1.5 s after fine's;
11. checkpoint_resume: full width, 2 layers (8.7 GB of state): 4 steps
   saving every 2 into a temporary directory, the newest checkpoint
   loaded onto the card equal leaf by leaf (``torch.equal``) to the state
   it saved, one step from each on one batch, then a resume of 2 steps to
   step 6; bytes, host-copy, writer and load times;
12. remat_dots: full width, 2 layers, ``grads_and_metrics`` with
   ``remat="dots"`` through the kernels against the plain path (loss 1e-2,
   leaves relative L2 5e-2) and against "full" (printed), launches equal to
   "full"'s; then step time, peak memory and allocator retries of "full"
   and "dots" at REMAT_LAYERS layers, and one more step of each under
   ``torch.profiler`` (wall, device time, busy share).

Phases 9-11 drive the entry point; each of their runs has its launch
counters reset just before it and read just after.

It prints a ``{"kernel_info": [...]}`` line, a ``{"kernels": [...]}`` line
and, last, ``{"ok": true, ...}``.
A kernel's ``launches`` there is the sum of its counts over the eight
serving runs, the training run and the runs of phases 9-11 (``ssd_scan``:
the serving runs only); ``ssd_scan``'s row is the zamba2-1.2b prefill
shape.  Weights are random, made on the card from a seed; data is
synthetic, from a seed; nothing is downloaded.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils.cpp_extension import CUDA_HOME  # noqa: E402

from repro_torch.configs.base import (RunConfig, ShapeConfig,  # noqa: E402
                                      get_config)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import cross_entropy as kce  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as krms  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import adamw_update  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 3e-5}
SSD_TOL = {torch.bfloat16: 3e-2, torch.float32: 3e-4}
E2E_TOL = 5e-2
# the f32 yardstick of phase 5 runs where its copy of the weights fits
# with this much to spare
F32_MARGIN_BYTES = 8e9
LOSS_TOL = 1e-2
ARCH, PROMPT, GEN, BATCH = "yi-6b", 512, 32, 4
SSM_ARCHS, SSM_PROMPT = ("zamba2-1.2b", "mamba2-130m"), 2048
# the other dense archs and the MoE archs at full width: arch, layers
# (None: full depth; a cut where the bf16 weights and the f32 temporaries
# of their initialisation would not fit the card), batch, prompt
MIXTRAL_PROMPT = 4608  # the 4096-token window bites on the last 512
SERVE_ARCHS = [("qwen1.5-4b", None, BATCH, PROMPT),
               ("starcoder2-15b", None, BATCH, PROMPT),
               ("qwen1.5-32b", 32, BATCH, PROMPT),
               ("mixtral-8x7b", 12, 1, MIXTRAL_PROMPT),
               ("qwen3-moe-235b-a22b", 6, BATCH, PROMPT)]
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 3, 512, 4
HALF_STEPS = 3  # warm steps whose two halves are timed alone
E2E_TRAIN_LAYERS = 2
# the carousel's fine vs coarse delivery: one tape drive, 0.4 s a shard
FINE_COARSE = dict(steps=6, tape_latency=0.4, drives=1)
FINE_COARSE_GAP_S = 1.5  # coarse's first batch this much later at least
# checkpoints: CKPT_STEPS steps saved every CKPT_EVERY, then a resume
CKPT_STEPS, CKPT_EVERY, CKPT_RESUME_STEPS = 4, 2, 2
# remat "dots" at full depth: it keeps q, k, v, o, gate, up and down,
# (4096 + 2 x 512 + 4096 + 3 x 11008) x 2 B = 145 MB a layer at 2048
# tokens, 4.6 GB over 32 layers, on top of "full"'s 75.1 GB peak: 79.7 GB
# of the card's 85.0 GB, so the whole model
REMAT_LAYERS, REMAT_STEPS = 32, 3
DEVICE = "cuda"

# B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len: the six CASES of
# tests/test_kernels.py, then the yi-6b prefill (cache of PROMPT + GEN + 8).
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0, None),
    (1, 100, 160, 6, 6, 64, True, 0, 0, None),
    (2, 1, 256, 8, 2, 128, True, 0, 200, 201),
    (2, 64, 256, 4, 4, 64, True, 48, 0, None),
    (1, 96, 160, 4, 2, 64, False, 0, 0, None),
    (1, 80, 80, 40, 40, 32, True, 0, 0, None),
]
FLASH_MAIN = (BATCH, PROMPT, PROMPT + GEN + 8, 32, 4, 128, True, 0, 0,
              PROMPT)
# zamba2-1.2b prefill: 32/32 heads of 64 over a cache of SSM_PROMPT + GEN + 8
FLASH_ZAMBA2 = (BATCH, SSM_PROMPT, SSM_PROMPT + GEN + 8, 32, 32, 64, True,
                0, 0, SSM_PROMPT)
# the prefills of SERVE_ARCHS: starcoder2-15b (48/4 heads), qwen1.5-4b
# (20/20), qwen1.5-32b (40/40), qwen3-moe (64/4), and mixtral (1 x 4608,
# 32/8 heads, window 4096)
FLASH_SERVE = [(BATCH, PROMPT, PROMPT + GEN + 8, hq, hkv, 128, True, 0, 0,
                PROMPT) for hq, hkv in ((48, 4), (20, 20), (40, 40),
                                        (64, 4))] + [
    (1, MIXTRAL_PROMPT, MIXTRAL_PROMPT + GEN + 8, 32, 8, 128, True, 4096, 0,
     MIXTRAL_PROMPT)]
# the yi-6b training shape: self-attention over TRAIN_SEQ, causal
FLASH_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 4, 128, True, 0, 0,
               None)
RMS_MAIN = (BATCH * PROMPT, 4096)  # also the training shape (4 x 512 rows)
# the zamba2-1.2b / mamba2-130m prefill norms: d_model and the gated norm
RMS_SSM = [(BATCH * SSM_PROMPT, d) for d in (2048, 4096, 768, 1536)]
# the qwen1.5-4b, qwen1.5-32b and starcoder2-15b prefill norms
RMS_SERVE = [(BATCH * PROMPT, d) for d in (2560, 5120, 6144)]
# the backward's sweep: the training shape and the small ragged cases
RMS_TRAIN_SHAPES = [RMS_MAIN, (BATCH, 4096), (8, 128), (3, 7, 384), (1, 513)]
RMS_SHAPES = RMS_TRAIN_SHAPES + RMS_SSM + RMS_SERVE
# B, S, H, P, G, N, chunk: the SSD_CASES of tests/test_kernels.py, S <
# chunk, then the zamba2-1.2b and mamba2-130m prefill shapes
SSD_ZAMBA2 = (BATCH, SSM_PROMPT, 64, 64, 1, 64, 128)
SSD_MAMBA2 = (BATCH, SSM_PROMPT, 24, 64, 1, 128, 128)
SSD_CASES = [(2, 96, 4, 16, 1, 32, 32), (1, 130, 6, 32, 2, 16, 64),
             (2, 64, 2, 64, 1, 128, 32), (2, 50, 4, 64, 1, 64, 128),
             SSD_ZAMBA2, SSD_MAMBA2]
# T, D, V: the yi-6b loss head (4 x 512 tokens), then small ragged cases
CE_MAIN = (TRAIN_BATCH * TRAIN_SEQ, 4096, 64000)
CE_SHAPES = [CE_MAIN, (37, 48, 1000), (256, 64, 4099), (300, 128, 513)]


def log(*a) -> None:
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, sets: int = 1, reps: int = 10, calls: int = 10) -> float:
    """Device time of one call ``fn(i)``, ``i`` in ``range(sets)``: a run
    of calls captured in a CUDA graph, the graph replayed ``reps`` times
    between CUDA events, the median per-call time.  The graph takes the
    host's launch overhead out, so a short kernel is timed by what it
    costs on the card.  With ``sets`` > 1 the calls cycle through that
    many input sets, and each call's output is kept until its set comes
    round again, so a set is evicted from L2 before it is read again.
    ``calls`` (at least, rounded up to a multiple of ``sets``) go into
    the graph."""
    per_graph = sets * -(-calls // sets)
    keep = {}

    def run():
        for i in range(per_graph):
            keep[i % sets] = fn(i % sets)

    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        run()
        run()
    cur.wait_stream(side)
    keep.clear()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) / per_graph for s, e in events]
    del graph
    keep.clear()
    return statistics.median(times)


def cold_sets(n_bytes: float) -> int:
    """Input sets enough that the others' bytes between two reads of one
    set are at least twice the L2 cache."""
    return -(-2 * L2_BYTES // int(n_bytes)) + 1


def _close(a: torch.Tensor, b: torch.Tensor, tol: float):
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool((err <= tol + tol * b.abs()).all())
    return ok, float(err.max())


def _bound(n_bytes: float, flops: float, dtype: torch.dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_row(row: dict, fns: dict, sets: list, calls: int = 10) -> None:
    """Adds each of ``fns`` (name -> function of one input set) to ``row``:
    its warm time (``sets[0]`` every call, so it sits in L2) as
    ``<name>_warm`` and, when more than one set is given, its cold time
    (the sets rotated past L2, as HBM serves them) as ``<name>``."""
    for key, fn in fns.items():
        row[key + "_warm"] = time_ms(lambda i: fn(*sets[0]), calls=calls)
        if len(sets) > 1:
            row[key] = time_ms(lambda i: fn(*sets[i]), len(sets),
                               calls=calls)
        else:
            row[key] = row[key + "_warm"]


def _grad_ms(row: dict, key: str, fwd, inputs: list, grad_out,
             sets: list) -> None:
    """Library yardstick of a backward: the time of ``fwd`` plus its
    backward (``torch.autograd.grad`` w.r.t. ``inputs``) less that of
    ``fwd`` alone, warm and cold as ``_time_row`` does.  ``fwd`` and
    ``inputs`` take one input set."""
    both = {}
    _time_row(both, {
        "fb": lambda *s: torch.autograd.grad(fwd(*s), inputs(*s), grad_out),
        "f": lambda *s: fwd(*s)}, sets)
    row[key + "_warm"] = both["fb_warm"] - both["f_warm"]
    row[key] = both["fb"] - both["f"]


def phase_rmsnorm(gen: torch.Generator, failures: list) -> dict:
    main = None
    worst = 0.0
    eps = 1e-5
    for shape in RMS_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            D = shape[-1]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randn((D,), generator=gen, device="cuda").to(dtype)
            got = krms.rmsnorm_cuda(x, w, eps)
            want = ref.rmsnorm_ref(x, w, eps)
            torch.cuda.synchronize()
            ok, err = _close(got, want, TOL[dtype])
            worst = max(worst, err)
            n_bytes = 2 * x.numel() * x.element_size() + D * w.element_size()
            is_main = tuple(shape) == RMS_MAIN and dtype == torch.bfloat16
            cold = dtype == torch.bfloat16 and (
                is_main or tuple(shape) in RMS_SSM + RMS_SERVE)
            sets = [(x, w)] + ([(x.clone(), w.clone()) for _ in
                               range(cold_sets(n_bytes) - 1)]
                               if cold else [])
            row = {"shape": list(shape), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok}
            _time_row(row, {
                "ms": lambda x, w: krms.rmsnorm_cuda(x, w, eps),
                "plain_ms": lambda x, w: ref.rmsnorm_ref(x, w, eps),
                "library_ms": lambda x, w: F.rms_norm(x, (D,), w, eps)},
                sets)
            del sets
            row["bound_ms"], row["bound_by"] = _bound(
                n_bytes, 3 * x.numel(), dtype)
            log("rmsnorm", json.dumps(row))
            if not ok:
                failures.append(f"rmsnorm {shape} {dtype}: max err {err}")
            if is_main:
                main = row
    return dict(main, max_abs_err=worst)


def _flash_mask(Sq, Sk, causal, window, q_off, kv_len):
    q_pos = q_off + torch.arange(Sq, device="cuda")[:, None]
    k_pos = torch.arange(Sk, device="cuda")[None, :]
    m = k_pos < (Sk if kv_len is None else kv_len)
    if causal:
        m = m & (k_pos <= q_pos)
    if window:
        m = m & (k_pos > q_pos - window)
    return m


def _sdpa_inputs(q, k, v):
    """SDPA's layout (B, H, S, D) with K/V repeated to Hq heads."""
    G = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2), k.repeat_interleave(G, dim=2).transpose(1, 2),
            v.repeat_interleave(G, dim=2).transpose(1, 2))


def phase_flash(gen: torch.Generator, failures: list) -> dict:
    main = None
    worst = 0.0
    for case in FLASH_CASES + [FLASH_MAIN, FLASH_ZAMBA2] + FLASH_SERVE:
        B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len = case
        kw = dict(causal=causal, sliding_window=window, q_offset=q_off,
                  kv_len=kv_len)
        mask = _flash_mask(Sq, Sk, causal, window, q_off, kv_len)
        # the work this call needs: (query, key) pairs that are visible,
        # and the key rows that at least one query can see
        pairs = int(mask.sum())
        keys = int(mask.any(0).sum())
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((B, S, H, D), generator=gen,
                                   device="cuda").to(dtype)
                       for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
            got = kflash.flash_attention_cuda(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            ok, err = _close(got, want, TOL[dtype])
            worst = max(worst, err)
            n_bytes = (2 * q.numel() + 2 * B * keys * Hkv * D) \
                * q.element_size()
            is_main = case == FLASH_MAIN and dtype == torch.bfloat16
            cold = dtype == torch.bfloat16 and case in [
                FLASH_MAIN, FLASH_ZAMBA2] + FLASH_SERVE
            sets = [(q, k, v)] + ([tuple(t.clone() for t in (q, k, v))
                                   for _ in range(cold_sets(n_bytes) - 1)]
                                  if cold else [])
            sets = [s + _sdpa_inputs(*s) for s in sets]
            row = {"case": list(case), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok}
            # library yardstick: SDPA with the same boolean mask (timed
            # only; the port never calls it)
            _time_row(row, {
                "ms": lambda q, k, v, *_: kflash.flash_attention_cuda(
                    q, k, v, **kw),
                "plain_ms": lambda q, k, v, *_: ref.flash_attention_ref(
                    q, k, v, **kw),
                "library_ms": lambda q, k, v, qt, kt, vt:
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask)},
                sets)
            del sets
            row["bound_ms"], row["bound_by"] = _bound(
                n_bytes, 4.0 * B * Hq * pairs * D, dtype)
            log("flash", json.dumps(row))
            if not ok:
                failures.append(f"flash {case} {dtype}: max err {err}")
            if is_main:
                main = row
    return dict(main, max_abs_err=worst)


def phase_rmsnorm_bwd(gen: torch.Generator, failures: list) -> dict:
    """The backward kernel (dx, dw) against the plain backward, both fed
    the plain forward's ``inv``; the forward's ``inv`` checked too."""
    main = None
    worst = 0.0
    eps = 1e-5
    for shape in RMS_TRAIN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            D = shape[-1]
            x, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            w = torch.randn((D,), generator=gen, device="cuda").to(dtype)
            _, inv = krms.rmsnorm_cuda(x, w, eps, return_inv=True)
            _, inv_ref = ref.rmsnorm_fwd_ref(x, w, eps)
            got = krms.rmsnorm_bwd_cuda(x, w, inv_ref, g)
            want = ref.rmsnorm_bwd_ref(x, w, inv_ref, g)
            torch.cuda.synchronize()
            ok, err = _close(inv, inv_ref, TOL[torch.float32])
            for a, b in zip(got, want):
                ok_i, err_i = _close(a, b, TOL[dtype])
                ok, err = ok and ok_i, max(err, err_i)
            worst = max(worst, err)
            n_bytes = (3 * x.numel() * x.element_size() + 2 * D
                       * w.element_size() + 4 * inv.numel())
            is_main = tuple(shape) == RMS_MAIN and dtype == torch.bfloat16
            sets = [(x, w, inv_ref, g)] + (
                [tuple(t.clone() for t in (x, w, inv_ref, g))
                 for _ in range(cold_sets(n_bytes) - 1)] if is_main else [])
            row = {"shape": list(shape), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok}
            _time_row(row, {
                "ms": lambda x, w, inv, g: krms.rmsnorm_bwd_cuda(x, w, inv,
                                                                 g),
                "plain_ms": lambda x, w, inv, g: ref.rmsnorm_bwd_ref(
                    x, w, inv, g)}, sets)
            lib_sets = [(x.clone().requires_grad_(),
                         w.clone().requires_grad_()) for x, w, _, _ in sets]
            _grad_ms(row, "library_ms",
                     lambda x, w: F.rms_norm(x, (D,), w, eps),
                     lambda x, w: (x, w), g, lib_sets)
            del sets, lib_sets
            row["bound_ms"], row["bound_by"] = _bound(
                n_bytes, 8 * x.numel(), dtype)
            log("rmsnorm_bwd", json.dumps(row))
            if not ok:
                failures.append(f"rmsnorm_bwd {shape} {dtype}: max err {err}")
            if is_main:
                main = row
    return dict(main, max_abs_err=worst)


def phase_flash_bwd(gen: torch.Generator, failures: list) -> dict:
    """The forward's ``lse`` against the plain forward's, and the backward
    kernels (dq, dk, dv) against the plain backward on the same out, lse
    and dout, at the training shape and the CASES; at the training shape
    also the forward writing ``lse`` timed (row "flash_lse")."""
    main = None
    worst = worst_lse = 0.0
    for case in FLASH_CASES + [FLASH_TRAIN]:
        B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len = case
        kw = dict(causal=causal, sliding_window=window, q_offset=q_off,
                  kv_len=kv_len)
        mask = _flash_mask(Sq, Sk, causal, window, q_off, kv_len)
        pairs = int(mask.sum())
        keys = int(mask.any(0).sum())
        for dtype in (torch.bfloat16, torch.float32):
            q, do = (torch.randn((B, Sq, Hq, D), generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((B, Sk, Hkv, D), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            _, lse = kflash.flash_attention_cuda(q, k, v, return_lse=True,
                                                 **kw)
            o, lse_ref = ref.flash_attention_fwd_ref(q, k, v, **kw)
            got = kflash.flash_attention_bwd_cuda(q, k, v, o, lse_ref, do,
                                                  **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse_ref, do, **kw)
            torch.cuda.synchronize()
            ok, err_lse = _close(lse, lse_ref, TOL[dtype])
            err = 0.0
            for a, b in zip(got, want):
                ok_i, err_i = _close(a, b, TOL[dtype])
                ok, err = ok and ok_i, max(err, err_i)
            worst, worst_lse = max(worst, err), max(worst_lse, err_lse)
            n_bytes = ((4 * q.numel() + 4 * B * keys * Hkv * D)
                       * q.element_size() + 4 * lse.numel())
            is_main = case == FLASH_TRAIN and dtype == torch.bfloat16
            inputs = (q, k, v, o, lse_ref, do)
            sets = [inputs] + ([tuple(t.clone() for t in inputs)
                                for _ in range(cold_sets(n_bytes) - 1)]
                               if is_main else [])
            row = {"case": list(case), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "lse_max_abs_err": err_lse, "ok": ok}
            _time_row(row, {
                "ms": lambda q, k, v, o, lse, do:
                    kflash.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                    **kw),
                "plain_ms": lambda q, k, v, o, lse, do:
                    ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)},
                sets)
            # library yardstick: SDPA with K/V repeated to Hq heads (timed
            # only; the port never calls it); causal self-attention as
            # is_causal, any other mask as a boolean mask
            plain_causal = (causal and Sq == Sk and not window and not q_off
                            and kv_len is None)
            lib_sets = [tuple(t.detach().requires_grad_() for t in
                              _sdpa_inputs(*st[:3])) for st in sets]
            _grad_ms(row, "library_ms",
                     lambda qt, kt, vt: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=plain_causal,
                         attn_mask=None if plain_causal else mask),
                     lambda qt, kt, vt: (qt, kt, vt), do.transpose(1, 2),
                     lib_sets)
            row["bound_ms"], row["bound_by"] = _bound(
                n_bytes, 10.0 * B * Hq * pairs * D, dtype)
            if is_main:
                # device time of each of the backward's kernels in one call
                row["split"] = _profile(
                    lambda: kflash.flash_attention_bwd_cuda(*inputs, **kw),
                    pick=("flash_bwd",))["picked"]
            log("flash_bwd", json.dumps(row))
            if not ok:
                failures.append(f"flash bwd/lse {case} {dtype}: max err "
                                f"{err}, lse {err_lse}")
            if is_main:
                main = row
                fwd = {"case": list(case), "dtype": str(dtype)[6:]}
                # the training forward: the same kernel writing lse too
                sets = [st[:3] + _sdpa_inputs(*st[:3]) for st in sets]
                _time_row(fwd, {
                    "ms": lambda q, k, v, *_: kflash.flash_attention_cuda(
                        q, k, v, return_lse=True, **kw),
                    "plain_ms": lambda q, k, v, *_:
                        ref.flash_attention_fwd_ref(q, k, v, **kw),
                    "library_ms": lambda q, k, v, qt, kt, vt:
                        F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True)},
                    sets)
                fwd["bound_ms"], fwd["bound_by"] = _bound(
                    (2 * q.numel() + 2 * B * keys * Hkv * D)
                    * q.element_size() + 4 * lse.numel(),
                    4.0 * B * Hq * pairs * D, dtype)
            del sets, lib_sets
    log("flash_lse", json.dumps(dict(fwd, max_abs_err=worst_lse)))
    return dict(main, max_abs_err=worst)


def phase_cross_entropy(gen: torch.Generator, failures: list) -> dict:
    """The CE kernel's per-token (nll, lse) against the plain blockwise
    statistics, timed at the loss head's shape in bf16.  Its 524 MB vocab
    matrix is ten times L2, so its warm time is its cold time."""
    main = None
    worst = 0.0
    for shape in CE_SHAPES:
        T, D, V = shape
        for dtype in (torch.bfloat16, torch.float32):
            h = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((V, D), generator=gen, device="cuda")
                 * D ** -0.5).to(dtype)
            t = torch.randint(0, V, (T,), generator=gen, device="cuda")
            got = kce.cross_entropy_cuda(h, w, t)
            want = ref.cross_entropy_stats_ref(h, w, t, block_v=8192)
            torch.cuda.synchronize()
            ok, err = True, 0.0
            for a, b in zip(got, want):
                ok_i, err_i = _close(a, b, TOL[dtype])
                ok, err = ok and ok_i, max(err, err_i)
            worst = max(worst, err)
            row = {"shape": list(shape), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok}
            is_main = shape == CE_MAIN and dtype == torch.bfloat16
            if is_main:
                # library yardstick: logits by cuBLAS, then cross_entropy
                _time_row(row, {
                    "ms": lambda h, w, t: kce.cross_entropy_cuda(h, w, t),
                    "plain_ms": lambda h, w, t: ref.cross_entropy_stats_ref(
                        h, w, t, block_v=8192),
                    "library_ms": lambda h, w, t: F.cross_entropy(
                        torch.matmul(h, w.t()).float(), t,
                        reduction="none")}, [(h, w, t)], calls=3)
                n_bytes = ((T + V) * D * h.element_size() + 8 * T
                           + 8 * T)
                row["bound_ms"], row["bound_by"] = _bound(
                    n_bytes, 2.0 * T * V * D, dtype)
                main = row
            log("cross_entropy", json.dumps(row))
            if not ok:
                failures.append(f"cross_entropy {shape} {dtype}: max err "
                                f"{err}")
            del h, w
    return dict(main, max_abs_err=worst)


def _ssd_inputs(gen: torch.Generator, case, dtype):
    """The inputs of tests/test_kernels.py's SSD sweep, on the card."""
    B, S, H, P, G, N, _ = case

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return ((rn(B, S, H, P) * 0.5).to(dtype), F.softplus(rn(B, S, H)),
            -torch.exp(rn(H) * 0.3), (rn(B, S, G, N) * 0.3).to(dtype),
            (rn(B, S, G, N) * 0.3).to(dtype))


def _ssd_work(case, x_bytes: int):
    """(bytes, FLOPs) one SSD call needs: x, dt, B and C read once, y and
    the final state written once; C Bᵀ once per group over the causal
    (i, j) pairs of each chunk, the intra-chunk product over those pairs,
    the inter-chunk output and the state update."""
    B, S, H, P, G, N, Q = case
    pairs = sum(q * (q + 1) // 2 for q in
                [Q] * (S // Q) + ([S % Q] if S % Q else []))
    n_bytes = (2 * B * S * H * P * x_bytes + 4 * B * S * H
               + 2 * B * S * G * N * x_bytes + 4 * B * H * P * N)
    flops = (2.0 * B * G * pairs * N + 2.0 * B * H * pairs * P
             + 4.0 * B * H * S * N * P)
    return n_bytes, flops


def phase_ssd(gen: torch.Generator, failures: list) -> dict:
    """The SSD kernel's y and final state against ``ssd_ref`` on every
    case and dtype, the models' shapes timed cold and warm; then two calls
    chained through ``init_state`` against one call over the whole."""
    main = None
    worst = 0.0
    for case in SSD_CASES:
        chunk = case[-1]
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, A, Bm, Cm = _ssd_inputs(gen, case, dtype)
            got = kssd.ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk,
                                return_state=True)
            want = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk,
                               return_state=True)
            torch.cuda.synchronize()
            ok, err = True, 0.0
            for a, b in zip(got, want):
                ok_i, err_i = _close(a, b, SSD_TOL[dtype])
                ok, err = ok and ok_i, max(err, err_i)
            worst = max(worst, err)
            row = {"case": list(case), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok}
            del got, want
            n_bytes, flops = _ssd_work(case, x.element_size())
            model = case in (SSD_ZAMBA2, SSD_MAMBA2)
            if model and dtype == torch.bfloat16:
                inputs = (x, dt, A, Bm, Cm)
                sets = [inputs] + [tuple(t.clone() for t in inputs)
                                   for _ in range(cold_sets(n_bytes) - 1)]
                _time_row(row, {
                    "ms": lambda *t: kssd.ssd_cuda(*t, chunk=chunk,
                                                   return_state=True),
                    "plain_ms": lambda *t: ref.ssd_ref(*t, chunk=chunk,
                                                       return_state=True)},
                    sets, calls=4)
                del sets
                row["library_ms"] = None  # no PyTorch call computes it
                if case == SSD_ZAMBA2:
                    main = row
            row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops, dtype)
            log("ssd", json.dumps(row))
            if not ok:
                failures.append(f"ssd {case} {dtype}: max err {err}")
            del x, dt, A, Bm, Cm
    # two calls chained through the state against one over the whole
    case, cut = (2, 300, 8, 64, 1, 64, 128), 137
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, Bm, Cm = _ssd_inputs(gen, case, dtype)
        h0 = torch.randn((2, 8, 64, 64), generator=gen, device="cuda") * 0.1
        y1, h1 = kssd.ssd_cuda(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                               Cm[:, :cut], chunk=128, init_state=h0,
                               return_state=True)
        y2, h2 = kssd.ssd_cuda(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                               Cm[:, cut:], chunk=128, init_state=h1,
                               return_state=True)
        want_y, want_h = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=128,
                                     init_state=h0, return_state=True)
        torch.cuda.synchronize()
        ok_y, err_y = _close(torch.cat([y1, y2], 1), want_y, SSD_TOL[dtype])
        ok_h, err_h = _close(h2, want_h, SSD_TOL[dtype])
        worst = max(worst, err_y, err_h)
        log("ssd_chain", json.dumps({
            "case": list(case), "cut": cut, "dtype": str(dtype)[6:],
            "max_abs_err": max(err_y, err_h), "ok": ok_y and ok_h}))
        if not (ok_y and ok_h):
            failures.append(f"ssd init_state chain {dtype}: y err {err_y}, "
                            f"state err {err_h}")
    return dict(main, max_abs_err=worst)


def serving_launches(cfg, gen: int) -> dict:
    """Kernel launches one ``run_serving`` with ``gen`` tokens implies: the
    norms of ``gen`` forwards (one prefill, gen - 1 decode steps); flash
    attention and the SSD scan in the prefill only (decode runs the plain
    ``_attention_kvseq`` and ``ssd_decode``)."""
    L = cfg.num_layers
    attn = {"dense": L, "moe": L, "ssm": 0,
            "hybrid": L // max(cfg.attn_every, 1)}[cfg.family]
    ssd = 0 if cfg.family in ("dense", "moe") else L
    # dense and moe: ln1, ln2 a block; mamba: ln and the gated norm a
    # block; the shared block: ln1, ln2 an application; ln_f
    norms = 2 * L + (2 * attn if cfg.family == "hybrid" else 0) + 1
    return {"rmsnorm": norms * gen, "flash_attention": attn,
            "ssd_scan": ssd}


def _config(arch: str, layers=None):
    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def phase_serving(failures: list, arch: str = ARCH, prompt: int = PROMPT,
                  label: str = "serving", layers=None,
                  batch: int = BATCH) -> dict:
    krms.launches = kflash.launches = kssd.launches = 0
    res = serve.run_serving(arch, smoke=False, prompt_len=prompt, gen=GEN,
                            batch=batch, device=DEVICE, num_layers=layers)
    counts = {"rmsnorm": krms.launches, "flash_attention": kflash.launches,
              "ssd_scan": kssd.launches}
    cfg = _config(arch, layers)
    want = serving_launches(cfg, GEN)
    tok = res.pop("tokens")
    in_range = bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
    log(label, json.dumps(dict(res, prompt=prompt, batch=batch,
                               kv_cache_dtype=cfg.kv_cache_dtype,
                               launches=counts, expected_launches=want,
                               tokens_in_range=in_range)))
    if counts != want:
        failures.append(f"{arch} launch counts {counts} != expected {want}")
    if not in_range or tuple(tok.shape) != (batch, GEN):
        failures.append(f"{arch} bad tokens: shape {tuple(tok.shape)}")
    return counts


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@contextlib.contextmanager
def _recording_routes(routes: list):
    """Records each ``layers.moe_block`` call's routing (experts, kept
    pairs) into ``routes`` while the block runs as it would."""
    block = layers.moe_block

    def recorded(p, cfg, run, x):
        r = layers.moe_route(p, cfg, x)
        routes.append((r.experts, r.keep))
        return block(p, cfg, run, x)

    layers.moe_block = recorded
    try:
        yield routes
    finally:
        layers.moe_block = block


def phase_end_to_end(failures: list, arch: str = ARCH, prompt: int = PROMPT,
                     label: str = "end_to_end", layers=None,
                     batch: int = BATCH):
    """(a) prefill logits through the kernels against the plain versions;
    (b) decode at position S against a prefill of S + 1.  For an MoE
    arch, (a) runs at the config's capacity factor (the share of (token,
    expert) pairs it drops and the top-K choices that differ between the
    two paths are logged) and (b) at E / K, where C >= S and nothing
    drops: a longer prefill can drop its last token from an overflowing
    expert, decode (C = 1 a row) never does."""
    cfg = _config(arch, layers)
    moe = cfg.family == "moe"
    cfg_d = (cfg.replace(moe_capacity_factor=cfg.num_experts
                         / cfg.num_experts_per_tok) if moe else cfg)
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    params = serve.init_params(cfg, 1, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt + 1),
                         generator=g, device=dev)
    max_len = prompt + GEN + 8
    kern, plain = RunConfig(), RunConfig(use_kernels=False)
    routes_k, routes_p = [], []
    with torch.inference_mode():
        cache = engine.init_cache(cfg, batch, max_len, dev)
        with _recording_routes(routes_k):
            lk, cache = registry.prefill(params, cfg, kern,
                                         {"tokens": toks[:, :prompt]}, cache)
        with _recording_routes(routes_p):
            lp, _ = registry.prefill(params, cfg, plain,
                                     {"tokens": toks[:, :prompt]},
                                     engine.init_cache(cfg, batch, max_len,
                                                       dev))
        if moe:
            _, cache = registry.prefill(
                params, cfg_d, kern, {"tokens": toks[:, :prompt]},
                engine.init_cache(cfg, batch, max_len, dev))
        ld, _ = registry.decode(params, cfg_d, kern, toks[:, prompt:], cache,
                                prompt)
        ll, _ = registry.prefill(params, cfg_d, kern, {"tokens": toks},
                                 engine.init_cache(cfg, batch, max_len, dev))
        del cache
        # a yardstick for (a), not a check: the plain path with the same
        # weights in f32 (f32 activations; the KV cache as configured),
        # where the f32 copy fits beside the bf16 weights
        f32_bytes = sum(4 * t.numel() for t in P.tree_leaves(params))
        free = torch.cuda.mem_get_info()[0]
        lf = None
        if f32_bytes + F32_MARGIN_BYTES <= free:
            lf, _ = registry.prefill(
                P.cast_tree(params, torch.float32), cfg, plain,
                {"tokens": toks[:, :prompt]},
                engine.init_cache(cfg, batch, max_len, dev))
    finite = all(bool(torch.isfinite(t).all()) for t in (lk, lp, ld, ll))
    a = _rel_l2(lk[:, -1], lp[:, -1])
    b = _rel_l2(ld[:, -1], ll[:, -1])
    row = {"arch": arch, "layers": cfg.num_layers, "batch": batch,
           "prompt": prompt, "kv_cache_dtype": cfg.kv_cache_dtype,
           "kernel_vs_plain_prefill_rel_l2": a,
           "decode_vs_longer_prefill_rel_l2": b, "logits_finite": finite,
           "tol": E2E_TOL}
    if lf is None:
        row["f32_yardstick"] = (f"skipped: the f32 copy needs {f32_bytes} B, "
                                f"{free} B free")
    else:
        row["kernel_vs_f32_plain_rel_l2"] = _rel_l2(lk[:, -1], lf[:, -1])
        row["plain_vs_f32_plain_rel_l2"] = _rel_l2(lp[:, -1], lf[:, -1])
    if moe:
        kept = sum(int(k.sum()) for _, k in routes_k)
        pairs = sum(k.numel() for _, k in routes_k)
        row.update(
            capacity_factor=cfg.moe_capacity_factor,
            decode_check_capacity_factor=cfg_d.moe_capacity_factor,
            prefill_dropped_pair_share=1 - kept / pairs,
            routing_flips_kernel_vs_plain=sum(
                int((ek != ep).any(-1).sum())
                for (ek, _), (ep, _) in zip(routes_k, routes_p)),
            routed_tokens=sum(ek.shape[0] * ek.shape[1]
                              for ek, _ in routes_k))
    row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(label, json.dumps(row))
    if not finite:
        failures.append(f"{arch}: non-finite logits")
    if not a <= E2E_TOL:
        failures.append(f"{arch}: kernel vs plain prefill rel L2 {a} > "
                        f"{E2E_TOL}")
    if not b <= E2E_TOL:
        failures.append(f"{arch}: decode vs prefill rel L2 {b} > {E2E_TOL}")
    return params, toks[:, :prompt]


def _profile(fn, top: int = 8, ops: bool = False, pick=()) -> dict:
    """Wall time of ``fn`` (synchronised), the device time of the kernels
    the profiler saw inside it, their ratio (busy share), the top kernels,
    with ``ops`` the top operators by device time, and the kernels whose
    names hold one of ``pick`` (device ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    out = {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
           "busy_share": dev_us / 1e3 / (wall * 1e3),
           "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                   for e in kernels[:top]]}
    if pick:
        out["picked"] = [[e.key[:60], e.self_device_time_total / 1e3,
                          e.count] for e in kernels
                         if any(p in e.key for p in pick)]
    if ops:
        aten = sorted((e for e in events if e.device_type == DeviceType.CPU
                       and e.key.startswith("aten::")
                       and e.self_device_time_total > 0),
                      key=lambda e: e.self_device_time_total, reverse=True)
        out["top_ops"] = [[e.key, e.self_device_time_total / 1e3, e.count]
                          for e in aten[:top]]
    return out


def phase_breakdown(params, prompt: torch.Tensor, arch: str = ARCH,
                    label: str = "breakdown", layers=None,
                    ops: bool = False) -> None:
    """Where the time goes in one warm prefill and four warm decode steps
    on the kernel path (torch.profiler; the shapes ran before, so cuBLAS
    and the allocator are warm); with ``ops`` the top operators too."""
    cfg = _config(arch, layers)
    run = RunConfig()
    B, S = prompt.shape
    max_len = S + GEN + 8
    with torch.inference_mode():
        cache = engine.init_cache(cfg, B, max_len, torch.device(DEVICE))
        box = {}

        def prefill():
            box["tok"], _ = engine.prefill_step(
                params, {"tokens": prompt}, cache, cfg=cfg, run=run)

        def decode4():
            tok = box["tok"]
            for i in range(4):
                tok, _ = engine.decode_step(params, tok, cache, S + i,
                                            cfg=cfg, run=run)

        log(label + "_prefill", json.dumps(_profile(prefill, ops=ops)))
        log(label + "_decode4", json.dumps(_profile(decode4, ops=ops)))


def _eager_ms(fn, reps: int = 5) -> float:
    """Time of one call of ``fn`` as the serving loop runs it (eager, the
    host's launches included): CUDA events around ``reps`` calls after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def phase_serving_parts(params, cfg, batch: int, prompt: int,
                        label: str) -> None:
    """The parts of a layer that no kernel of the port computes, timed
    alone on layer 0's weights (plain torch, as the JAX package computes
    them in jnp): for an MoE arch the routing, the three expert products
    and the whole block, at the prefill's (batch, prompt) tokens and a
    decode step's (batch, 1), with the expert products' bound; for an
    int8 cache a quantisation of one layer's new K (prefill, decode) and
    a dequantisation of one layer's whole K cache."""
    g = torch.Generator(device=DEVICE).manual_seed(17)
    row = {"arch": cfg.name, "layers": cfg.num_layers}
    with torch.inference_mode():
        if cfg.family == "moe":
            p = P.layer(params["blocks"]["moe"], 0)
            E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
            act = layers.act_fn(cfg.act)
            for tag, S in (("prefill", prompt), ("decode", 1)):
                x = torch.randn((batch, S, d), generator=g, device=DEVICE,
                                dtype=torch.bfloat16)
                C = layers.moe_route(p, cfg, x).capacity
                xe = torch.randn((E, batch * C, d), generator=g,
                                 device=DEVICE, dtype=torch.bfloat16)

                def experts():
                    h = act(torch.bmm(xe, p["w_gate"])) * torch.bmm(
                        xe, p["w_up"])
                    return torch.bmm(h, p["w_down"])

                n_bytes = 2 * (3 * E * d * f + 2 * E * batch * C * d)
                bound, by = _bound(n_bytes, 6.0 * E * batch * C * d * f,
                                   torch.bfloat16)
                row[tag] = {
                    "tokens": batch * S, "capacity": C,
                    "route_ms": _eager_ms(
                        lambda: layers.moe_route(p, cfg, x)),
                    "experts_ms": _eager_ms(experts),
                    "experts_bound_ms": bound, "experts_bound_by": by,
                    "block_ms": _eager_ms(
                        lambda: layers.moe_block(p, cfg, RunConfig(), x))}
        if cfg.kv_cache_dtype == "int8":
            shp = (batch, prompt + GEN + 8, cfg.num_kv_heads, cfg.head_dim)
            cache = layers.quantize_kv(torch.randn(
                shp, generator=g, device=DEVICE, dtype=torch.bfloat16))
            k_new = torch.randn((batch, prompt) + shp[2:], generator=g,
                                device=DEVICE, dtype=torch.bfloat16)
            row["int8"] = {
                "quantize_prefill_k_ms": _eager_ms(
                    lambda: layers.quantize_kv(k_new)),
                "quantize_decode_k_ms": _eager_ms(
                    lambda: layers.quantize_kv(k_new[:, :1])),
                "dequantize_cache_k_ms": _eager_ms(
                    lambda: layers.dequantize_kv(*cache)),
                "cache_shape": list(shp)}
    log(label, json.dumps(row))


TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd", "cross_entropy")


def training_launches(layers: int, steps: int) -> dict:
    """Kernel launches of ``steps`` training steps: per step, with remat
    "full" or "dots", each block's forward runs twice (the forward, then
    the recompute in the backward); ln_f is outside the checkpointed
    blocks; one CE call."""
    L = layers
    return {k: n * steps for k, n in zip(TRAIN_KERNELS, (
        2 * L + 1 + 2 * L, 2 * L + 1, 2 * L, L, 1))}


def reset_launches() -> None:
    for mod in (krms, kflash, kce, kssd):
        mod.launches = 0
    krms.bwd_launches = kflash.bwd_launches = 0


def read_launches() -> dict:
    return {"rmsnorm": krms.launches, "rmsnorm_bwd": krms.bwd_launches,
            "flash_attention": kflash.launches,
            "flash_attention_bwd": kflash.bwd_launches,
            "cross_entropy": kce.launches}


def _timed_run(failures: list, label: str, layers: int, steps: int,
               **kw) -> tuple:
    """One ``run_training`` at full width and ``layers`` layers, counted
    (launch counters reset just before, read just after, held against
    ``training_launches``), its losses checked finite, and timed through
    ``on_step``.  Returns (result, launches, step stamps, start time)."""
    stamps = []

    def on_step(i, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    reset_launches()
    t0 = time.perf_counter()
    res = train.run_training(
        ARCH, smoke=False, num_layers=layers, steps=steps, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, device=DEVICE, on_step=on_step, **kw)
    counts = read_launches()
    want = training_launches(layers, res["steps"])
    if counts != want:
        failures.append(f"{label} launch counts {counts} != {want}")
    if res["steps"] != steps or not all(
            torch.isfinite(torch.tensor(res["losses"]))):
        failures.append(f"{label}: {res['steps']} steps, losses "
                        f"{res['losses']}")
    return res, counts, stamps, t0


def phase_training(failures: list) -> tuple:
    """The training path at full width and depth, counted and timed; then
    one more step (warm) under the profiler."""
    cfg = get_config(ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the allocator's retries (a cudaMalloc that failed, the cache freed,
    # then retried), cumulative, at the points of this phase
    retries = {"before": torch.cuda.memory_stats()["num_alloc_retries"]}
    L = cfg.num_layers
    res, counts, stamps, t0 = _timed_run(failures, "training", L,
                                         TRAIN_STEPS, carousel=False)
    peak = torch.cuda.max_memory_allocated()
    retries["after_run_training"] = torch.cuda.memory_stats()[
        "num_alloc_retries"]
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log("training", json.dumps({
        "arch": ARCH, "layers": L, "steps": res["steps"],
        "tokens_per_step": tokens, "losses": res["losses"],
        "first_step_s": stamps[0] - t0 if stamps else None,
        "step_s_2_3": steps_s,
        "tokens_per_s": tokens / statistics.mean(steps_s),
        "wall_s": res["wall_s"], "peak_mem_bytes": peak,
        "opt_state_dtype": train.default_run_config(
            cfg, TRAIN_STEPS).opt_state_dtype,
        "launches": counts,
        "expected_launches": training_launches(L, TRAIN_STEPS)}))

    run = train.default_run_config(cfg, TRAIN_STEPS)
    batch = registry.synth_inputs(
        torch.Generator(device=DEVICE).manual_seed(TRAIN_STEPS), cfg,
        ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), "train",
        device=DEVICE)
    step_fn = tstep.make_train_step(cfg, run)
    state = res.pop("state")
    row = _profile(lambda: step_fn(state, batch), top=15, ops=True,
                   pick=("flash_fwd", "flash_bwd", "rmsnorm_bwd",
                         "rmsnorm_dw", "ce_fwd", "ce_merge"))
    retries["after_profiled_step"] = torch.cuda.memory_stats()[
        "num_alloc_retries"]
    # the step's two halves, each timed alone (synchronised), in
    # HALF_STEPS more warm steps
    row["grads_and_metrics_ms"], row["adamw_update_ms"] = [], []
    for _ in range(HALF_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, _ = tstep.grads_and_metrics(state["params"], cfg, run, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        adamw_update(state["params"], grads, state["opt"],
                     lr=run.learning_rate, weight_decay=run.weight_decay,
                     max_grad_norm=run.max_grad_norm)
        torch.cuda.synchronize()
        row["grads_and_metrics_ms"].append((t1 - t0) * 1e3)
        row["adamw_update_ms"].append((time.perf_counter() - t1) * 1e3)
        del grads
    retries["after_halves"] = torch.cuda.memory_stats()["num_alloc_retries"]
    row["num_alloc_retries"] = retries
    log("breakdown_train_step", json.dumps(row))
    del state, res, batch
    torch.cuda.empty_cache()
    return counts, steps_s


def _tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def phase_training_end_to_end(failures: list) -> None:
    """One ``grads_and_metrics`` through the kernels against one through
    the plain versions, at full width and E2E_TRAIN_LAYERS layers."""
    cfg = get_config(ARCH).replace(num_layers=E2E_TRAIN_LAYERS)
    dev = torch.device(DEVICE)
    params = serve.init_params(cfg, 11, dev)
    batch = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(12), cfg,
        ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), "train",
        device=dev)
    run = train.default_run_config(cfg, TRAIN_STEPS)
    gk, mk = tstep.grads_and_metrics(params, cfg, run, batch)
    gp, mp = tstep.grads_and_metrics(params, cfg,
                                     run.replace(use_kernels=False), batch)
    lk, lp = float(mk["loss"]), float(mp["loss"])
    loss_rel = abs(lk - lp) / abs(lp)
    rel = {name: _rel_l2(a, b) for (name, a), (_, b) in
           zip(_tree_items(gk), _tree_items(gp))}
    finite = all(bool(torch.isfinite(g).all()) for g in P.tree_leaves(gk))
    log("end_to_end_training", json.dumps({
        "layers": E2E_TRAIN_LAYERS, "loss_kernels": lk, "loss_plain": lp,
        "loss_rel": loss_rel, "loss_tol": LOSS_TOL, "grad_rel_l2": rel,
        "grad_tol": E2E_TOL, "grads_finite": finite}))
    if not loss_rel <= LOSS_TOL:
        failures.append(f"training loss kernels {lk} vs plain {lp}")
    bad = {k: r for k, r in rel.items() if not r <= E2E_TOL}
    if bad or not finite:
        failures.append(f"training grads rel L2 > {E2E_TOL}: {bad}, "
                        f"finite={finite}")
    del params, gk, gp
    torch.cuda.empty_cache()


def _carousel_row(res: dict) -> dict:
    car = res["carousel"]
    return {"time_to_first_batch_s": res["time_to_first_batch_s"],
            "delivery_first_batch_s": car["time_to_first_batch_s"],
            "next_wait_s": car["next_wait_s"], "reads": car["reads"],
            "failed_reads": car["failed_reads"], "hedges": car["hedges"],
            "shards_landed": car["shards_landed"],
            "rows_delivered": car["rows_delivered"],
            "rows_received": car["rows_received"],
            "skipped_shards": car["skipped_shards"]}


def phase_training_carousel(failures: list, training_steps_s: list) -> list:
    """``run_training`` as its default runs it, on the carousel (8 shards,
    4 drives, 1 ms a tape read, fault rate 0.02), at full width and depth:
    counted and timed as phase "training" is."""
    cfg = get_config(ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts, stamps, t0 = _timed_run(
        failures, "training_carousel", cfg.num_layers, TRAIN_STEPS,
        carousel=True)
    peak = torch.cuda.max_memory_allocated()
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row = dict(_carousel_row(res), arch=ARCH, layers=cfg.num_layers,
               steps=res["steps"], losses=res["losses"],
               first_step_s=stamps[0] - t0, step_s_2_3=steps_s,
               training_step_s_2_3=training_steps_s,
               tokens_per_s=tokens / statistics.mean(steps_s),
               wall_s=res["wall_s"], peak_mem_bytes=peak, launches=counts,
               expected_launches=training_launches(cfg.num_layers,
                                                   TRAIN_STEPS))
    log("training_carousel", json.dumps(row))
    if row["rows_delivered"] < TRAIN_STEPS * TRAIN_BATCH or \
            row["rows_received"] < row["rows_delivered"]:
        failures.append(f"training_carousel rows: delivered "
                        f"{row['rows_delivered']}, received "
                        f"{row['rows_received']}")
    del res
    torch.cuda.empty_cache()
    return [counts]


def phase_carousel_fine_vs_coarse(failures: list) -> list:
    """Time to the first batch with fine delivery against coarse, the
    tape slow (one drive, 0.4 s a shard): coarse waits for all 8 shards.
    Full width, E2E_TRAIN_LAYERS layers."""
    out, all_counts = {}, []
    for coarse in (False, True):
        mode = "coarse" if coarse else "fine"
        res, counts, stamps, t0 = _timed_run(
            failures, f"carousel_{mode}", E2E_TRAIN_LAYERS,
            FINE_COARSE["steps"], carousel=True, coarse=coarse,
            tape_latency=FINE_COARSE["tape_latency"],
            drives=FINE_COARSE["drives"])
        out[mode] = dict(_carousel_row(res), losses=res["losses"],
                         step_s=[b - a for a, b in zip(stamps, stamps[1:])])
        all_counts.append(counts)
        del res
    gap = (out["coarse"]["time_to_first_batch_s"]
           - out["fine"]["time_to_first_batch_s"])
    log("carousel_fine_vs_coarse", json.dumps(dict(
        out, layers=E2E_TRAIN_LAYERS, **FINE_COARSE, gap_s=gap,
        min_gap_s=FINE_COARSE_GAP_S)))
    if not gap > FINE_COARSE_GAP_S:
        failures.append(f"coarse's first batch only {gap} s after fine's")
    torch.cuda.empty_cache()
    return all_counts


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, int):
        return a == int(b)
    return a.dtype == b.dtype and torch.equal(a, b)


def phase_checkpoint_resume(failures: list) -> list:
    """CKPT_STEPS carousel-fed steps saving every CKPT_EVERY into a
    temporary directory, then a resume for CKPT_RESUME_STEPS more; the
    newest checkpoint of the first run, loaded onto the card, against the
    state it saved; one step from each on the same batch.  Full width,
    E2E_TRAIN_LAYERS layers."""
    import tempfile

    from repro_torch.ckpt import latest_step, load_checkpoint

    cfg = get_config(ARCH).replace(num_layers=E2E_TRAIN_LAYERS)
    run = train.default_run_config(cfg, CKPT_STEPS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as out:
        r1, c1, _, _ = _timed_run(failures, "checkpoint_run", cfg.num_layers,
                                  CKPT_STEPS, out_dir=out,
                                  ckpt_every=CKPT_EVERY)
        state = r1.pop("state")
        newest = latest_step(out)
        step_dir = Path(out) / f"step_{newest:08d}"
        disk_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded, meta = load_checkpoint(out, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        equal = _tree_equal(state, loaded)
        # one step from the loaded state and one from the state in memory
        loaded["opt"]["step"] = int(loaded["opt"]["step"])
        batch = registry.synth_inputs(
            torch.Generator(device=DEVICE).manual_seed(21), cfg,
            ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), "train",
            device=DEVICE)
        step_fn = tstep.make_train_step(cfg, run)
        _, m_loaded = step_fn(loaded, batch)
        _, m_mem = step_fn(state, batch)
        loss_diff = float(m_loaded["loss"]) - float(m_mem["loss"])
        del loaded, state, batch
        torch.cuda.empty_cache()
        r2, c2, _, _ = _timed_run(failures, "checkpoint_resume",
                                  cfg.num_layers, CKPT_RESUME_STEPS,
                                  out_dir=out, ckpt_every=CKPT_EVERY,
                                  resume=True)
        del r2["state"]
        kept = sorted(p.name for p in Path(out).iterdir())
    ck = r1["checkpoint"]
    log("checkpoint_resume", json.dumps({
        "layers": cfg.num_layers, "steps": CKPT_STEPS,
        "ckpt_every": CKPT_EVERY, "newest_step": newest,
        "meta_step": meta["step"], "leaves_equal": equal,
        "loss_loaded_minus_in_memory": loss_diff,
        "bytes_on_disk": disk_bytes, "bytes_written": ck["bytes_written"],
        "saves": len(ck["copy_s"]), "host_copy_s": ck["copy_s"],
        "writer_s": ck["write_s"], "load_s": load_s,
        "resume_final_step": r2["final_step"],
        "resume_losses": r2["losses"],
        "resume_host_copy_s": r2["checkpoint"]["copy_s"],
        "resume_writer_s": r2["checkpoint"]["write_s"],
        "kept_after_resume": kept}))
    if newest != CKPT_STEPS or meta["step"] != CKPT_STEPS:
        failures.append(f"checkpoint: newest step {newest}, meta "
                        f"{meta['step']}")
    if not equal:
        failures.append("checkpoint: loaded leaves differ from the state "
                        "at the save")
    if r2["final_step"] != CKPT_STEPS + CKPT_RESUME_STEPS:
        failures.append(f"resume: final step {r2['final_step']}")
    torch.cuda.empty_cache()
    return [c1, c2]


def phase_remat_dots(failures: list) -> list:
    """``remat="dots"`` at full width and E2E_TRAIN_LAYERS layers: one
    ``grads_and_metrics`` through the kernels against the plain path and
    against "full" through the kernels, launches equal to "full"'s; then
    step time, peak memory and allocator retries of "full" and "dots" at
    REMAT_LAYERS, and one profiled step of each."""
    cfg = get_config(ARCH).replace(num_layers=E2E_TRAIN_LAYERS)
    dev = torch.device(DEVICE)
    params = serve.init_params(cfg, 13, dev)
    batch = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(14), cfg,
        ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), "train",
        device=dev)
    run = train.default_run_config(cfg, TRAIN_STEPS)
    out, counts = {}, {}
    for key, r in (("dots", run.replace(remat="dots")),
                   ("full", run.replace(remat="full")),
                   ("dots_plain", run.replace(remat="dots",
                                              use_kernels=False))):
        reset_launches()
        out[key] = tstep.grads_and_metrics(params, cfg, r, batch)
        counts[key] = read_launches()
    (gd, md), (gf, mf), (gp, mp) = out["dots"], out["full"], out["dots_plain"]
    ld, lf, lp = float(md["loss"]), float(mf["loss"]), float(mp["loss"])
    rel_plain = {n: _rel_l2(a, b) for (n, a), (_, b) in
                 zip(_tree_items(gd), _tree_items(gp))}
    rel_full = {n: _rel_l2(a, b) for (n, a), (_, b) in
                zip(_tree_items(gd), _tree_items(gf))}
    finite = all(bool(torch.isfinite(g).all()) for g in P.tree_leaves(gd))
    want = training_launches(E2E_TRAIN_LAYERS, 1)
    row = {"layers": E2E_TRAIN_LAYERS, "loss_dots": ld, "loss_full": lf,
           "loss_dots_plain": lp, "loss_rel_plain": abs(ld - lp) / abs(lp),
           "loss_tol": LOSS_TOL, "grad_rel_l2_plain": rel_plain,
           "grad_tol": E2E_TOL, "grad_rel_l2_full": rel_full,
           "loss_dots_minus_full": ld - lf, "grads_finite": finite,
           "launches_dots": counts["dots"], "launches_full": counts["full"],
           "expected_launches": want}
    del params, batch, out, gd, gf, gp
    torch.cuda.empty_cache()
    if not row["loss_rel_plain"] <= LOSS_TOL:
        failures.append(f"remat dots loss kernels {ld} vs plain {lp}")
    bad = {k: r for k, r in rel_plain.items() if not r <= E2E_TOL}
    if bad or not finite:
        failures.append(f"remat dots grads rel L2 > {E2E_TOL}: {bad}, "
                        f"finite={finite}")
    if not counts["dots"] == counts["full"] == want:
        failures.append(f"remat dots launches {counts['dots']}, full "
                        f"{counts['full']}, expected {want}")

    # step time and peak memory, one state for both
    cfg = get_config(ARCH).replace(num_layers=REMAT_LAYERS)
    run = train.default_run_config(cfg, REMAT_STEPS)
    state = tstep.init_state(
        torch.Generator(device=dev).manual_seed(run.seed), cfg, run)
    batch = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(15), cfg,
        ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), "train",
        device=dev)
    for remat in ("full", "dots"):
        step_fn = tstep.make_train_step(cfg, run.replace(remat=remat))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries = torch.cuda.memory_stats()["num_alloc_retries"]
        times, losses = [], []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            _, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        row[f"{remat}_step_s"] = times
        row[f"{remat}_losses"] = losses
        row[f"{remat}_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        row[f"{remat}_alloc_retries"] = torch.cuda.memory_stats()[
            "num_alloc_retries"] - retries
        # one more step under the profiler: wall against device time
        prof = _profile(lambda: step_fn(state, batch), top=4)
        row[f"{remat}_profiled"] = {k: prof[k] for k in (
            "wall_ms", "device_ms", "busy_share", "top")}
    row["timed_layers"] = REMAT_LAYERS
    log("remat_dots", json.dumps(row))
    del state, batch
    torch.cuda.empty_cache()
    return []  # its launches are comparisons, not the main path's


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()
    nvcc = subprocess.run([str(Path(CUDA_HOME) / "bin" / "nvcc"),
                           "--version"], capture_output=True, text=True,
                          check=True, timeout=60)
    log("device:", smi, "| torch", torch.__version__, "| cuda",
        torch.version.cuda, "|", nvcc.stdout.strip().splitlines()[-1])

    # the build's log, printed by ninja, holds ptxas' register counts
    t0 = time.perf_counter()
    ext = build.extension(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s")
    # registers, spills, shared memory and resident blocks a SM of the
    # redesigned kernels, as the CUDA runtime reports them
    kernel_info = [dict(zip(("name", "registers", "local_bytes",
                             "static_smem", "dynamic_smem", "threads",
                             "blocks_per_sm"), [name] + list(vals)))
                   for name, vals in ext.kernel_info()]

    failures: list = []
    spilling = [k["name"] for k in kernel_info if k["local_bytes"]]
    if spilling:
        failures.append(f"kernels use local memory: {spilling}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    rms_main = phase_rmsnorm(gen, failures)
    flash_main = phase_flash(gen, failures)
    rms_bwd_main = phase_rmsnorm_bwd(gen, failures)
    flash_bwd_main = phase_flash_bwd(gen, failures)
    ce_main = phase_cross_entropy(gen, failures)
    ssd_main = phase_ssd(gen, failures)
    log(f"kernel phases: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    counts = [phase_serving(failures)]
    log(f"serving phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    params, prompt = phase_end_to_end(failures)
    log(f"end-to-end phase: {time.perf_counter() - t0:.2f} s")
    phase_breakdown(params, prompt)
    del params, prompt
    for arch in SSM_ARCHS:
        tag = arch.split("-")[0]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts.append(phase_serving(failures, arch, SSM_PROMPT,
                                    f"serving_{tag}"))
        params, prompt = phase_end_to_end(failures, arch, SSM_PROMPT,
                                          f"end_to_end_{tag}")
        phase_breakdown(params, prompt, arch, f"breakdown_{tag}")
        del params, prompt
        log(f"{arch} phases: {time.perf_counter() - t0:.2f} s")
    for arch, n_layers, batch, prompt_len in SERVE_ARCHS:
        tag = "_".join(arch.split("-")[:2]).replace(".", "_")
        kw = dict(layers=n_layers, batch=batch)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts.append(phase_serving(failures, arch, prompt_len,
                                    f"serving_{tag}", **kw))
        params, prompt = phase_end_to_end(failures, arch, prompt_len,
                                          f"end_to_end_{tag}", **kw)
        phase_breakdown(params, prompt, arch, f"breakdown_{tag}",
                        layers=n_layers, ops=True)
        phase_serving_parts(params, _config(arch, n_layers), batch,
                            prompt_len, f"parts_{tag}")
        del params, prompt
        log(f"{arch} phases: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_counts, train_steps_s = phase_training(failures)
    log(f"training phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_training_end_to_end(failures)
    log(f"end-to-end training phase: {time.perf_counter() - t0:.2f} s")
    for name, phase, args in (
            ("training_carousel", phase_training_carousel, (train_steps_s,)),
            ("carousel_fine_vs_coarse", phase_carousel_fine_vs_coarse, ()),
            ("checkpoint_resume", phase_checkpoint_resume, ()),
            ("remat_dots", phase_remat_dots, ())):
        t0 = time.perf_counter()
        counts += phase(failures, *args)
        log(f"{name} phase: {time.perf_counter() - t0:.2f} s")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(name=name, route="cuda", source=csrc + source,
             replaces=replaces,
             launches=sum(c.get(name, 0) for c in counts + [train_counts]),
             **{k: row[k] for k in keys})
        for name, source, replaces, row in (
            ("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25",
             rms_main),
            ("rmsnorm_bwd", "rmsnorm.cu", "src/repro/kernels/ref.py:60",
             rms_bwd_main),
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:80", flash_main),
            ("flash_attention_bwd", "flash_attention.cu",
             "src/repro/kernels/ref.py:188", flash_bwd_main),
            ("cross_entropy", "cross_entropy.cu",
             "src/repro/kernels/cross_entropy.py:56", ce_main),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:71",
             ssd_main))]
    log(f"total: {time.perf_counter() - t_start:.2f} s")
    log(smi)
    log(json.dumps({"kernel_info": kernel_info}))
    log(json.dumps({"kernels": kernels}))
    if failures:
        for f in failures:
            print("FAILED:", f, file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
