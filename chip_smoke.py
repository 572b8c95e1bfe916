"""Drives the PyTorch port's serving path on one NVIDIA GPU and holds every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no final result line):

1. device: ``nvidia-smi`` name and power limit, torch / CUDA / nvcc versions;
2. build: every source in ``src/repro_torch/kernels/csrc`` compiled into
   one extension module by ``torch.utils.cpp_extension.load``, with its
   time and ptxas' register counts;
3. kernel against plain: each kernel and its plain version on the same
   inputs, at the main path's shapes and the sweep of tests/test_kernels.py
   (tolerance 2e-2 in bf16, 3e-5 in f32), with the kernel's time, the plain
   version's time and one library call's time (CUDA graph + events,
   median), warm (inputs in L2) and, at the main path's shapes, cold
   (inputs rotated past L2), and the bound of the work the call needs;
4. serving: ``run_serving("yi-6b", smoke=False, prompt_len=512, gen=32,
   batch=4)`` at full width and depth with launch counters reset just
   before and read just after;
5. end to end at full width: (a) prefill logits through the kernels against
   ``use_kernels=False``; (b) decode at position S after a prefill of S
   tokens against a prefill of S + 1 tokens; both at relative L2 <= 5e-2;
6. breakdown: ``torch.profiler`` over one warm prefill and four warm decode
   steps (wall time, device time, busy share, top ops by device time).

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
Weights are random, made on the card from a seed; nothing is downloaded.
"""
from __future__ import annotations

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

from repro_torch.configs.base import RunConfig, get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as krms  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 3e-5}
E2E_TOL = 5e-2
ARCH, PROMPT, GEN, BATCH = "yi-6b", 512, 32, 4
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
RMS_MAIN = (BATCH * PROMPT, 4096)
RMS_SHAPES = [RMS_MAIN, (BATCH, 4096), (8, 128), (3, 7, 384), (1, 513)]


def log(*a) -> None:
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, sets: int = 1, reps: int = 10) -> float:
    """Device time of one call ``fn(i)``, ``i`` in ``range(sets)``: a run
    of calls captured in a CUDA graph, the graph replayed ``reps`` times
    between CUDA events, the median per-call time.  The graph takes the
    host's launch overhead out, so a short kernel is timed by what it
    costs on the card.  With ``sets`` > 1 the calls cycle through that
    many input sets, and each call's output is kept until its set comes
    round again, so a set is evicted from L2 before it is read again."""
    per_graph = sets * -(-10 // sets)
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


def _time_row(row: dict, fns: dict, sets: list) -> None:
    """Adds each of ``fns`` (name -> function of one input set) to ``row``:
    its warm time (``sets[0]`` every call, so it sits in L2) as
    ``<name>_warm`` and, when more than one set is given, its cold time
    (the sets rotated past L2, as HBM serves them) as ``<name>``."""
    for key, fn in fns.items():
        row[key + "_warm"] = time_ms(lambda i: fn(*sets[0]))
        if len(sets) > 1:
            row[key] = time_ms(lambda i: fn(*sets[i]), len(sets))
        else:
            row[key] = row[key + "_warm"]


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
            sets = [(x, w)] + ([(x.clone(), w.clone()) for _ in
                               range(cold_sets(n_bytes) - 1)]
                               if is_main else [])
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
    for case in FLASH_CASES + [FLASH_MAIN]:
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
            sets = [(q, k, v)] + ([tuple(t.clone() for t in (q, k, v))
                                   for _ in range(cold_sets(n_bytes) - 1)]
                                  if is_main else [])
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


def phase_serving(failures: list) -> dict:
    krms.launches = 0
    kflash.launches = 0
    res = serve.run_serving(ARCH, smoke=False, prompt_len=PROMPT, gen=GEN,
                            batch=BATCH, device=DEVICE)
    counts = {"rmsnorm": krms.launches, "flash_attention": kflash.launches}
    cfg = get_config(ARCH)
    want = {"rmsnorm": (2 * cfg.num_layers + 1) * GEN,
            "flash_attention": cfg.num_layers}
    tok = res.pop("tokens")
    in_range = bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
    log("serving", json.dumps(dict(res, launches=counts,
                                   expected_launches=want,
                                   tokens_in_range=in_range)))
    if counts != want:
        failures.append(f"launch counts {counts} != expected {want}")
    if not in_range or tuple(tok.shape) != (BATCH, GEN):
        failures.append(f"bad tokens: shape {tuple(tok.shape)}")
    return counts


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def phase_end_to_end(failures: list):
    cfg = get_config(ARCH)
    dev = torch.device(DEVICE)
    params = serve.init_params(cfg, 1, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT + 1),
                         generator=g, device=dev)
    max_len = PROMPT + GEN + 8
    kern, plain = RunConfig(), RunConfig(use_kernels=False)
    with torch.inference_mode():
        cache = engine.init_cache(cfg, BATCH, max_len, dev)
        lk, cache = registry.prefill(params, cfg, kern,
                                     {"tokens": toks[:, :PROMPT]}, cache)
        lp, _ = registry.prefill(params, cfg, plain,
                                 {"tokens": toks[:, :PROMPT]},
                                 engine.init_cache(cfg, BATCH, max_len, dev))
        ld, _ = registry.decode(params, cfg, kern, toks[:, PROMPT:], cache,
                                PROMPT)
        ll, _ = registry.prefill(params, cfg, kern, {"tokens": toks},
                                 engine.init_cache(cfg, BATCH, max_len, dev))
    finite = all(bool(torch.isfinite(t).all()) for t in (lk, lp, ld, ll))
    a = _rel_l2(lk[:, -1], lp[:, -1])
    b = _rel_l2(ld[:, -1], ll[:, -1])
    log("end_to_end", json.dumps({
        "kernel_vs_plain_prefill_rel_l2": a,
        "decode_vs_longer_prefill_rel_l2": b, "logits_finite": finite,
        "tol": E2E_TOL}))
    if not finite:
        failures.append("non-finite logits")
    if not a <= E2E_TOL:
        failures.append(f"kernel vs plain prefill rel L2 {a} > {E2E_TOL}")
    if not b <= E2E_TOL:
        failures.append(f"decode vs prefill rel L2 {b} > {E2E_TOL}")
    return params, toks[:, :PROMPT]


def _profile(fn, top: int = 8) -> dict:
    """Wall time of ``fn`` (synchronised), the device time of the kernels
    the profiler saw inside it, their ratio (busy share) and the top
    kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "busy_share": dev_us / 1e3 / (wall * 1e3),
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in kernels[:top]]}


def phase_breakdown(params, prompt: torch.Tensor) -> None:
    """Where the time goes in one warm prefill and four warm decode steps
    on the kernel path (torch.profiler; the shapes ran before, so cuBLAS
    and the allocator are warm)."""
    cfg = get_config(ARCH)
    run = RunConfig()
    max_len = PROMPT + GEN + 8
    with torch.inference_mode():
        cache = engine.init_cache(cfg, BATCH, max_len, torch.device(DEVICE))
        box = {}

        def prefill():
            box["tok"], _ = engine.prefill_step(
                params, {"tokens": prompt}, cache, cfg=cfg, run=run)

        def decode4():
            tok = box["tok"]
            for i in range(4):
                tok, _ = engine.decode_step(params, tok, cache, PROMPT + i,
                                            cfg=cfg, run=run)

        log("breakdown_prefill", json.dumps(_profile(prefill)))
        log("breakdown_decode4", json.dumps(_profile(decode4)))


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
    build.extension(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s")

    failures: list = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    rms_main = phase_rmsnorm(gen, failures)
    flash_main = phase_flash(gen, failures)
    t0 = time.perf_counter()
    counts = phase_serving(failures)
    log(f"serving phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    params, prompt = phase_end_to_end(failures)
    log(f"end-to-end phase: {time.perf_counter() - t0:.2f} s")
    phase_breakdown(params, prompt)
    del params

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/kernels/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:25",
             launches=counts["rmsnorm"],
             **{k: rms_main[k] for k in keys}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:80",
             launches=counts["flash_attention"],
             **{k: flash_main[k] for k in keys}),
    ]
    log(f"total: {time.perf_counter() - t_start:.2f} s")
    log(smi)
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
