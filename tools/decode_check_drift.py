"""Where the decode check's error comes from in an SSM model, on a GPU.

``chip_smoke.py`` holds decode at position S, from a kernel prefill of S
tokens, against the last position of a kernel prefill of S + 1 tokens
(relative L2 of the logits).  This script repeats that check for one
model at full width and depth (random weights from chip_smoke's seed,
tokens from several seeds) with the SSD scan routed four ways: the bf16
kernel as the model calls it (``tc``); the f32 kernel on x, B and C cast
to f32 (``f32_kernel``); the bf16 kernel over the first S tokens and the
f32 kernel, from the bf16 kernel's state, over the rest of the longer
prefill (``tc_f32_tail``: both sides of the check then carry the same
state, and only the arithmetic at token S differs from decode's); and
the plain ``ssd_ref`` (``plain``); and the RMSNorm forward through its
kernel or the plain version.  Everything
else is the model's own kernel path.  For the SSD routes it also holds,
layer by layer, each call against ``ssd_ref`` on the same inputs: the
final state after S tokens (the state decode carries on) and y at token
S of the longer prefill (the position the check compares).

    python3 tools/decode_check_drift.py [--arch mamba2-130m] [--seeds 4]
    python3 tools/decode_check_drift.py --src <other checkout>/src

``--src`` runs another checkout's package (its kernels build under that
checkout's ``build/``), so two trees can be compared in one call.  Prints
one JSON line a (route, seed) and one summary line a route.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.serve import engine

    if not torch.cuda.is_available():
        print("decode_check_drift: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    S, Bt = args.prompt, args.batch
    params = serve.init_params(cfg, 1, dev)  # chip_smoke's weights
    kern = RunConfig()

    tc_kernel, rms_kernel = kssd.ssd_cuda, krms.rmsnorm_cuda

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    def f32_kernel(x, dt, A, Bm, Cm, **kw):
        out = tc_kernel(x.float(), dt, A, Bm.float(), Cm.float(), **kw)
        return ((out[0].to(x.dtype), out[1]) if isinstance(out, tuple)
                else out.to(x.dtype))

    def tc_f32_tail(x, dt, A, Bm, Cm, **kw):
        y, h = tc_kernel(x, dt, A, Bm, Cm, **kw)
        if x.shape[1] > S:  # S is a whole number of chunks
            _, hS = tc_kernel(x[:, :S], dt[:, :S], A, Bm[:, :S], Cm[:, :S],
                              **kw)
            y[:, S:] = f32_kernel(x[:, S:], dt[:, S:], A, Bm[:, S:],
                                  Cm[:, S:], **dict(kw, init_state=hS))[0]
        return y, h

    def plain(x, dt, A, Bm, Cm, **kw):
        return ref.ssd_ref(x, dt, A, Bm, Cm, **kw)

    per_layer = []  # ("state" or "y_at_S", error) of each call, in order

    def watched(fn):
        def call(x, dt, A, Bm, Cm, **kw):
            out = fn(x, dt, A, Bm, Cm, **kw)
            y, h = out
            ry, rh = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=kw["chunk"],
                                 init_state=kw.get("init_state"),
                                 return_state=True)
            if x.shape[1] == S:
                per_layer.append(("state", rel(h, rh)))
            else:
                per_layer.append(("y_at_S", rel(y[:, S], ry[:, S])))
            return out
        return call

    def rms_plain(x, w, eps=1e-6, **kw):
        return ref.rmsnorm_ref(x, w, eps)

    routes = {"tc": tc_kernel, "f32_kernel": f32_kernel,
              "tc_f32_tail": tc_f32_tail, "plain": plain}
    summary = {}
    for ssd_name, ssd_fn in routes.items():
        for rms_name, rms_fn in (("kernel", rms_kernel),
                                 ("plain", rms_plain)):
            route = f"ssd={ssd_name},rmsnorm={rms_name}"
            kssd.ssd_cuda = watched(ssd_fn) if ssd_name != "plain" else ssd_fn
            krms.rmsnorm_cuda = rms_fn
            checks = []
            for seed in range(7, 7 + args.seeds):
                per_layer.clear()
                g = torch.Generator(device=dev).manual_seed(seed)
                toks = torch.randint(0, cfg.vocab_size, (Bt, S + 1),
                                     generator=g, device=dev)
                max_len = S + 40
                with torch.inference_mode():
                    cache = engine.init_cache(cfg, Bt, max_len, dev)
                    _, cache = registry.prefill(params, cfg, kern,
                                                {"tokens": toks[:, :S]},
                                                cache)
                    ld, _ = registry.decode(params, cfg, kern, toks[:, S:],
                                            cache, S)
                    ll, _ = registry.prefill(
                        params, cfg, kern, {"tokens": toks},
                        engine.init_cache(cfg, Bt, max_len, dev))
                check = rel(ld[:, -1], ll[:, -1])
                checks.append(check)
                row = {"arch": args.arch, "route": route, "seed": seed,
                       "decode_vs_longer_prefill_rel_l2": check}
                if per_layer:
                    for kind in ("state", "y_at_S"):
                        errs = [e for k, e in per_layer if k == kind]
                        row[f"ssd_{kind}_rel_l2_max"] = max(errs)
                        row[f"ssd_{kind}_rel_l2_by_layer"] = errs
                print(json.dumps(row), flush=True)
            summary[route] = checks
            print(json.dumps({"arch": args.arch, "route": route,
                              "checks": checks, "mean": sum(checks)
                              / len(checks)}), flush=True)
    kssd.ssd_cuda, krms.rmsnorm_cuda = tc_kernel, rms_kernel
    print(json.dumps({"arch": args.arch, "src": args.src,
                      "summary_mean": {k: sum(v) / len(v)
                                       for k, v in summary.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
