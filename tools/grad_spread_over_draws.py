"""How far a smoke model's bf16 gradients through the kernels lie from
the plain path's, over several weight draws, on a GPU.

For each draw it takes one ``grads_and_metrics`` of the smoke config at
2 x 48 tokens through the kernels, through the plain versions, and
through the plain versions in f32 (weights cast to f32, the loss head's
products in f32), and prints, for the leaf that differs most between the
first two, its relative L2 distance kernel-vs-plain, kernel-vs-f32 and
plain-vs-f32; then the leaf whose kernel-vs-f32 distance is largest
against max(plain-vs-f32, ``--floor``), with that ratio (the measure of
``tests/test_torch_cuda.py::test_smoke_encdec_and_vlm_training_on_card``;
a key bias's distances are taken over the value bias's norm, as its
gradient is zero but for rounding).  The draws are ``materialize``'s (a
stacked leaf a layer at a time, seeds 1..N) and, with ``--whole-leaf``,
the whole-leaf draw ``materialize`` made before it drew a layer at a
time.  It shows how far bf16 rounding alone spreads the two paths.

    python3 tools/grad_spread_over_draws.py [--arch whisper-tiny] \
        [--draws 6] [--whole-leaf 3] [--floor 0.01]

Prints one line a draw.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper-tiny")
    ap.add_argument("--draws", type=int, default=6)
    ap.add_argument("--whole-leaf", type=int, default=3)
    ap.add_argument("--floor", type=float, default=0.01)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs.base import (RunConfig, ShapeConfig,
                                          get_smoke_config)
    from repro_torch.launch import serve
    from repro_torch.models import params as P
    from repro_torch.models import registry
    from repro_torch.train import step as tstep

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_smoke_config(args.arch)
    defs = registry.param_defs(cfg)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", v

    def rel(a, b, ref=None):
        ref = b if ref is None else ref
        return float((a.float() - b.float()).norm() / ref.float().norm())

    def one(params, label):
        batch = registry.synth_inputs(
            torch.Generator(device=dev).manual_seed(8), cfg,
            ShapeConfig("t", 48, 2, "train"), device=dev)
        run = RunConfig(ce_block_v=64)
        gk, _ = tstep.grads_and_metrics(params, cfg, run, batch)
        gp, _ = tstep.grads_and_metrics(
            params, cfg, run.replace(use_kernels=False), batch)
        gf, _ = tstep.grads_and_metrics(
            P.cast_tree(params, torch.float32), cfg,
            run.replace(use_kernels=False, ce_dtype="float32"), batch)
        k, p, f = dict(leaves(gk)), dict(leaves(gp)), dict(leaves(gf))
        # a key bias's gradient is zero but for rounding (whisper's bk)
        dist = {n: (rel(k[n], p[n]), rel(k[n], f[n]), rel(p[n], f[n]))
                for n in k if not n.endswith("/bk")}
        name, (kp, kf, pf) = max(dist.items(), key=lambda kv: kv[1][0])
        ref = {n: f[n[:-2] + "bv"] if n.endswith("/bk") else f[n]
               for n in k}
        ratio = {n: rel(k[n], f[n], ref[n]) / max(
            rel(p[n], f[n], ref[n]), args.floor) for n in k}
        worst = max(ratio, key=ratio.get)
        print(f"{label}: worst leaf {name} kernel-vs-plain {kp:.4f} "
              f"kernel-vs-f32 {kf:.4f} plain-vs-f32 {pf:.4f}; largest "
              f"kernel-vs-f32 / max(plain-vs-f32, {args.floor}) "
              f"{ratio[worst]:.3f} at {worst} (kernel-vs-f32 "
              f"{rel(k[worst], f[worst], ref[worst]):.4f}, plain-vs-f32 "
              f"{rel(p[worst], f[worst], ref[worst]):.4f})", flush=True)

    for seed in range(1, args.draws + 1):
        one(serve.init_params(cfg, seed, dev), f"layer-at-a-time draw {seed}")
    for seed in range(1, args.whole_leaf + 1):
        g = torch.Generator(device=dev).manual_seed(seed)
        one(P.tree_map(lambda d: P._init_leaf(d, g, dev), defs),
            f"whole-leaf draw {seed}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
