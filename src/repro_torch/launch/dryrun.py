"""Dry run: count every (arch x shape) cell's FLOPs, bytes and peak memory
on one H100, and its roofline terms.  The twin of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out cells.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \\
        --shape prefill_32k --run-overrides '{"remat": "none"}'

The JAX dry run lowers and compiles each cell for a TPU mesh on fake host
devices and walks the compiled HLO.  This one builds the step as
``lower_cell`` does (train through ``make_train_step``; prefill with a
cache of ``seq_len + num_img_patches + 8``; decode with the cache at
``seq_len``), with params, optimizer state, cache and inputs on the meta
device, and runs it once under ``launch/cost.py``'s counter: shapes and
dtypes only, so it needs no card, touches no device and allocates
nothing, on any machine.  That is the design, not a fallback.  A cell is
the whole global batch on one card (``chips`` 1), so its peak may well
exceed the card's 80 GB: the count says by how much.

The cell keeps the JAX contract's keys (``tests/test_dryrun_cli.py``):
``hlo_flops`` and ``hlo_bytes`` keep their names but are dispatch counts
(``cost.py``, kernel mode; ``count_cell(..., mode="plain")`` counts the
plain path op by op, as ``hlo_cost`` counts the JAX program);
``collective_total`` is 0 on one card.  The ``memory`` dict gives the
arguments' bytes, the outputs' (each storage once, aliases of the
arguments included, as XLA counts donated outputs), the counted peak,
and the peak less the arguments and the outputs that are new as
``temp_bytes``.  ``--multi-pod`` and ``--both-meshes`` wait for the
device mesh (ROADMAP A9).  The JAX dry run's unrolled build of one cell
(``scan_layers``, an XLA workaround) has no counterpart: the port's
layers are a Python loop.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (ModelConfig, RunConfig, SHAPES,
                                      ShapeConfig, all_cells,
                                      cell_is_runnable, get_config)
from repro_torch.launch import cost
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.optim import adamw_init
from repro_torch.serve import engine
from repro_torch.train import step as train_step_lib


def count_cell(cfg: ModelConfig, shape: ShapeConfig,
               run: Optional[RunConfig] = None, *,
               max_len: Optional[int] = None,
               mode: str = "kernel") -> Dict[str, Any]:
    """Counts one step of ``shape.kind`` at ``cfg`` and ``shape`` on the
    meta device (``cost.analyze``'s keys).  ``max_len``: the cache's
    length, by default ``lower_cell``'s (prefill: ``seq_len`` + the
    patches + 8; decode: ``seq_len``)."""
    run = run or RunConfig()
    params = P.abstract(registry.param_defs(cfg))
    specs = registry.input_specs(cfg, shape)
    B = shape.global_batch
    if shape.kind == "train":
        state = {"params": params,
                 "opt": adamw_init(params,
                                   dtype=getattr(torch, run.opt_state_dtype))}
        fn = train_step_lib.make_train_step(cfg, run)
        return cost.analyze(fn, state, specs, mode=mode)
    with torch.inference_mode():
        if shape.kind == "prefill":
            max_len = max_len or shape.seq_len + cfg.num_img_patches + 8
            cache = engine.abstract_cache(cfg, B, max_len)
            return cost.analyze(engine.prefill_step, params, specs, cache,
                                cfg=cfg, run=run, mode=mode)
        cache = engine.abstract_cache(cfg, B, max_len or shape.seq_len)
        return cost.analyze(engine.decode_step, params, specs["tokens"],
                            cache, specs["pos"], cfg=cfg, run=run, mode=mode)


def run_cell(arch: str, shape_name: str, *,
             run_overrides: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """One cell of the sweep, in the JAX dry run's output contract."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    t0 = time.time()
    try:
        res = count_cell(cfg, shape, RunConfig(**(run_overrides or {})))
        args, outs, peak = (res["argument_bytes"], res["output_bytes"],
                            res["peak_bytes"])
        out = {
            "arch": arch, "shape": shape_name, "kind": shape.kind,
            "n_params": P.param_count(registry.param_defs(cfg)),
            "status": "ok",
            "mesh": "1 card",
            "chips": 1,
            "count_s": round(time.time() - t0, 1),
            "hlo_flops": res["flops"],
            "hlo_bytes": res["hbm_bytes"],
            "collective_bytes": {},
            "collective_total": res["collective_bytes"],
            "calls": res["calls"],
            "memory": {
                "argument_bytes": args,
                "output_bytes": outs,
                "temp_bytes": max(peak - args - res["new_output_bytes"], 0),
                "peak_bytes": peak,
            },
        }
        out["model_flops"] = model_flops(cfg, shape)
        out["roofline"] = roofline_terms(out)
        return out
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def active_params(cfg) -> int:
    """Params touched per token: excludes the input embedding gather; MoE
    counts only the top-k routed experts."""
    defs = registry.param_defs(cfg)
    total = P.param_count(defs)
    emb = int(cfg.vocab_size) * int(cfg.d_model)
    total -= emb  # tok embedding (gather, not matmul)
    if cfg.num_experts and cfg.num_experts_per_tok:
        per_layer_expert = 3 * cfg.d_model * cfg.d_ff  # gate+up+down
        inactive = (cfg.num_experts - cfg.num_experts_per_tok)
        total -= cfg.num_layers * inactive * per_layer_expert
    return int(total)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (fwd-only), N = active params,
    D = tokens processed. Global (all chips)."""
    N = active_params(cfg)
    if shape.kind == "train":
        D = shape.global_batch * shape.seq_len
        return 6.0 * N * D
    if shape.kind == "prefill":
        D = shape.global_batch * shape.seq_len
        return 2.0 * N * D
    return 2.0 * N * shape.global_batch  # decode: one token per sequence


def roofline_terms(cell: Dict[str, Any]) -> Dict[str, Any]:
    """Compute, memory and collective times at the H100's data-sheet
    rates (``launch/mesh.py``), the dominant one, and the useful share of
    the counted FLOPs."""
    chips = cell["chips"]
    flops = cell["hlo_flops"]       # per device
    byts = cell["hlo_bytes"]        # per device
    coll = cell.get("collective_total", 0.0)  # per device
    t_c = flops / mesh_lib.PEAK_FLOPS_BF16
    t_m = byts / mesh_lib.HBM_BW
    t_n = coll / mesh_lib.NVLINK_BW
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_n}
    dom = max(terms, key=terms.get)
    bound = max(t_c, t_m, t_n, 1e-30)
    terms["dominant"] = dom
    terms["bound_s"] = bound
    terms["compute_fraction"] = t_c / bound
    mf = cell.get("model_flops", 0.0)
    terms["useful_flops_ratio"] = mf / (flops * chips) if flops else 0.0
    return terms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--run-overrides", help="JSON dict of RunConfig fields")
    args = ap.parse_args(argv)

    overrides = json.loads(args.run_overrides) if args.run_overrides else None
    if args.all:
        cells = [(a, s) for a, s, _, _ in all_cells()]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    results = []
    n_bad = 0
    for arch, shape in cells:
        r = run_cell(arch, shape, run_overrides=overrides)
        results.append(r)
        status = r["status"]
        line = f"[{status}] {arch} x {shape} chips=1"
        if status == "ok":
            rf = r["roofline"]
            line += (f" flops={r['hlo_flops']:.3e}"
                     f" bytes={r['hlo_bytes']:.3e}"
                     f" peak={r['memory']['peak_bytes']:.3e}"
                     f" dom={rf['dominant'][:-2]}"
                     f" bound={rf['bound_s']*1e3:.1f}ms"
                     f" useful={rf['useful_flops_ratio']:.2f}"
                     f" count={r['count_s']}s")
        elif status == "error":
            n_bad += 1
            line += " " + r["error"]
        else:
            line += f" ({r['reason'][:60]})"
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
