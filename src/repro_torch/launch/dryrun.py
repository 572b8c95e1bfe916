"""Dry run: count every (arch x shape) cell's FLOPs, bytes, collectives
and peak memory per device of the production mesh, and its roofline terms
on the H100.  The twin of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out cells.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \\
        --shape prefill_32k --run-overrides '{"remat": "none"}'

The JAX dry run lowers and compiles each cell for a TPU mesh on fake host
devices and walks the compiled, partitioned HLO of one device.  This one
counts one device directly: it builds the step as ``lower_cell`` does
(train through ``make_train_step``; prefill with a cache of ``seq_len +
num_img_patches + 8``; decode with the cache at ``seq_len``) under
``ShardingRules`` over an abstract mesh (``launch/mesh.py::Mesh`` without
ranks), and runs it once under ``launch/cost.py``'s counter on the meta
device: shapes and dtypes only, so it needs no card and no process
group, touches no device and allocates nothing, on any machine.

The device is the rank at the mesh's coordinate 0 (``Mesh(coords=...)``
names another).  It holds its rows of the batch (``batch`` over ``pod``
and ``data``) and its blocks of the weights, the optimizer moments and
the cache, as ``materialize``, ``init_cache`` and the rules keep them on
a real rank, and runs every split path of the port at the mesh's sizes
(heads, query rows, ``ffn`` columns, vocab rows, SSM heads or head dim,
experts, a KV cache split over positions).  Each collective of the rules
is charged its bytes by kind (``all-reduce``, ``all-gather``,
``reduce-scatter``: ``hlo_cost``'s Σ operand bytes) and not run.  The
same charge counts what a real rank's collectives move
(``sharding.collective_tally``), so the card can check the count.  Every
rank runs the same shapes, so coordinate 0 stands for every device, but
for what depends on the positions a rank holds: its writes into a cache
split over ``kv_seq``, and, where the heads do not divide ``model``, the
visible pairs of its query rows (coordinate 0's causal rows see the
fewest keys).  Without a mesh, ``count_cell`` counts the whole cell on
one card.

A cell keeps the JAX contract's keys (``tests/test_dryrun_cli.py``):
``mesh`` as the JAX run writes it (``"(16, 16)"``, ``"pod2x(2, 16,
16)"``), ``chips`` the mesh's size, and per device ``hlo_flops`` and
``hlo_bytes`` (their names kept, but dispatch counts: ``cost.py``, kernel
mode; ``count_cell(..., mode="plain")`` counts the plain path op by op,
as ``hlo_cost`` counts the JAX program), ``collective_bytes`` by kind,
``collective_total``, and the ``memory`` dict: the arguments' bytes, the
outputs' (each storage once, aliases of the arguments included, as XLA
counts donated outputs), the counted peak, and the peak less the
arguments and the outputs that are new as ``temp_bytes``.  The counted
peak leaves out the scratch the CUDA wrappers allocate and free inside a
call.  ``roofline_terms`` puts the collectives over ``NVLINK_BW``, the
rate of one NVLink domain of 8 cards (one H100 SXM host): a mesh of 256
spans 32 such hosts, whose links between them are slower, so
``collective_s`` is a lower bound there.  The JAX dry run's unrolled build
of one cell (``scan_layers``, an XLA workaround) has no counterpart: the
port's layers are a Python loop.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
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
from repro_torch.sharding import (ShardingRules, batch_split, current_rules,
                                  use_rules)
from repro_torch.train import step as train_step_lib


def count_cell(cfg: ModelConfig, shape: ShapeConfig,
               run: Optional[RunConfig] = None, *, mesh=None,
               max_len: Optional[int] = None,
               mode: str = "kernel") -> Dict[str, Any]:
    """Counts one step of ``shape.kind`` at ``cfg`` and ``shape`` on the
    meta device (``cost.analyze``'s keys).  ``mesh`` None: the whole cell
    on one card (under whatever rules are current).  Else one device of
    ``mesh`` (an abstract ``launch/mesh.py::Mesh``, the rank at its
    ``coords``) under ``ShardingRules(mesh)``: train passes the global
    batch to the step, which takes the rank's rows, with a state of the
    rank's blocks; prefill and decode take the rank's rows and a cache of
    its rows and blocks, as ``launch/serve.py::_serve`` does.
    ``max_len``: the cache's length, by default ``lower_cell``'s (prefill:
    ``seq_len`` + the patches + 8; decode: ``seq_len``)."""
    run = run or RunConfig()
    if mesh is None:
        return _count(cfg, shape, run, max_len, mode)
    with use_rules(ShardingRules(mesh)):
        return _count(cfg, shape, run, max_len, mode)


def _count(cfg, shape, run, max_len, mode) -> Dict[str, Any]:
    params = P.abstract(registry.param_defs(cfg))
    specs = registry.input_specs(cfg, shape)
    if shape.kind == "train":
        state = {"params": params,
                 "opt": adamw_init(params,
                                   dtype=getattr(torch, run.opt_state_dtype))}
        fn = train_step_lib.make_train_step(cfg, run)
        return cost.analyze(fn, state, specs, mode=mode)
    rules = current_rules()
    with torch.inference_mode():
        if shape.kind == "prefill":
            max_len = max_len or shape.seq_len + cfg.num_img_patches + 8
            batch = specs
        else:
            max_len = max_len or shape.seq_len
            batch = {"tokens": specs["tokens"]}
        split = rules.local_batch(batch) if rules else None
        batch, rows, axes = split or (batch, shape.global_batch, ())
        cache = engine.abstract_cache(cfg, rows, max_len)
        with batch_split(rows, axes) if split else contextlib.nullcontext():
            if shape.kind == "prefill":
                return cost.analyze(engine.prefill_step, params, batch,
                                    cache, cfg=cfg, run=run, mode=mode)
            return cost.analyze(engine.decode_step, params, batch["tokens"],
                                cache, specs["pos"], cfg=cfg, run=run,
                                mode=mode)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh=None, run_overrides: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """One cell of the sweep, in the JAX dry run's output contract: one
    device of ``mesh`` (default ``make_production_mesh(multi_pod)``),
    counted per device."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    t0 = time.time()
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    try:
        res = count_cell(cfg, shape, RunConfig(**(run_overrides or {})),
                         mesh=mesh)
        args, outs, peak = (res["argument_bytes"], res["output_bytes"],
                            res["peak_bytes"])
        out = {
            "arch": arch, "shape": shape_name, "kind": shape.kind,
            "n_params": P.param_count(registry.param_defs(cfg)),
            "status": "ok",
            "mesh": (f"{'pod2x' if multi_pod else ''}"
                     f"{tuple(mesh.shape.values())}"),
            "chips": math.prod(mesh.shape.values()),
            "count_s": round(time.time() - t0, 1),
            "hlo_flops": res["flops"],  # per device
            "hlo_bytes": res["hbm_bytes"],  # per device
            "collective_bytes": {k[len("coll_"):]: v for k, v in res.items()
                                 if k.startswith("coll_")},
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
    """Compute, memory and collective times of one device at the H100's
    data-sheet rates (``launch/mesh.py``; the collectives over one NVLink
    domain's rate), the dominant one, and the useful share of the counted
    FLOPs of every device."""
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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
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

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    n_bad = 0
    for mp in meshes:
        mesh = mesh_lib.make_production_mesh(multi_pod=mp)
        for arch, shape in cells:
            r = run_cell(arch, shape, multi_pod=mp, mesh=mesh,
                         run_overrides=overrides)
            results.append(r)
            status = r["status"]
            line = (f"[{status}] {arch} x {shape} "
                    f"mesh={'2x16x16' if mp else '16x16'}")
            if status == "ok":
                rf = r["roofline"]
                line += (f" flops/dev={r['hlo_flops']:.3e}"
                         f" bytes/dev={r['hlo_bytes']:.3e}"
                         f" coll/dev={r['collective_total']:.3e}"
                         f" peak/dev={r['memory']['peak_bytes']:.3e}"
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
