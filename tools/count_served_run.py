"""Counts one device of a served run, as ``launch/serve.py::run_serving``
runs it on a (data, model) mesh, with the dry run's cost model on the
meta device: no card, no process group.

    PYTHONPATH=src python tools/count_served_run.py --arch mixtral-8x7b \
        --model 4 --batch 1 --prompt-len 4608 [--gen 16] [--layers N] \
        [--data 1] [--coord 0]

The prefill of ``--batch`` x ``--prompt-len`` tokens and one decode step
over the cache ``run_serving`` sizes (prompt, a VLM's patches, ``gen`` and
8 more positions), each counted by ``launch/dryrun.py::count_cell`` at
full width (``--layers`` cuts the depth) for the rank at ``--coord`` of
the model axis, with its roofline terms at the H100's data-sheet rates
(``launch/mesh.py``; the collectives over one NVLink domain).  Prints one
JSON line: per device FLOPs, HBM bytes, collective bytes by kind, the
counted peak, and ``compute_s``, ``memory_s``, ``collective_s`` and the
bound of each part.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402


def _part(res: dict, chips: int) -> dict:
    cell = {"chips": chips, "hlo_flops": res["flops"],
            "hlo_bytes": res["hbm_bytes"],
            "collective_total": res["collective_bytes"]}
    rf = dryrun.roofline_terms(cell)
    return {"flops": res["flops"], "hbm_bytes": res["hbm_bytes"],
            "collective_bytes": {k[len("coll_"):]: v for k, v in res.items()
                                 if k.startswith("coll_")},
            "peak_bytes": res["peak_bytes"], "calls": res["calls"],
            **{k: rf[k] for k in ("compute_s", "memory_s", "collective_s",
                                  "dominant", "bound_s")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--coord", type=int, default=0,
                    help="the counted rank's index on the model axis")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    mesh = Mesh((args.data, args.model), ("data", "model"),
                coords=(0, args.coord))
    extra = cfg.num_img_patches if cfg.family == "vlm" else 0
    max_len = args.prompt_len + extra + args.gen + 8
    pre = dryrun.count_cell(cfg, ShapeConfig(
        "serve", args.prompt_len, args.batch, "prefill"), mesh=mesh,
        max_len=max_len)
    dec = dryrun.count_cell(cfg, ShapeConfig(
        "serve", max_len, args.batch, "decode"), mesh=mesh)
    chips = args.data * args.model
    print(json.dumps({
        "arch": args.arch, "layers": cfg.num_layers,
        "mesh": [args.data, args.model], "coord": args.coord,
        "batch": args.batch, "prompt_len": args.prompt_len,
        "cache_len": max_len, "prefill": _part(pre, chips),
        "decode_step": _part(dec, chips)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
