"""The readings the limits of ``correct`` are set from, on the chip, many
seeds in one process (the benchmark's own runs never run this):

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        [--program] [--control] [--fault top1] [--int8-cache] [--keep] \
        [--seconds 12]

``--program``: the cell's numbers as a run computes them (the program's
set-up steps or a short window at the cell's load, then the reference).
``--control``: the same numbers with the reference, computed in fp8
(e4m3 operands, e5m2 gradients, a scale a tensor, f32 sums), in the
program's place: the precision below the configurations' bfloat16; for
a training cell also the faults of a loss taken over half of the batch
and of a step that leaves the state unchanged, planted in the reference
in the program's place.  A serving cell's ``--control`` reads the fp8
reference's logits at the positions of the program's own prompts and
served tokens (their relative gap, and the gap of the token it puts
first) and its first layer's V; ``--fault`` the same of the reference
with a fault of its family (``top1``: MoE routing with each token's
second expert dropped); ``--int8-cache`` runs the program once more with
its own int8 KV cache, the program's path one precision below.
``--keep`` counts the (token, expert) pairs the program's MoE routing
drops for want of capacity, at prefill and at decode.  A cell of more
than one card runs as its ranks (``ranks.py``), each number at its
worst over them.  One JSON line a seed.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def corpus_batches(cell, seed: int, n: int):
    """``n`` batches of the mix's rows taken in shard order from the
    reference's own packing of the corpus."""
    import numpy as np
    from perfbench import corpus
    from perfbench.reference import packing
    t, c = cell.traffic, cell.config["model"]
    cp, rows, s = t["corpus"], [], 0
    while len(rows) < n * t["rows"]:
        p = packing.pack(corpus.shard_docs(
            seed, s, cp["docs_per_shard"], c["vocab_size"],
            cp["mean_doc_len"]), t["seq_len"])
        rows += [{k: v[r] for k, v in p.items()}
                 for r in range(p["tokens"].shape[0])]
        s += 1
    R = t["rows"]
    return [{k: np.stack([r[k] for r in rows[i * R:(i + 1) * R]])
             for k in rows[0]} for i in range(n)]


def train_control(cell, seed: int, dev) -> dict:
    from perfbench import train_cell
    batches = corpus_batches(cell, seed, cell.traffic["check_steps"])
    ref = train_cell.reference_readings(cell, seed, dev, batches)
    out = {"ref_loss": ref["loss"]}
    for name, kw in (("fp8", dict(mode="fp8")),
                     ("half_batch", dict(fault="half_batch")),
                     ("frozen", dict(fault="frozen"))):
        got = train_cell.reference_readings(cell, seed, dev, batches, **kw)
        out[name] = train_cell.compare(got, ref)
        out[name + "_detail"] = train_cell.explain(got, ref)
    return out


def count_keep() -> dict:
    """Wraps the port's ``layers.moe_assign`` to count the pairs routed
    and the pairs it drops (``keep`` False), prefill (rows of more than
    one token) and decode apart; the counts stay on the device."""
    import repro_torch.models.layers as layers
    real = layers.moe_assign
    tally = {}

    def counted(cfg, gates, top_e):
        r = real(cfg, gates, top_e)
        k = "prefill" if top_e.shape[1] > 1 else "decode"
        tally[k + "_pairs"] = tally.get(k + "_pairs", 0) + r.keep.numel()
        tally[k + "_dropped"] = tally.get(k + "_dropped", 0) \
            + (~r.keep).sum()
        return r
    layers.moe_assign = counted
    return tally


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--int8-cache", action="store_true")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import bench, harness, program, ranks
    bench.set_cache_env()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = bench.cell(args.workload)
    if cell.chips > 1 and not ranks.is_rank():
        return ranks.launch([sys.executable, os.path.abspath(__file__)]
                            + list(argv if argv is not None
                                   else sys.argv[1:]), cell.chips, t_start)
    prog = program.load()
    dev = prog.resolve_device("cuda")
    if cell.chips > 1:
        ranks.join(prog.init_distributed)
    first = ranks.rank() == 0
    tally = count_keep() if args.keep else None
    serve = cell.traffic["kind"] == "serve"
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": args.workload, "seed": seed}
        t0 = time.perf_counter()
        if tally is not None:
            tally.clear()
        if args.program or (serve and (args.control or args.fault)):
            kw = dict(control="fp8") if serve and args.control else {}
            if serve and args.fault:
                kw["fault"] = args.fault
            rec = harness.run_cell(
                cell, prog, dev, seed=seed, seconds=args.seconds,
                trace=False, t_start=time.perf_counter(), **kw)
            harness.gather_ranks(rec)
            line["program"] = rec.check
            line["detail"] = rec.detail
            line["batches"] = [b["len"] for b in rec.batches]
            del rec
        if serve and args.int8_cache:
            gc.collect()
            torch.cuda.empty_cache()
            rec = harness.run_cell(
                cell, prog, dev, seed=seed, seconds=args.seconds,
                trace=False, t_start=time.perf_counter(),
                kv_cache_dtype="int8")
            harness.gather_ranks(rec)
            line["int8_cache"] = rec.check
            del rec
        if args.control and not serve:
            line["control"] = train_control(cell, seed, dev)
        if tally is not None:
            line["keep"] = {k: int(v) for k, v in tally.items()}
        line["seconds"] = time.perf_counter() - t0
        if first:
            print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    import torch.distributed as dist
    if cell.chips > 1:
        dist.destroy_process_group()
        ranks.leave(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
