"""Cells cut to a size the CPU runs in seconds, for the harness's tests:
the same files, with the port's smoke widths and a small mix."""
from __future__ import annotations

import copy
import time

import torch

from perfbench import bench, harness, program

SMOKE = {
    "dense": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=256),
    # the port's mixtral smoke widths, at capacity factor E / K: a
    # smoke batch's few tokens would overflow 1.25, and the reference is
    # dropless (at the cell's sizes 1.25 drops nothing)
    "moe": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=256, num_experts=4,
                num_experts_per_tok=2, moe_capacity_factor=2.0),
    "zamba2": dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                   head_dim=16, d_ff=128, vocab_size=256, ssm_state=16,
                   ssm_head_dim=16, ssm_chunk=32, attn_every=2),
}


def smoke_cell(name: str) -> bench.Cell:
    return shrink(bench.cell(name))


def shrink(cell: bench.Cell) -> bench.Cell:
    cell = copy.deepcopy(cell)
    cell.config["model"].update(SMOKE[cell.config["reference"]])
    t = cell.traffic
    if t["kind"] == "train":
        t.update(rows=2, seq_len=64, trace_steps=1)
        t["corpus"].update(shards=48, mean_doc_len=32)
    else:
        t.update(clients=2, prompt_lens=[16, 24, 32], gen_tokens=4,
                 check_requests=4, check_longest=2, trace_batches=1)
    return cell


def run(cell: bench.Cell, seed: int = 7, seconds: float = 0.5,
        trace: bool = False) -> dict:
    dev = torch.device("cpu")
    rec = harness.run_cell(cell, program.load(), dev, seed=seed,
                           seconds=seconds, trace=trace,
                           t_start=time.perf_counter())
    return harness.result(rec, trace, dev)
