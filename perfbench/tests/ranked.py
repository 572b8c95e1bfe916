"""Targets for the launcher (``perfbench/ranks.py``) on the CPU: one rank
each, started by ``ranks.launch`` with gloo as the port's process group.

    python perfbench/tests/ranked.py cell <cell> <seed> [<fault>]
        one run of a cell cut to smoke size (``smoke.shrink``) over the
        launched ranks, past the harness's look for a chip, with the
        timed path broken by ``fault`` (``FAULTS``) where one is named
    python perfbench/tests/ranked.py window <seconds> <skew>
        batches of 20 ms until rank 0's clock says the window has closed,
        rank r's clock ``r * skew`` seconds ahead of rank 0's; rank 0
        prints every rank's batch count
    python perfbench/tests/ranked.py fail
        rank 1 exits 1 at once, the others wait for a minute
    python perfbench/tests/ranked.py print
        every rank prints its rank on standard output

    python perfbench/tests/ranked.py --ranks <n> <target...>
        launches ``n`` ranks of one of the targets above
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _exchange_left_out():
    """Every sum over the model ranks left out: each rank goes on with
    its own part."""
    import repro_torch.sharding.rules as rules
    rules.leave_model = lambda x: x


def _token_altered():
    import torch
    import repro_torch.models.registry as registry
    real = registry.decode

    def altered(*args):
        logits, cache = real(*args)
        return torch.roll(logits, 1, dims=-1), cache
    registry.decode = altered


def _first_token_altered():
    import torch
    import repro_torch.models.registry as registry
    real = registry.prefill

    def altered(*args):
        logits, cache = real(*args)
        return torch.roll(logits, 3, dims=-1), cache
    registry.prefill = altered


def _top1():
    """Each token's less weighted expert dropped, as a capacity that drops
    every second choice would."""
    import repro_torch.models.layers as layers
    real = layers.moe_assign

    def top1(cfg, gates, top_e):
        r = real(cfg, gates, top_e)
        best = r.weights >= r.weights.amax(dim=-1, keepdim=True)
        return r._replace(keep=r.keep & best)
    layers.moe_assign = top1


FAULTS = {"exchange_left_out": _exchange_left_out,
          "token_altered": _token_altered,
          "first_token_altered": _first_token_altered,
          "top1": _top1}


def run_cell(name: str, seed: int, fault: str = "") -> int:
    import torch
    from perfbench import bench, harness, program, ranks
    from perfbench.tests import smoke
    cell = smoke.shrink(bench.cell(name))
    cell.chips = int(os.environ["WORLD_SIZE"])
    prog = program.load()
    if fault:
        FAULTS[fault]()
    ranks.join(prog.init_distributed)
    dev = torch.device("cpu")
    rec = harness.run_cell(cell, prog, dev, seed=seed, seconds=0.5,
                           trace=False, t_start=ranks.started_at())
    ranks.leave(harness.finish(rec, False, dev))


def window(seconds: float, skew: float) -> int:
    import torch.distributed as dist
    from perfbench import program, ranks
    ranks.join(program.load().init_distributed)
    ahead = dist.get_rank() * skew
    t0 = time.perf_counter() + ahead
    n = 0
    while True:
        time.sleep(0.02)
        n += 1
        if ranks.agree(time.perf_counter() + ahead - t0 >= seconds
                       if dist.get_rank() == 0 else
                       time.perf_counter() + ahead - t0 < seconds):
            break
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, n)
    if dist.get_rank() == 0:
        print(json.dumps({"batches": counts}), flush=True)
    dist.destroy_process_group()
    ranks.leave(0)


def main(argv) -> int:
    if argv[0] == "--ranks":
        from perfbench import ranks
        return ranks.launch([sys.executable, os.path.abspath(__file__)]
                            + argv[2:], int(argv[1]), time.perf_counter())
    what = argv[0]
    if what == "cell":
        return run_cell(argv[1], int(argv[2]), argv[3] if argv[3:] else "")
    if what == "window":
        return window(float(argv[1]), float(argv[2]))
    r = int(os.environ["RANK"])
    if what == "fail":
        if r == 1:
            return 1
        time.sleep(60)
        return 0
    if what == "print":
        print(f"rank {r}", flush=True)
        return 0
    raise ValueError(what)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
