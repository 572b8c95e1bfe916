"""Times the port's entry points at full size on one GPU in two checkouts
at once, in alternating turns, to compare a parent tree with a change.

Two worker processes stay resident, one a checkout (``--parent`` and
``--change``, each a ``src/`` directory; its kernels build under that
checkout's ``build/``), and take turns on every job: pair i runs parent
then change when i is even, change then parent when it is odd, so both
see the same host and card over the call.  The jobs are the runs whose
times ``chip_smoke.py`` reports:

  serve:<arch>  run_serving(smoke=False, prompt 512 (SSM: 2048), gen 32,
                batch 4): prefill ms and a decode step's ms (decode_s / 31)
  train:<arch>  run_training(smoke=False, steps 3, seq 448 (whisper) or
                2048, global batch 4, no carousel): mean of steps 2-3, ms

After the pairs each worker runs each job once more under
``torch.profiler`` and reports the busy share (the device time of the
kernels over the synchronised wall time) of decode steps 2-31, or of
training steps 2-3.  Prints a JSON line a pair and one summary line
(medians, the share of pairs the change won, busy shares).

    python3 tools/ab_world_one.py --parent build/parent/src [--pairs 10] \
        [--jobs serve:yi-6b serve:mamba2-130m train:whisper-tiny \
         train:mamba2-130m]

Decode and the small models' steps are host-bound: compare trees only
within one call.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JOBS = ["serve:yi-6b", "serve:mamba2-130m", "train:whisper-tiny",
        "train:mamba2-130m"]
SSM = ("mamba2-130m", "zamba2-1.2b")


class _Window:
    """Synchronised time stamps at the marks of a run, and a profiler
    over the window between two of them when ``profile`` is set."""

    def __init__(self, torch, start: int, stop: int, profile: bool):
        self.torch, self.start, self.stop = torch, start, stop
        self.profile, self.prof, self.stamps = profile, None, []

    def mark(self, i: int) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        if self.profile and i == self.start:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            torch.cuda.synchronize()
            self.stamps[-1] = time.perf_counter()
        if self.prof is not None and i == self.stop:
            self.prof.stop()

    def busy(self) -> float:
        from torch.autograd import DeviceType
        dev_us = sum(e.self_device_time_total
                     for e in self.prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
        wall = self.stamps[self.stop] - self.stamps[self.start]
        return dev_us / 1e6 / wall


def _run_job(job: str, profile: bool) -> dict:
    import torch

    from repro_torch.launch import serve, train
    from repro_torch.serve import engine
    kind, arch = job.split(":")
    if kind == "serve":
        gen = 32
        # decode steps 2..31; the timed runs are not synchronised a step
        win = _Window(torch, 1, gen - 1, profile)
        inner = engine.decode_step
        calls = []

        def decode_step(*a, **k):
            win.mark(len(calls))
            calls.append(1)
            out = inner(*a, **k)
            if len(calls) == gen - 1:
                win.mark(len(calls))
            return out
        if profile:
            engine.decode_step = decode_step
        try:
            r = serve.run_serving(
                arch, smoke=False, prompt_len=2048 if arch in SSM else 512,
                gen=gen, batch=4)
        finally:
            engine.decode_step = inner
        out = {"prefill_ms": r["prefill_s"] * 1e3,
               "decode_step_ms": r["decode_s"] / (gen - 1) * 1e3}
    else:
        win = _Window(torch, 1, 3, profile)  # steps 2 and 3
        win.mark(0)
        train.run_training(
            arch, smoke=False, steps=3,
            seq_len=448 if arch == "whisper-tiny" else 2048,
            global_batch=4, carousel=False,
            on_step=lambda i, m: win.mark(i))
        st = win.stamps
        out = {"step_ms": (st[3] - st[1]) / 2 * 1e3}
    if profile:
        out = {"busy_share": win.busy()}
    torch.cuda.empty_cache()
    return out


def worker(src: str) -> int:
    """Answers one JSON line a job on the standard output it was started
    with; whatever else it prints goes to the standard error."""
    import os
    reply = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    sys.path.insert(0, src)
    import torch

    def say(obj) -> None:
        reply.write(json.dumps(obj) + "\n")
        reply.flush()
    say({"ready": src, "device": torch.cuda.get_device_name(0)})
    for line in sys.stdin:
        say(_run_job(*json.loads(line)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="the parent's src/")
    ap.add_argument("--change", default=str(ROOT / "src"))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--jobs", nargs="+", default=JOBS)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    procs = {}
    for tree in ("parent", "change"):
        procs[tree] = subprocess.Popen(
            [sys.executable, __file__, "--parent", args.parent,
             "--worker", str(Path(getattr(args, tree)).resolve())],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def ask(tree: str, job: str, profile: bool = False) -> dict:
        p = procs[tree]
        p.stdin.write(json.dumps([job, profile]) + "\n")
        p.stdin.flush()
        line = p.stdout.readline()
        if not line:
            raise RuntimeError(f"the {tree} worker ended on {job}")
        return json.loads(line)

    try:
        for tree, p in procs.items():
            print(tree, p.stdout.readline().strip(), flush=True)
        runs = {t: {j: [] for j in args.jobs} for t in procs}
        for i in range(args.pairs):
            order = ("parent", "change") if i % 2 == 0 else (
                "change", "parent")
            row = {"pair": i, "order": order}
            for job in args.jobs:
                for tree in order:
                    r = ask(tree, job)
                    runs[tree][job].append(r)
                    row[f"{tree} {job}"] = r
            print(json.dumps(row), flush=True)
        summary = {}
        for job in args.jobs:
            for key in runs["parent"][job][0]:
                a = [r[key] for r in runs["parent"][job]]
                b = [r[key] for r in runs["change"][job]]
                summary[f"{job} {key}"] = {
                    "parent_median": statistics.median(a),
                    "change_median": statistics.median(b),
                    "change_faster_pairs": sum(y < x for x, y in zip(a, b)),
                    "pairs": len(a)}
            for tree in procs:
                summary[f"{job} busy_share {tree}"] = ask(
                    tree, job, True)["busy_share"]
        print("SUMMARY", json.dumps(summary), flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
        for p in procs.values():
            if p.wait(timeout=120) != 0:
                raise RuntimeError(f"a worker exited {p.returncode}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
