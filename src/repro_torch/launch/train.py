"""Training entry point on synthetic batches, the PyTorch twin of
``repro/launch/train.py::run_training`` with ``carousel=False``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --full \
        --steps 3 --seq-len 512 --global-batch 4 --no-carousel

One card holds the model, so there is no mesh and there are no sharding
rules.  Weights are random, drawn on the device from a seeded generator;
batch ``i`` comes from ``synth_inputs`` with seed ``i``, as the JAX entry
point draws it from ``PRNGKey(i)``.  The carousel-fed input pipeline,
checkpoints and resume are not ported yet (ROADMAP A4) and raise.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.configs.base import (RunConfig, ShapeConfig, get_config,
                                      get_smoke_config)
from repro_torch.launch.serve import resolve_device
from repro_torch.models import registry
from repro_torch.train.step import init_state, make_train_step


def _batch_iter_synth(cfg, shape, device) -> Iterator[Dict[str, Any]]:
    i = 0
    while True:
        gen = torch.Generator(device=device).manual_seed(i)
        yield registry.synth_inputs(gen, cfg, shape, "train", device=device)
        i += 1


def default_run_config(cfg, steps: int) -> RunConfig:
    """The run config ``run_training`` takes when given none (that of the
    JAX entry point)."""
    return RunConfig(total_steps=max(steps, 10), warmup_steps=2,
                     ce_block_v=max(64, cfg.vocab_size // 8))


def run_training(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 20,
    seq_len: int = 64,
    global_batch: int = 4,
    out_dir: Optional[str] = None,
    resume: bool = False,
    carousel: bool = True,
    coarse: bool = False,
    ckpt_every: int = 10,
    tape_latency: float = 0.001,
    drives: int = 4,
    run: Optional[RunConfig] = None,
    on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Trains ``steps`` steps on synthetic batches and returns the JAX
    entry point's result keys.  ``coarse``, ``ckpt_every``, ``tape_latency``
    and ``drives`` belong to the carousel and checkpoints, which are not
    ported yet: ``carousel=True``, ``out_dir`` and ``resume`` raise."""
    if carousel or out_dir is not None or resume:
        raise NotImplementedError(
            "the carousel-fed input pipeline, checkpoints and resume are "
            "not ported yet (ROADMAP A4); pass carousel=False and no "
            "out_dir")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = ShapeConfig("train", seq_len, global_batch, "train")
    run = run or default_run_config(cfg, steps)
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, run)
    state = init_state(torch.Generator(device=dev).manual_seed(run.seed),
                       cfg, run)
    batches = _batch_iter_synth(cfg, shape, dev)

    losses: List[float] = []
    t0 = time.time()
    ttfb = None
    done = 0
    for batch in batches:
        if done >= steps:
            break
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if ttfb is None:
            ttfb = time.time() - t0
        losses.append(loss)
        done += 1
        if on_step:
            on_step(done, {"loss": loss})
    return {
        "arch": arch,
        "steps": len(losses),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "losses": losses,
        "time_to_first_batch_s": ttfb,
        "wall_s": time.time() - t0,
        "final_step": done,
        "state": state,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--out")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-carousel", dest="carousel", action="store_false")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run_training(args.arch, smoke=args.smoke, steps=args.steps,
                       seq_len=args.seq_len, global_batch=args.global_batch,
                       out_dir=args.out, resume=args.resume,
                       carousel=args.carousel, device=args.device)
    res.pop("state")
    res.pop("losses")
    print(res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
