"""Production trainer: carousel-fed, checkpointed, resumable.  The
PyTorch twin of ``repro/launch/train.py::run_training``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --steps 50 --out /tmp/run1 [--resume] [--no-carousel] [--coarse] \
        [--full] [--device cpu]

The input pipeline is the paper's machinery end to end: a ColdStore
corpus staged by the Stager (retries, hedged stragglers), transformed on
demand into packed sequences, and delivered by the DeliveryIterator as
shards land: training starts when the FIRST shard lands (``--coarse``
waits for all of them, the pre-iDDS baseline).  Each batch is copied to
the card as it is taken.  ``--no-carousel`` trains on synthetic batches
instead: batch ``i`` comes from ``synth_inputs`` with seed ``i``, as the
JAX entry point draws it from ``PRNGKey(i)``.

It trains every family the port registers: the dense archs (yi-6b and
the rest), the MoE archs (mixtral-8x7b, qwen3-moe-235b-a22b),
mamba2-130m (SSM), zamba2-1.2b (hybrid), whisper-tiny (encoder-decoder)
and llava-next-mistral-7b (VLM), on the card through the kernels (the
SSD scan's backward included) or on the CPU through their plain
versions.  whisper's batches carry ``frames`` and llava's
``img_embeds``: from ``synth_inputs`` on synthetic batches, zeros on
the device beside the carousel's tokens, as the JAX entry point's
``_modality_extras`` makes them.  One card holds the model, so
there is no mesh and there are no sharding rules.  Weights are random,
drawn on the device from a seeded generator.  With ``out_dir`` an
AsyncCheckpointer saves the state every ``ckpt_every`` steps and after
the last; ``resume`` loads the newest checkpoint and trains ``steps``
more from its step.  As in the JAX
package, a resumed run restarts its batch stream: synthetic batches from
index 0, the carousel from its first shard.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.carousel.delivery import DeliveryIterator, device_put
from repro_torch.carousel.stager import Stager
from repro_torch.carousel.storage import DiskCache
from repro_torch.carousel.transform import make_packing_transform
from repro_torch.ckpt import AsyncCheckpointer, latest_step, load_checkpoint
from repro_torch.configs.base import (RunConfig, ShapeConfig, get_config,
                                      get_smoke_config)
from repro_torch.data.synthetic import build_cold_store
from repro_torch.launch.serve import resolve_device
from repro_torch.models import registry
from repro_torch.train.step import init_state, make_train_step


def make_carousel_pipeline(cfg, *, seq_len: int, batch_rows: int,
                           n_shards: int = 64, fault_rate: float = 0.02,
                           cache_bytes: int = 1 << 30, coarse: bool = False,
                           tape_latency: float = 0.001, drives: int = 4):
    """(stager, delivery) over a synthetic corpus of ``n_shards`` shards,
    every shard submitted for staging before this returns."""
    cold = build_cold_store(
        n_shards=n_shards, docs_per_shard=16, vocab_size=cfg.vocab_size,
        mean_doc_len=seq_len // 2, drives=drives,
        mount_latency=tape_latency, fault_rate=fault_rate)
    cache = DiskCache(cache_bytes)
    names = [f.name for f in cold.files()]
    stager = Stager(cold, cache, workers=4, max_attempts=6, backoff=0.005,
                    transform=make_packing_transform(seq_len))
    stager.submit_all(names)
    delivery = DeliveryIterator(stager, cache, names,
                                batch_rows=batch_rows, coarse=coarse)
    return stager, delivery


def _modality_extras(cfg, batch: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero frames (whisper) or image patches (VLM) for a carousel batch of
    ``batch`` rows, which holds tokens only."""
    extra = registry.modality_input(cfg)
    if extra is None:
        return {}
    name, n = extra
    return {name: torch.zeros((batch, n, cfg.d_model), dtype=torch.bfloat16,
                              device=device)}


def _batch_iter_carousel(cfg, delivery: DeliveryIterator,
                         device: torch.device) -> Iterator[Dict[str, Any]]:
    for b in delivery:
        out = device_put(b, device)
        out.update(_modality_extras(cfg, out["tokens"].shape[0], device))
        yield out


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


def _carousel_stats(stager: Stager, delivery: DeliveryIterator,
                    next_wait_s: List[float]) -> Dict[str, Any]:
    first = (None if delivery.first_batch_at is None
             else delivery.first_batch_at - delivery.started_at)
    return {
        "time_to_first_batch_s": first,  # the DeliveryIterator's clock
        "next_wait_s": next_wait_s,
        "reads": stager.cold.reads, "failed_reads": stager.cold.failed_reads,
        "hedges": stager.hedges_issued,
        "shards_landed": sum(r.ok for r in stager.records.values()),
        "rows_delivered": delivery.rows_delivered,
        "rows_received": delivery.rows_received,
        "skipped_shards": list(delivery.skipped_shards),
    }


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
    num_layers: Optional[int] = None,
) -> Dict[str, Any]:
    """Trains ``steps`` steps and returns the JAX entry point's result
    keys.  ``num_layers`` cuts the depth (the width stays).  With the
    carousel the result also holds ``"carousel"``: the delivery's time
    to the first batch, the host time each step waited in ``next()`` on
    the batch iterator, the tape's reads and failed reads, the stager's
    hedges, shards landed, and rows delivered against rows received.
    With ``out_dir`` it holds ``"checkpoint"``: each save's host-copy and
    writer times and the bytes written."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    shape = ShapeConfig("train", seq_len, global_batch, "train")
    run = run or default_run_config(cfg, steps)
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, run)

    start_step = 0
    if resume and out_dir and latest_step(out_dir) is not None:
        state, meta = load_checkpoint(out_dir, device=dev)
        state["opt"]["step"] = int(state["opt"]["step"])
        start_step = int(meta["step"])
    else:
        state = init_state(
            torch.Generator(device=dev).manual_seed(run.seed), cfg, run)

    ckpt = AsyncCheckpointer(out_dir, keep=3) if out_dir else None
    stager = delivery = None
    if carousel:
        stager, delivery = make_carousel_pipeline(
            cfg, seq_len=seq_len, batch_rows=global_batch,
            n_shards=max(8, steps), coarse=coarse,
            tape_latency=tape_latency, drives=drives)
        batches = _batch_iter_carousel(cfg, delivery, dev)
    else:
        batches = _batch_iter_synth(cfg, shape, dev)

    losses: List[float] = []
    next_wait_s: List[float] = []
    t0 = time.time()
    ttfb = None
    done = start_step
    try:
        while done < start_step + steps:
            t_next = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            next_wait_s.append(time.perf_counter() - t_next)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            if ttfb is None:
                ttfb = time.time() - t0
            losses.append(loss)
            done += 1
            if on_step:
                on_step(done, {"loss": loss})
            if ckpt and done % ckpt_every == 0:
                ckpt.save(state, done, meta={"loss": loss, "arch": arch})
        if ckpt:
            ckpt.save(state, done, meta={
                "loss": losses[-1] if losses else None, "arch": arch})
    finally:
        if ckpt:
            ckpt.close()
        if stager:
            stager.shutdown()
    out = {
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
    if carousel:
        out["carousel"] = _carousel_stats(stager, delivery, next_wait_s)
    if ckpt:
        out["checkpoint"] = {"copy_s": ckpt.copy_s, "write_s": ckpt.write_s,
                             "bytes_written": ckpt.bytes_written}
    return out


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
    ap.add_argument("--coarse", action="store_true",
                    help="pre-iDDS baseline: wait for the whole dataset")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run_training(args.arch, smoke=args.smoke, steps=args.steps,
                       seq_len=args.seq_len, global_batch=args.global_batch,
                       out_dir=args.out, resume=args.resume,
                       carousel=args.carousel, coarse=args.coarse,
                       device=args.device)
    res.pop("state")
    res.pop("losses")
    print(res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
