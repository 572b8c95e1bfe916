"""Batched serving driver: prefill a batch of prompts, decode greedily.

The PyTorch twin of ``repro/launch/serve.py::run_serving``, for every
family of the zoo: dense (yi-6b, qwen1.5-4b, qwen1.5-32b, starcoder2-15b;
a bf16 or int8 KV cache), moe (mixtral-8x7b, qwen3-moe-235b-a22b), ssm
(mamba2-130m, conv tails and SSM state), hybrid (zamba2-1.2b, both),
encdec (whisper-tiny: the prompt is the decoder's, and the encoder's
frames come beside it; a self and a cross cache) and vlm
(llava-next-mistral-7b: the image patches go in front of the prompt, so
the cache and the decode positions count them); and the port's own
granite_hybrid (granite-4.0-h-small: Mamba2 and NoPE attention layers,
each followed by a dropless MoE with a shared expert; one rank).  ``--layers`` cuts the
depth of an arch too deep for the card.  Weights are random, drawn on the
device from a seeded generator, and so are the modality inputs.

As the JAX driver does, it runs under sharding rules on a (data, model)
mesh over every rank of the world (``launch/mesh.py::make_host_mesh``):
the ranks of ``torchrun``, each on ``cuda:LOCAL_RANK``, or one rank.
Each rank holds its blocks of the weights (gathered a layer at a time
over the data axes, their ``model`` split kept: each model rank computes
its heads, ``ffn`` columns and vocab rows), serves its data rows of the
one global prompt batch (drawn whole on every rank from the seed) with a
cache of its rows and its ``model`` block (positions, else heads), and
the tokens are gathered to every rank; rank 0 prints, with every rank's
peak memory.  Under rules MoE prefill takes the
shardmap path (capacity over a rank's B_local * S tokens), decode the
gspmd one.

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch mixtral-8x7b --full --model 4

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full \
        --prompt-len 512 --gen 32 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --full --prompt-len 2048 --gen 32 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-235b-a22b --full --layers 6 --prompt-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --full --prompt-len 448 --gen 32 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-4.0-h-small --full --prompt-len 4096 --batch 16
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import (RunConfig, ShapeConfig, get_config,
                                      get_smoke_config)
from repro_torch.launch.mesh import local_device, make_host_mesh
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.serve import engine
from repro_torch.sharding import ShardingRules, batch_split, use_rules


def resolve_device(device: str) -> torch.device:
    """The device to run on, a bare ``"cuda"`` pinned to this rank's card;
    a CUDA device that is absent raises (the port never moves to the CPU
    unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return local_device(device)


def host_rules(model: Optional[int], dev: torch.device) -> ShardingRules:
    """Sharding rules over the host mesh of every rank (``model`` ranks a
    model group), its collectives on ``dev``'s type."""
    return ShardingRules(make_host_mesh(model, device=dev.type))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def init_params(cfg, seed: int, device: torch.device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return P.materialize(registry.param_defs(cfg), gen, device)


def run_serving(arch: str, *, smoke: bool = True, prompt_len: int = 32,
                gen: int = 16, batch: int = 4, device: str = "cuda",
                run: Optional[RunConfig] = None, seed: int = 0,
                num_layers: Optional[int] = None,
                model: Optional[int] = None) -> Dict[str, Any]:
    """Prefills ``batch`` random prompts of ``prompt_len`` tokens (with
    their frames or image patches), then decodes ``gen - 1`` more tokens
    greedily, under sharding rules on the host mesh (``model`` ranks a
    model group; see the module doc).  Prompts come from ``seed`` and
    weights from ``seed + 1``.  ``num_layers`` cuts the depth (the width
    stays)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    run = run or RunConfig()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rules = host_rules(model, dev)
    with use_rules(rules):
        return _serve(arch, cfg, run, dev, rules, prompt_len, gen, batch,
                      seed)


def _serve(arch, cfg, run, dev, rules, prompt_len, gen, batch, seed):
    shape = ShapeConfig("serve", prompt_len, batch, "prefill")
    prompts = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(seed), cfg, shape,
        "prefill", device=dev)
    split = rules.local_batch(prompts)
    prompts, rows, axes = split or (prompts, batch, ())
    extra = cfg.num_img_patches if cfg.family == "vlm" else 0
    max_len = prompt_len + extra + gen + 8
    params = init_params(cfg, seed + 1, dev)
    cache = engine.init_cache(cfg, rows, max_len, device=dev)

    with torch.inference_mode(), batch_split(rows, axes):
        _sync(dev)
        t0 = time.perf_counter()
        tok, cache = engine.prefill_step(params, prompts, cache, cfg=cfg,
                                         run=run)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        out_tokens = [tok]
        t1 = time.perf_counter()
        for i in range(gen - 1):
            tok, cache = engine.decode_step(params, tok, cache,
                                            prompt_len + extra + i,
                                            cfg=cfg, run=run)
            out_tokens.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t1
        seq = rules.all_gather(torch.cat(out_tokens, dim=1), 0, axes)
    res = {
        "arch": arch,
        "layers": cfg.num_layers,
        "mesh": dict(rules.mesh.shape),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "generated": tuple(seq.shape),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "tokens": seq,
    }
    if dev.type == "cuda":
        res["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        if dist.get_world_size() > 1:  # every rank's, in rank order
            peaks = [None] * dist.get_world_size()
            dist.all_gather_object(peaks, res["peak_mem_bytes"])
            res["rank_peak_mem_bytes"] = peaks
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--model", type=int, default=None,
                    help="ranks a model group (default 1: data parallel)")
    args = ap.parse_args(argv)
    res = run_serving(args.arch, smoke=args.smoke,
                      prompt_len=args.prompt_len, gen=args.gen,
                      batch=args.batch, device=args.device, seed=args.seed,
                      num_layers=args.layers, model=args.model)
    res.pop("tokens")
    if dist.get_rank() == 0:
        print(res)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
