"""Drives the PyTorch port's serving and training paths on one NVIDIA GPU
and holds every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no final result line):

1. device: ``nvidia-smi`` name and power limit, torch / CUDA / nvcc versions;
2. build: every source in ``src/repro_torch/kernels/csrc`` compiled into
   one extension module by ``torch.utils.cpp_extension.load``, with its
   time and ptxas' register counts; then the CUDA runtime's registers,
   local (spill) bytes, shared memory and resident blocks a SM of each
   redesigned kernel: the tensor-core flash forward and backward, CE
   forward and SSD scan, the RMSNorm forward and backward (fails if one
   uses local memory);
3. kernel against plain: each kernel and its plain version on the same
   inputs, at the main paths' shapes and the sweep of tests/test_kernels.py
   (tolerance 2e-2 in bf16, 3e-5 in f32; the SSD scan 3e-2 and 3e-4), with
   the kernel's time, the plain version's time and one library call's time
   (CUDA graph + events, median), warm (inputs in L2) and, at the models'
   shapes, cold (inputs rotated past L2), and the bound of the work the
   call needs; each phase's seconds logged.  Forward kernels (RMSNorm,
   flash attention, cross entropy; cross entropy also at the SSM models'
   loss heads, T 8192 x D 768 x V 50280 and T 8192 x D 2048 x V 32000;
   RMSNorm and flash also at the zamba2-1.2b / mamba2-130m prefill
   shapes and at the prefills of SERVE_ARCHS: RMSNorm at D 2560, 5120,
   6144; flash at G 1, 12, 16 and mixtral's 4608 queries, window 4096;
   and at whisper-tiny's and llava-next's: RMSNorm at D 384 over 4 x 1500
   and 4 x 448 rows, and 4 x 3392 rows of D 4096; flash over whisper's
   1500 frames, non-causal (the encoder, the cross-attention) and its
   decoder's cache, and llava's 3392 queries; cross entropy at the loss
   heads of whisper (V 51865, D 384), llava, mixtral and qwen3-moe (V
   151936); the f32 rows of the new flash shapes checked, not timed)
   and, for training, the RMSNorm and flash-attention backward
   kernels (the latter's device time split by kernel under the
   profiler) and the flash forward's ``lse``, also at the SSM models'
   training shapes (RMSNorm backward at D 768, 1536, 2048, 4096 over
   8192 rows; flash forward with ``lse`` and backward at zamba2's 4 x
   2048, 32/32 heads of 64) and at this slice's (RMSNorm backward at the
   new RMSNorm shapes; flash forward with ``lse`` and backward over
   whisper's encoder, cross-attention and 448-token decoder, llava's 4 x
   3392 and mixtral's 1 x 4608 with its window), the f32 RMSNorm backward
   held against
   ``rmsnorm_bwd_ref`` evaluated in f64; then the SSD chunked scan
   (phase "ssd": ``y`` and the final state against ``ssd_ref`` on the
   SSD_CASES of tests/test_kernels.py, S < chunk, an ``init_state``
   chain of two calls against one, and both models' prefill shapes; no
   library call computes it) and its backward (phase "ssd_bwd": dx, ddt,
   dB, dC and d_init elementwise, dA at relative L2, against
   ``ssd_bwd_ref`` on the same cases with an initial state and a
   final-state cotangent, the f32 rows against it evaluated in f64; both
   models' training shapes timed, with each launch's device time and the
   scratch a call allocates); both at SSD_LOCAL too, a rank's block under
   a "model" split (16 / 6 heads; the head dim split to 16, and to 4,
   which the wrapper pads to 8), timed in bf16; and the split-row RMSNorm
   (phase "rmsnorm_split": the mamba block's gated norm over a row whose
   columns lie on 4 ranks, a rank's (8192, 1024) and (8192, 384): the
   statistic launch and the rows launch each way, the statistics summed
   over the shards, against the plain twins and the whole-row kernels on
   the gathered row, bf16 and f32; each bf16 launch timed beside its
   bound; no PyTorch call normalises a partial row, so ``F.rms_norm`` on
   the whole row is logged as context); and AdamW (phase "adamw": three
   steps of yi-6b's largest leaf, ADAMW_LEAF, through the kernels and the
   plain version, bit for bit with no clip, the norm within 1e-5, and bit
   for bit with the clip on over gradients whose norm both sum exactly; that
   leaf and the whole yi-6b and zamba2-1.2b train states timed a step,
   beside ``torch._fused_adamw_`` with moments of the params' dtype (it
   takes no f32 moments beside bf16 params) where those fit, with the
   launches of a step); and the dropless MoE's grouped expert kernels
   (phase "moe_experts": granite-4.0-h-small's widths, a prefill block of
   8192 tokens and a decode step of 16 rows, K 10 of 72, routes uniform
   and uneven, against ``moe_experts_ref`` at TOL and bit-equal over two
   calls; the uniform shapes timed beside the plain twin and
   ``torch._grouped_mm``).
   The library yardstick of a backward is the library forward plus
   backward less the forward;
4. serving: ``run_serving(arch, smoke=False, prompt_len=P, gen=32,
   batch=4)`` at full width and depth for yi-6b (P = 512), zamba2-1.2b
   and mamba2-130m (P = 2048; phases "serving_zamba2", "serving_mamba2"),
   then at full width for SERVE_ARCHS (phases "serving_qwen1_5_4b",
   "serving_starcoder2_15b", "serving_qwen1_5_32b", "serving_mixtral_8x7b",
   "serving_qwen3_moe"): qwen1.5-4b
   (int8 KV cache) and starcoder2-15b at full depth, qwen1.5-32b (int8)
   at 32 of 64 layers, mixtral-8x7b at 12 of 32 (batch 1, P = 4608) and
   qwen3-moe-235b-a22b at 6 of 94 through ``num_layers`` (their bf16
   weights and the f32 temporaries of their initialisation would not fit
   the card); then whisper-tiny (P = 448 decoder tokens, 1500 frames) and
   llava-next-mistral-7b (2880 patches + P = 512 tokens) at full size
   (phases "serving_whisper", "serving_llava"), and granite-4.0-h-small
   at full size, 16 x 4096 (phase "serving_granite": the grouped expert
   kernels two launches a call, 8 calls a layer at prefill, 1 a decode
   step); launch counters reset just before each and read just after,
   and held against the counts the code implies;
5. end to end, each model as it was served: (a) prefill logits through
   the kernels against ``use_kernels=False``; (b) decode at position S
   after a prefill of S tokens against a prefill of S + 1 tokens (for
   the SSM models S + 1 = 2049, one past a chunk boundary; for whisper
   decode reads the cross cache as prefill left it; for llava S counts
   the 2880 patches; for the MoE
   models at capacity factor E / K, where nothing drops: a longer
   prefill may drop its last token from a full expert, decode never
   does); both at relative L2 <= 5e-2.  MoE rows also log the share of
   (token, expert) pairs (a)'s prefill dropped and the top-K choices
   that differ between its two paths.  Beside (a), not checked: both
   paths against the plain path with the same weights in f32, to show
   how far bf16 rounding alone moves the logits of the random model,
   where that copy fits on the card (skipped, and logged so, where not);
6. breakdown: ``torch.profiler`` over one warm prefill and four warm decode
   steps of each model (wall time, device time, busy share, top kernels
   by device time; for SERVE_ARCHS the top operators too); then, for
   the MoE and int8-cache models, phase "parts_*": the routing, the
   expert products (with their bound) and the whole MoE block at the
   prefill's and a decode step's tokens, and the int8 quantisation and
   dequantisation of one layer's K, each timed alone (CUDA events);
7. training: ``run_training("yi-6b", smoke=False, steps=3, seq_len=512,
   global_batch=4, carousel=False)`` at full width and depth, launch
   counters reset just before and read just after and held against the
   counts the code implies; losses, step time of steps 2-3, tokens/s and
   peak memory; then ``torch.profiler`` over one more (warm) step (with
   the device time of the flash, RMSNorm-backward and CE kernels picked
   out), and the wall time of each half (gradients, AdamW) of HALF_STEPS
   more, with the allocator's retries (``num_alloc_retries``) counted
   through the phase;
8. end to end, training, at full width and 2 layers: one
   ``grads_and_metrics`` through the kernels against one through
   ``use_kernels=False``, loss within relative 1e-2 and every gradient leaf
   within relative L2 5e-2, its launches held against the formula; then,
   for mamba2-130m and zamba2-1.2b, phase "training_<arch>": 3 steps of
   ``run_training(arch, smoke=False, seq_len=2048, global_batch=4,
   carousel=False)`` at full width and depth, counted, timed and peak
   memory as phase 7, with one more step under the profiler (the SSD
   kernels picked out), and "end_to_end_training_<arch>" as above at 4 x
   2048 tokens (mamba2 at 2 layers, zamba2 at 7: one application of the
   shared block and a mamba block after it); then "training_whisper"
   (full size, 4 x 448 over 1500 frames), "training_llava" (full width,
   LLAVA_TRAIN_LAYERS layers, 4 x (2880 + 512)), "training_mixtral" (3
   layers, 1 x 4608) and "training_qwen3_moe" (1 layer, 4 x 512), each
   with its "end_to_end_training_<arch>" (whisper at full size, llava at
   2 layers, the MoE archs at their training depth and capacity factor
   E / K, where nothing drops, with the routing flips between the paths
   and the share the configs' own factor drops; whisper's key-bias
   gradients, zero but for rounding, held against the value bias's);
9. training_carousel: ``run_training`` on the Data Carousel, as its
   defaults run it (8 shards, 4 drives, 1 ms a tape read, fault rate
   0.02), at full width and depth, 3 steps of 4 x 512 tokens; launches
   held against the training formula; time to the first batch by the
   delivery's clock and by ``run_training``'s, each step's wait in
   ``next()``, the tape's reads and failed reads, hedges, rows delivered
   and received, step times beside phase 7's, tokens/s, peak memory;
10. carousel_fine_vs_coarse: full width, 2 layers, 6 steps, one tape
   drive at 0.4 s a shard, fine delivery then coarse: coarse's first
   batch must come more than 1.5 s after fine's;
11. checkpoint_resume: full width, 2 layers (8.7 GB of state): 4 steps
   saving every 2 into a temporary directory, the newest checkpoint
   loaded onto the card equal leaf by leaf (``torch.equal``) to the state
   it saved, one step from each on one batch, then a resume of 2 steps to
   step 6; bytes, host-copy, writer and load times;
12. remat_dots: full width, 2 layers, ``grads_and_metrics`` with
   ``remat="dots"`` through the kernels against the plain path (loss 1e-2,
   leaves relative L2 5e-2) and against "full" (printed), launches equal to
   "full"'s; then step time, peak memory and allocator retries of "full"
   and "dots" at REMAT_LAYERS layers, and one more step of each under
   ``torch.profiler`` (wall, device time, busy share);
13. cost_model: each timed run of phases 4, 7 and 8 (ten served models,
   seven trained ones) counted again by the dry run's cost model
   (``launch/dryrun.py::count_cell`` over ``launch/cost.py``, kernel
   mode, on the meta device: no card, no allocation) at the same config,
   depth, batch and length: the prefill and one decode step of a served
   model, one step of a trained one.  Logs FLOPs, bytes, the bound at the
   H100's data-sheet rates (``launch/mesh.py``) and its dominant term,
   ``bound_share`` (the bound over the measured prefill, decode step or
   step), and the counted peak beside ``max_memory_allocated`` and their
   ratio (logged, not checked).  Fails when a kernel's counted calls over
   the run differ from the launch counters the run read on the card, or
   a count is not finite and positive;
14. mesh: the mesh path at world size 1, a one-rank process group over
   NCCL with the sharding rules over it (as ``run_serving`` and
   ``run_training`` run; ``launch/mesh.py``, ``sharding/``): yi-6b served
   at full size (4 x 512, MESH_GEN tokens) and trained (MESH_TRAIN_LAYERS
   layers, MESH_STEPS steps) under the rules and without: tokens, logits,
   losses, params and moments bit for bit, the mesh runs' launches held
   against the formulas and the cost model's calls counted under the same
   rules; then mixtral-8x7b (12 / 3 layers, 2 x 1024) and qwen3-moe (6 /
   2, 4 x 512) at batch > 1, where the MoE block takes the shardmap path
   (one route of a rank's B x S tokens, capacity over them): prefill
   logits and one ``grads_and_metrics`` through the kernels against the
   plain versions (the plain path routed by the kernel path's choices),
   relative L2 5e-2, loss 1e-2;
15. tensor_parallel: the compute split over "model" on the one card: (a)
   TP_RANKS spawned ranks, all on cuda:0 over gloo (NCCL refuses two ranks on
   one device), rules at (1, TP_RANKS), run TP_MODELS at full width: yi-6b at
   TP_LAYERS layers, zamba2-1.2b at 6 (its mamba blocks split by SSM heads,
   one application of its shared block) and mamba2-130m at full depth (in f32:
   see TP_MODELS): a prefill of TP_BATCH x PROMPT, TP_DECODE decode steps fed
   the world-size-1 run's tokens over a cache of the rank's block (KV
   positions, flash-decoding across the ranks; the mamba states' heads), the
   first batch's gradients and the model's train steps; held against the same
   path at world size 1 in this process (logits and each gradient leaf
   relative L2 5e-2, losses 1e-2); each rank's launches equal the formulas
   (the gated norms on the split-row kernels), and its calls see its query and
   kv heads, ``ffn`` columns and vocab rows (yi-6b: 8 of 32, 1 of 4, 2752 of
   11008, 16000 of 64000), its SSD heads (16 of 64, 6 of 24) and its gated
   norm's columns (1024 of 4096, 384 of 1536); each rank's CE merges the
   ranks' statistics with ``ce_merge_kernel``; each rank tallies the bytes
   its collectives move by kind (``sharding.collective_tally``) over each
   half of its path (serving; gradients and steps), and the same path is
   counted on meta by the dry run's cost model at an abstract (1,
   TP_RANKS) mesh standing for that rank: the tally must equal the
   counted collectives kind by kind, and the counted calls the rank's
   launch counters; its counted peak is logged beside its
   ``max_memory_allocated``. Then MoE decode split:
   mixtral's smoke config in f32, each rank running its one of 4 experts at S
   = 1, against one rank (relative L2 TP_MOE_TOL). (b) The CE kernel on
   TP_RANKS vocab shards of yi-6b's and qwen3-moe's heads (T 2048, D 4096, V
   64000 and 151936), bf16 and f32, merged, against the whole-vocab kernel and
   the plain version (2e-2 / 3e-5); a bf16 shard call and the merge timed,
   beside their bounds, ``matmul`` + ``logsumexp`` on the same shard and
   ``ce_merge_ref``.

Phases 9-11 and 14's two yi-6b mesh runs drive the entry point; each of their runs has its launch
counters reset just before it and read just after.  Every kernel's bound
(its ``work`` formula in ``kernels/``, over ``launch/mesh.py``'s rates)
is the one the cost model charges a call of it.

It prints a ``{"kernel_info": [...]}`` line, a ``{"kernels": [...]}`` line
and, last, ``{"ok": true, ...}``.
A kernel's ``launches`` there is the sum of its counts over the eleven
serving runs, the seven training runs of phases 7 and 8, the runs of
phases 9-11, phase 14's two yi-6b runs and phase 15's rank 0 (each of its
halves counted from 0 in that rank's process); ``ssd_scan``'s row is the
zamba2-1.2b prefill shape, ``ssd_scan_bwd``'s zamba2-1.2b's training
shape; ``rmsnorm_split`` and ``rmsnorm_split_bwd`` (the split-row
kernels, a rank's (8192, 1024): both launches a call, timed together)
and ``ce_merge`` (yi-6b's 4 vocab shards) are launched on phase 15's
path only; ``moe_experts``' row is a prefill block of 8192 tokens, its
launches phase "serving_granite"'s.  Weights are random,
made on the card from a seed; data is synthetic, from a seed; nothing is
downloaded.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils.cpp_extension import CUDA_HOME  # noqa: E402

from repro_torch.configs.base import (RunConfig, ShapeConfig,  # noqa: E402
                                      get_config, get_smoke_config)
from repro_torch.kernels import adamw as kadamw  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import cross_entropy as kce  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import moe_experts as kmoe  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as krms  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.launch import dryrun, serve, train  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import granite_hybrid  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.sharding import (ShardingRules, batch_split,  # noqa: E402
                                  collective_tally, reset_collective_tally,
                                  use_rules)
from repro_torch.train import step as tstep  # noqa: E402

L2_BYTES = 50 * 2**20
TOL = {torch.bfloat16: 2e-2, torch.float32: 3e-5}
SSD_TOL = {torch.bfloat16: 3e-2, torch.float32: 3e-4}
E2E_TOL = 5e-2
# the f32 yardstick of phase 5 runs where its copy of the weights fits
# with this much to spare
F32_MARGIN_BYTES = 8e9
LOSS_TOL = 1e-2
ARCH, PROMPT, GEN, BATCH = "yi-6b", 512, 32, 4
SSM_ARCHS, SSM_PROMPT = ("zamba2-1.2b", "mamba2-130m"), 2048
# the other dense archs and the MoE archs at full width: arch, layers
# (None: full depth; a cut where the bf16 weights and the f32 temporaries
# of their initialisation would not fit the card), batch, prompt
MIXTRAL_PROMPT = 4608  # the 4096-token window bites on the last 512
SERVE_ARCHS = [("qwen1.5-4b", None, BATCH, PROMPT),
               ("starcoder2-15b", None, BATCH, PROMPT),
               ("qwen1.5-32b", 32, BATCH, PROMPT),
               ("mixtral-8x7b", 12, 1, MIXTRAL_PROMPT),
               ("qwen3-moe-235b-a22b", 6, BATCH, PROMPT)]
# whisper-tiny (encoder-decoder) and llava-next-mistral-7b (VLM): served
# at full size, batch 4, 32 tokens (whisper: a 448-token decoder prompt
# over 1500 frames; llava: 2880 patches + 512 text tokens); trained 3
# steps of 4 x 448 (whisper, full size) and 4 x (2880 + 512) (llava, at
# LLAVA_TRAIN_LAYERS: ~12 B a parameter of training state, 2.6 GB a layer
# and 3.1 GB of embeddings); their gradient checks at full size (whisper)
# and 2 layers (llava)
WHISPER, LLAVA = "whisper-tiny", "llava-next-mistral-7b"
WHISPER_PROMPT, LLAVA_PROMPT = 448, 512
LLAVA_PATCHES = 2880
LLAVA_TRAIN_LAYERS, LLAVA_E2E_LAYERS = 26, 2
# MoE training at full width: arch, phase tag, layers (the deepest whose
# state fits the card: 17.4 GB a mixtral layer, 29.8 GB a qwen3-moe layer,
# plus 3.1 and 14.9 GB of embeddings), batch, sequence; mixtral at 1 x
# 4608 as it is served, so that its 4096-token window bites in the flash
# backward too
MOE_TRAIN = [("mixtral-8x7b", "mixtral", 3, 1, 4608),
             ("qwen3-moe-235b-a22b", "qwen3_moe", 2, 4, 512)]
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 3, 512, 4
# the mesh phase: yi-6b served at full size and trained at MESH_TRAIN_LAYERS
# for MESH_STEPS steps; the MoE archs (arch, tag, served layers, trained
# layers, batch, length) at batch > 1, where the shardmap path's capacity
# over a rank's B * S tokens differs from the per-row one
MESH_GEN, MESH_TRAIN_LAYERS, MESH_STEPS = 4, 4, 2
MESH_MOE = [("mixtral-8x7b", "mixtral", 12, 3, 2, 1024),
            ("qwen3-moe-235b-a22b", "qwen3_moe", 6, 2, 4, 512)]
# phase tensor_parallel: yi-6b at full width and TP_LAYERS layers split
# over TP_RANKS ranks on the one card (gloo), TP_BATCH x PROMPT, TP_DECODE
# decode steps, the first batch's gradients and TP_STEPS train steps; the
# CE kernel on TP_RANKS vocab shards of yi-6b's and qwen3-moe's heads
TP_RANKS, TP_LAYERS, TP_BATCH, TP_DECODE, TP_STEPS = 4, 4, 4, 8, 2
TP_CE_VOCABS = (64000, 151936)
# the models phase tensor_parallel splits: arch, layers (None: full
# depth), train steps, weights' dtype; zamba2-1.2b at 6 layers (one
# application of the shared block), mamba2-130m at full depth, both by
# SSM heads (16 / 6 a rank).  mamba2 runs in f32 (weights, activations,
# CE): at its 24 layers bf16 rounding alone moves the random model's
# logits by 0.035-0.048 relative L2 at one rank (PERF.md §6, PR 24's
# end_to_end_mamba2), and the split's partial sums, rounded to bf16
# before they are added, took its logits to 0.045-0.051 and every
# gradient leaf to ~0.09 of the one-rank run: the rounding, not the
# split, would be what a 5e-2 limit measured
TP_MODELS = [(ARCH, TP_LAYERS, TP_STEPS, torch.bfloat16),
             ("zamba2-1.2b", 6, 3, torch.bfloat16),
             ("mamba2-130m", None, 3, torch.float32)]
# MoE decode split over the ranks: mixtral-8x7b's smoke config in f32 (4
# experts: one a rank), a prompt of TP_MOE_PROMPT, TP_DECODE steps
TP_MOE_ARCH, TP_MOE_PROMPT = "mixtral-8x7b", 64
TP_MOE_TOL = 1e-3
# granite-4.0-h-small (d 4096, 72 experts of 768, top 10): its grouped
# expert kernels at the shapes its serving path gives them (a block of
# MOE_TOKEN_BLOCK tokens at prefill, GRANITE_BATCH rows at decode), and
# run_serving at full width and depth, GRANITE_BATCH x GRANITE_PROMPT
GRANITE, GRANITE_BATCH, GRANITE_PROMPT = "granite-4.0-h-small", 16, 4096
HALF_STEPS = 3  # warm steps whose two halves are timed alone
E2E_TRAIN_LAYERS = 2
# SSM / hybrid training at full width and depth, 4 x 2048 tokens a step;
# the end-to-end gradient checks at a cut depth (zamba2 at 7 layers: one
# application of the shared block, attn_every 6, and a mamba block after
# it)
SSM_TRAIN_SEQ = 2048
SSM_E2E_LAYERS = {"mamba2-130m": 2, "zamba2-1.2b": 7}
# the mamba block's leaves whose gradients pass through the SSD backward:
# A and dt (A_log, dt_bias), the in-projections of x, B, C and dt, and the
# causal convolutions of x, B and C
SSD_FED_LEAVES = ("A_log", "dt_bias", "w_x", "w_B", "w_C", "w_dt",
                  "conv_x", "conv_B", "conv_C", "conv_x_b", "conv_B_b",
                  "conv_C_b")
# the carousel's fine vs coarse delivery: one tape drive, 0.4 s a shard
FINE_COARSE = dict(steps=6, tape_latency=0.4, drives=1)
FINE_COARSE_GAP_S = 1.5  # coarse's first batch this much later at least
# checkpoints: CKPT_STEPS steps saved every CKPT_EVERY, then a resume
CKPT_STEPS, CKPT_EVERY, CKPT_RESUME_STEPS = 4, 2, 2
# remat "dots" at full depth: it keeps q, k, v, o, gate, up and down,
# (4096 + 2 x 512 + 4096 + 3 x 11008) x 2 B = 145 MB a layer at 2048
# tokens, 4.6 GB over 32 layers, on top of "full"'s 75.1 GB peak: 79.7 GB
# of the card's 85.0 GB, so the whole model
REMAT_LAYERS, REMAT_STEPS = 32, 3
DEVICE = "cuda"
# every timed serving and training run, as phase "cost_model" counts it
# again: label, arch, layers, kind, batch, length, times, peak, launches
TIMED_RUNS: list = []

# B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len: the six CASES of
# tests/test_kernels.py, then the yi-6b prefill (cache of PROMPT + GEN + 8).
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0, None),
    (1, 100, 160, 6, 6, 64, True, 0, 0, None),
    (2, 1, 256, 8, 2, 128, True, 0, 200, 201),
    (2, 64, 256, 4, 4, 64, True, 48, 0, None),
    (1, 96, 160, 4, 2, 64, False, 0, 0, None),
    (1, 80, 80, 40, 40, 32, True, 0, 0, None),
]
FLASH_MAIN = (BATCH, PROMPT, PROMPT + GEN + 8, 32, 4, 128, True, 0, 0,
              PROMPT)
# zamba2-1.2b prefill: 32/32 heads of 64 over a cache of SSM_PROMPT + GEN + 8
FLASH_ZAMBA2 = (BATCH, SSM_PROMPT, SSM_PROMPT + GEN + 8, 32, 32, 64, True,
                0, 0, SSM_PROMPT)
# the prefills of SERVE_ARCHS: starcoder2-15b (48/4 heads), qwen1.5-4b
# (20/20), qwen1.5-32b (40/40), qwen3-moe (64/4), and mixtral (1 x 4608,
# 32/8 heads, window 4096)
FLASH_SERVE = [(BATCH, PROMPT, PROMPT + GEN + 8, hq, hkv, 128, True, 0, 0,
                PROMPT) for hq, hkv in ((48, 4), (20, 20), (40, 40),
                                        (64, 4))] + [
    (1, MIXTRAL_PROMPT, MIXTRAL_PROMPT + GEN + 8, 32, 8, 128, True, 4096, 0,
     MIXTRAL_PROMPT)]
# whisper-tiny's prefill: the encoder (non-causal over 1500 frames, no
# multiple of 64), the cross-attention (448 queries over the 1500 frames)
# and the decoder's self-attention (a cache of 448 + 40); llava's prefill
# (2880 patches + 512 tokens over a cache of 3432)
FLASH_NEW_SERVE = [
    (BATCH, 1500, 1500, 6, 6, 64, False, 0, 0, None),
    (BATCH, WHISPER_PROMPT, 1500, 6, 6, 64, False, 0, 0, None),
    (BATCH, WHISPER_PROMPT, WHISPER_PROMPT + GEN + 8, 6, 6, 64, True, 0, 0,
     WHISPER_PROMPT),
    (BATCH, LLAVA_PATCHES + LLAVA_PROMPT, LLAVA_PATCHES + LLAVA_PROMPT + GEN
     + 8, 32, 8, 128, True, 0, 0, LLAVA_PATCHES + LLAVA_PROMPT)]
# the yi-6b training shape: self-attention over TRAIN_SEQ, causal
FLASH_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 4, 128, True, 0, 0,
               None)
# zamba2-1.2b's shared block in training: 4 x 2048, 32/32 heads of 64
FLASH_TRAIN_ZAMBA2 = (TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_SEQ, 32, 32, 64,
                      True, 0, 0, None)
# whisper-tiny's training shapes: the encoder, the cross-attention, the
# decoder's self-attention over 448; llava's (4 x 3392, causal) and
# mixtral's (1 x 4608, window 4096)
FLASH_TRAIN_NEW = [
    (BATCH, 1500, 1500, 6, 6, 64, False, 0, 0, None),
    (BATCH, WHISPER_PROMPT, 1500, 6, 6, 64, False, 0, 0, None),
    (BATCH, WHISPER_PROMPT, WHISPER_PROMPT, 6, 6, 64, True, 0, 0, None),
    (BATCH, LLAVA_PATCHES + LLAVA_PROMPT, LLAVA_PATCHES + LLAVA_PROMPT, 32, 8,
     128, True, 0, 0, None),
    (1, MIXTRAL_PROMPT, MIXTRAL_PROMPT, 32, 8, 128, True, 4096, 0, None)]
# the shapes above whose f32 rows are checked but not timed (a large f32
# call takes a second on the CUDA cores, the plain version as long)
FLASH_F32_UNTIMED = FLASH_NEW_SERVE + FLASH_TRAIN_NEW
# the calls a timing graph holds at those shapes: the plain versions
# (25-130 ms a call at llava's and mixtral's) one a graph
NEW_SHAPE_CALLS = {"ms": 3, "plain_ms": 1, "library_ms": 3, "fb": 3, "f": 3}
RMS_MAIN = (BATCH * PROMPT, 4096)  # also the training shape (4 x 512 rows)
# the zamba2-1.2b / mamba2-130m prefill norms: d_model and the gated norm
RMS_SSM = [(BATCH * SSM_PROMPT, d) for d in (2048, 4096, 768, 1536)]
# the qwen1.5-4b, qwen1.5-32b and starcoder2-15b prefill norms
RMS_SERVE = [(BATCH * PROMPT, d) for d in (2560, 5120, 6144)]
# whisper-tiny's encoder and decoder rows (D 384), llava's 4 x 3392 rows
RMS_NEW = [(BATCH * 1500, 384), (BATCH * WHISPER_PROMPT, 384),
           (BATCH * (LLAVA_PATCHES + LLAVA_PROMPT), 4096)]
# the backward's sweep: the training shape and the small ragged cases
# (then the SSM models' training norms, RMS_SSM)
RMS_TRAIN_SHAPES = [RMS_MAIN, (BATCH, 4096), (8, 128), (3, 7, 384), (1, 513)]
RMS_SHAPES = RMS_TRAIN_SHAPES + RMS_SSM + RMS_SERVE + RMS_NEW
# the backward at these in bf16 only: its f32 dw sums 13568 rows, and an
# f32 sum that long lies past 3e-5 of the f64 one even in the plain
# version (6.1e-5 on an H100; the kernel 9.2e-5)
RMS_BWD_BF16_ONLY = [(BATCH * (LLAVA_PATCHES + LLAVA_PROMPT), 4096)]
# B, S, H, P, G, N, chunk: the SSD_CASES of tests/test_kernels.py, S <
# chunk, then the zamba2-1.2b and mamba2-130m prefill shapes (also their
# training shapes, 4 x 2048)
SSD_ZAMBA2 = (BATCH, SSM_PROMPT, 64, 64, 1, 64, 128)
SSD_MAMBA2 = (BATCH, SSM_PROMPT, 24, 64, 1, 128, 128)
# a rank's block under a "model" split of 4: zamba2's 16 of 64 heads and
# mamba2's 6 of 24; the SSD head dim split instead (P 16 of 64, every
# head; and mamba2 at 16 ranks: P 4, which the wrapper pads to 8)
SSD_LOCAL = [(BATCH, SSM_PROMPT, 16, 64, 1, 64, 128),
             (BATCH, SSM_PROMPT, 6, 64, 1, 128, 128),
             (BATCH, SSM_PROMPT, 24, 16, 1, 128, 128),
             (BATCH, SSM_PROMPT, 24, 4, 1, 128, 128)]
SSD_CASES = [(2, 96, 4, 16, 1, 32, 32), (1, 130, 6, 32, 2, 16, 64),
             (2, 64, 2, 64, 1, 128, 32), (2, 50, 4, 64, 1, 64, 128),
             SSD_ZAMBA2, SSD_MAMBA2] + SSD_LOCAL
# the gated norm's rows split over 4 ranks: a rank's (rows, columns) at
# zamba2's (4096 / 4) and mamba2's (1536 / 4) din, 4 x 2048 tokens
RMS_SPLIT = [(BATCH * SSM_PROMPT, 1024), (BATCH * SSM_PROMPT, 384)]
RMS_SPLIT_RANKS = 4
# AdamW: yi-6b's largest leaf, its stacked MLP projections (L, d_ff, d),
# then whole full-size train states (the params' dtypes, f32 moments)
ADAMW_LEAF = (32, 11008, 4096)
ADAMW_TREES = ("yi-6b", "zamba2-1.2b")
# T, D, V: the yi-6b loss head (4 x 512 tokens), the mamba2-130m (tied
# embeddings) and zamba2-1.2b loss heads (4 x 2048), then small ragged cases
CE_MAIN = (TRAIN_BATCH * TRAIN_SEQ, 4096, 64000)
CE_SSM = [(TRAIN_BATCH * SSM_TRAIN_SEQ, 768, 50280),
          (TRAIN_BATCH * SSM_TRAIN_SEQ, 2048, 32000)]
# the loss heads of whisper-tiny (4 x 448, D 384, V 51865), llava (4 x
# 512 text tokens), mixtral (1 x 4608) and qwen3-moe (4 x 512, V 151936)
CE_NEW = [(BATCH * WHISPER_PROMPT, 384, 51865),
          (BATCH * LLAVA_PROMPT, 4096, 32000), (MIXTRAL_PROMPT, 4096, 32000),
          (BATCH * PROMPT, 4096, 151936)]
CE_SHAPES = [CE_MAIN] + CE_SSM + CE_NEW + [(37, 48, 1000), (256, 64, 4099),
                                           (300, 128, 513)]


def log(*a) -> None:
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, sets: int = 1, reps: int = 10, calls: int = 10) -> float:
    """Device time of one call ``fn(i)``, ``i`` in ``range(sets)``: a run
    of calls captured in a CUDA graph, the graph replayed ``reps`` times
    between CUDA events, the median per-call time.  The graph takes the
    host's launch overhead out, so a short kernel is timed by what it
    costs on the card.  With ``sets`` > 1 the calls cycle through that
    many input sets, and each call's output is kept until its set comes
    round again, so a set is evicted from L2 before it is read again.
    ``calls`` (at least, rounded up to a multiple of ``sets``) go into
    the graph."""
    per_graph = sets * -(-calls // sets)
    keep = {}

    def run():
        for i in range(per_graph):
            keep[i % sets] = fn(i % sets)

    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        run()
        run()
    cur.wait_stream(side)
    keep.clear()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) / per_graph for s, e in events]
    del graph
    keep.clear()
    return statistics.median(times)


def cold_sets(n_bytes: float) -> int:
    """Input sets enough that the others' bytes between two reads of one
    set are at least twice the L2 cache."""
    return -(-2 * L2_BYTES // int(n_bytes)) + 1


def _close(a: torch.Tensor, b: torch.Tensor, tol: float):
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool((err <= tol + tol * b.abs()).all())
    return ok, float(err.max())


def _bound(n_bytes: float, flops: float, dtype: torch.dtype):
    """(ms, "bytes" or "operations"): ``launch/mesh.py``'s H100 bound."""
    t, by = mesh.bound_s(n_bytes, flops, dtype)
    return t * 1e3, by


def _time_row(row: dict, fns: dict, sets: list, calls=10) -> None:
    """Adds each of ``fns`` (name -> function of one input set) to ``row``:
    its warm time (``sets[0]`` every call, so it sits in L2) as
    ``<name>_warm`` and, when more than one set is given, its cold time
    (the sets rotated past L2, as HBM serves them) as ``<name>``.
    ``calls``: the calls a graph holds, or a dict of them by name."""
    for key, fn in fns.items():
        n = calls[key] if isinstance(calls, dict) else calls
        row[key + "_warm"] = time_ms(lambda i: fn(*sets[0]), calls=n)
        if len(sets) > 1:
            row[key] = time_ms(lambda i: fn(*sets[i]), len(sets),
                               calls=n)
        else:
            row[key] = row[key + "_warm"]


def _grad_ms(row: dict, key: str, fwd, inputs: list, grad_out,
             sets: list, calls: int = 10) -> None:
    """Library yardstick of a backward: the time of ``fwd`` plus its
    backward (``torch.autograd.grad`` w.r.t. ``inputs``) less that of
    ``fwd`` alone, warm and cold as ``_time_row`` does.  ``fwd`` and
    ``inputs`` take one input set."""
    both = {}
    _time_row(both, {
        "fb": lambda *s: torch.autograd.grad(fwd(*s), inputs(*s), grad_out),
        "f": lambda *s: fwd(*s)}, sets, calls)
    row[key + "_warm"] = both["fb_warm"] - both["f_warm"]
    row[key] = both["fb"] - both["f"]


def phase_rmsnorm(gen: torch.Generator, failures: list) -> dict:
    main = None
    worst = 0.0
    eps = 1e-5
    for shape in RMS_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            D = shape[-1]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randn((D,), generator=gen, device="cuda").to(dtype)
            got = krms.rmsnorm_cuda(x, w, eps)
            want = ref.rmsnorm_ref(x, w, eps)
            torch.cuda.synchronize()
            ok, err = _close(got, want, TOL[dtype])
            worst = max(worst, err)
            flops, n_bytes = krms.work(x, w)
            is_main = tuple(shape) == RMS_MAIN and dtype == torch.bfloat16
            cold = dtype == torch.bfloat16 and (
                is_main or tuple(shape) in RMS_SSM + RMS_SERVE + RMS_NEW)
            sets = [(x, w)] + ([(x.clone(), w.clone()) for _ in
                               range(cold_sets(n_bytes) - 1)]
                               if cold else [])
            row = {"shape": list(shape), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok}
            _time_row(row, {
                "ms": lambda x, w: krms.rmsnorm_cuda(x, w, eps),
                "plain_ms": lambda x, w: ref.rmsnorm_ref(x, w, eps),
                "library_ms": lambda x, w: F.rms_norm(x, (D,), w, eps)},
                sets)
            del sets
            row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops, dtype)
            log("rmsnorm", json.dumps(row))
            if not ok:
                failures.append(f"rmsnorm {shape} {dtype}: max err {err}")
            if is_main:
                main = row
    return dict(main, max_abs_err=worst)


def _flash_mask(Sq, Sk, causal, window, q_off, kv_len):
    q_pos = q_off + torch.arange(Sq, device="cuda")[:, None]
    k_pos = torch.arange(Sk, device="cuda")[None, :]
    m = k_pos < (Sk if kv_len is None else kv_len)
    if causal:
        m = m & (k_pos <= q_pos)
    if window:
        m = m & (k_pos > q_pos - window)
    return m


def _sdpa_inputs(q, k, v):
    """SDPA's layout (B, H, S, D) with K/V repeated to Hq heads."""
    G = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2), k.repeat_interleave(G, dim=2).transpose(1, 2),
            v.repeat_interleave(G, dim=2).transpose(1, 2))


def phase_flash(gen: torch.Generator, failures: list) -> dict:
    main = None
    worst = 0.0
    for case in (FLASH_CASES + [FLASH_MAIN, FLASH_ZAMBA2] + FLASH_SERVE
                 + FLASH_NEW_SERVE):
        B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len = case
        kw = dict(causal=causal, sliding_window=window, q_offset=q_off,
                  kv_len=kv_len)
        mask = _flash_mask(Sq, Sk, causal, window, q_off, kv_len)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((B, S, H, D), generator=gen,
                                   device="cuda").to(dtype)
                       for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
            got = kflash.flash_attention_cuda(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            ok, err = _close(got, want, TOL[dtype])
            worst = max(worst, err)
            # the work this call needs: the visible (query, key) pairs and
            # the key rows that at least one query can see
            flops, n_bytes = kflash.work(q, k, **kw)
            is_main = case == FLASH_MAIN and dtype == torch.bfloat16
            cold = dtype == torch.bfloat16 and case in [
                FLASH_MAIN, FLASH_ZAMBA2] + FLASH_SERVE + FLASH_NEW_SERVE
            row = {"case": list(case), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok}
            log_untimed = (dtype == torch.float32
                           and case in FLASH_F32_UNTIMED)
            if log_untimed:
                log("flash", json.dumps(row))
                if not ok:
                    failures.append(f"flash {case} {dtype}: max err {err}")
                continue
            sets = [(q, k, v)] + ([tuple(t.clone() for t in (q, k, v))
                                   for _ in range(cold_sets(n_bytes) - 1)]
                                  if cold else [])
            sets = [s + _sdpa_inputs(*s) for s in sets]
            # library yardstick: SDPA with the same boolean mask (timed
            # only; the port never calls it)
            _time_row(row, {
                "ms": lambda q, k, v, *_: kflash.flash_attention_cuda(
                    q, k, v, **kw),
                "plain_ms": lambda q, k, v, *_: ref.flash_attention_ref(
                    q, k, v, **kw),
                "library_ms": lambda q, k, v, qt, kt, vt:
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask)},
                sets, NEW_SHAPE_CALLS if case in FLASH_NEW_SERVE else 10)
            del sets
            row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops, dtype)
            log("flash", json.dumps(row))
            if not ok:
                failures.append(f"flash {case} {dtype}: max err {err}")
            if is_main:
                main = row
    return dict(main, max_abs_err=worst)


def phase_rmsnorm_bwd(gen: torch.Generator, failures: list) -> dict:
    """The backward kernel (dx, dw) against the plain backward, both fed
    the plain forward's ``inv``; the forward's ``inv`` checked too.  The
    f32 kernel is held against ``rmsnorm_bwd_ref`` evaluated in f64: dw
    sums up to 8192 rows, and the f32 kernel and the f32 plain version,
    each within 3e-5 of that sum, can lie more than 3e-5 apart; the f32
    plain version's own distance from it is logged beside."""
    main = None
    worst = 0.0
    eps = 1e-5
    for shape, dtype in [(s, d) for s in RMS_TRAIN_SHAPES + RMS_SSM + RMS_NEW
                         for d in (torch.bfloat16, torch.float32)
                         if not (s in RMS_BWD_BF16_ONLY
                                 and d == torch.float32)]:
        D = shape[-1]
        x, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        w = torch.randn((D,), generator=gen, device="cuda").to(dtype)
        _, inv = krms.rmsnorm_cuda(x, w, eps, return_inv=True)
        _, inv_ref = ref.rmsnorm_fwd_ref(x, w, eps)
        got = krms.rmsnorm_bwd_cuda(x, w, inv_ref, g)
        want = ref.rmsnorm_bwd_ref(x, w, inv_ref, g)
        if dtype == torch.float32:
            plain, want = want, ref.rmsnorm_bwd_ref(
                x, w, inv_ref, g, compute_dtype=torch.float64)
        torch.cuda.synchronize()

        def errors(got, ok, err):
            for a, b in zip(got, want):
                ok_i, err_i = _close(a, b, TOL[dtype])
                ok, err = ok and ok_i, max(err, err_i)
            return ok, err

        ok, err = errors(got, *_close(inv, inv_ref, TOL[torch.float32]))
        worst = max(worst, err)
        flops, n_bytes = krms.bwd_work(x, w)
        is_main = tuple(shape) == RMS_MAIN and dtype == torch.bfloat16
        cold = dtype == torch.bfloat16 and (
            is_main or tuple(shape) in RMS_SSM + RMS_NEW)
        sets = [(x, w, inv_ref, g)] + (
            [tuple(t.clone() for t in (x, w, inv_ref, g))
             for _ in range(cold_sets(n_bytes) - 1)] if cold else [])
        row = {"shape": list(shape), "dtype": str(dtype)[6:],
               "max_abs_err": err, "ok": ok}
        if dtype == torch.float32:
            row["plain_f32_vs_f64"] = errors(plain, True, 0.0)[1]
            del plain
        _time_row(row, {
            "ms": lambda x, w, inv, g: krms.rmsnorm_bwd_cuda(x, w, inv,
                                                             g),
            "plain_ms": lambda x, w, inv, g: ref.rmsnorm_bwd_ref(
                x, w, inv, g)}, sets)
        lib_sets = [(x.clone().requires_grad_(),
                     w.clone().requires_grad_()) for x, w, _, _ in sets]
        _grad_ms(row, "library_ms",
                 lambda x, w: F.rms_norm(x, (D,), w, eps),
                 lambda x, w: (x, w), g, lib_sets)
        del sets, lib_sets
        row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops, dtype)
        log("rmsnorm_bwd", json.dumps(row))
        if not ok:
            failures.append(f"rmsnorm_bwd {shape} {dtype}: max err {err}")
        if is_main:
            main = row
    return dict(main, max_abs_err=worst)


def _split_rms(x, w, g, n: int, eps: float, kernel: bool,
               compute_dtype=torch.float32):
    """A row split into ``n`` column shards, as ``n`` ranks hold it: the
    split-row forward and backward of each shard, the statistics summed
    over the shards in order (the all-reduce of one process).  Returns
    (y, inv, dx, dw) with the shards' columns concatenated."""
    D = x.shape[-1] // n
    xs, ws, gs = ([t[..., i * D:(i + 1) * D].contiguous() for i in range(n)]
                  for t in (x, w, g))
    if kernel:
        stat = sum(krms.rmsnorm_stat_cuda(a, b) for a, b in zip(xs, ws))
        fwd = [krms.rmsnorm_split_cuda(a, b, stat, n * D, eps)
               for a, b in zip(xs, ws)]
        bstat = sum(krms.rmsnorm_bwd_stat_cuda(a, b, f[1], c)
                    for a, b, c, f in zip(xs, ws, gs, fwd))
        bwd = [krms.rmsnorm_split_bwd_cuda(a, b, f[1], c, bstat, n * D)
               for a, b, c, f in zip(xs, ws, gs, fwd)]
    else:
        stat = sum(ref.rmsnorm_stat_ref(a) for a in xs)
        fwd = [ref.rmsnorm_split_fwd_ref(a, b, stat, n * D, eps)
               for a, b in zip(xs, ws)]
        kw = dict(compute_dtype=compute_dtype)
        bstat = sum(ref.rmsnorm_bwd_stat_ref(a, b, f[1], c, **kw)
                    for a, b, c, f in zip(xs, ws, gs, fwd))
        bwd = [ref.rmsnorm_split_bwd_ref(a, b, f[1], c, bstat, n * D, **kw)
               for a, b, c, f in zip(xs, ws, gs, fwd)]
    return (torch.cat([f[0] for f in fwd], -1), fwd[0][1],
            torch.cat([b[0] for b in bwd], -1),
            torch.cat([b[1] for b in bwd], -1))


def phase_rmsnorm_split(gen: torch.Generator, failures: list) -> tuple:
    """The split-row RMSNorm (the mamba block's gated norm over a row
    whose din columns lie on RMS_SPLIT_RANKS ranks) at a rank's RMS_SPLIT
    shapes: each shard's two forward launches (the partial sum of squares,
    then the columns normalised by the summed statistic) and two backward
    launches (the partial sum of g w xhat, then dx and the shard's dw),
    the statistics summed over the shards in this process, against the
    plain twins on the same shards (the f32 backward's in f64, as phase
    rmsnorm_bwd) and against the whole-row kernels on the gathered row;
    bf16 2e-2, f32 3e-5.  Each bf16 launch timed cold on one shard beside
    its bound and the plain twin's time; no PyTorch call computes a
    partial row, so the library yardstick is ``F.rms_norm`` (forward, and
    forward plus backward less forward) on the whole row, logged as
    context.  Returns the forward's and the backward's rows."""
    rows = {"fwd": None, "bwd": None}
    worst = {"fwd": 0.0, "bwd": 0.0}
    eps, n = 1e-5, RMS_SPLIT_RANKS
    for shape in RMS_SPLIT:
        for dtype in (torch.bfloat16, torch.float32):
            T, D = shape
            x, g = (torch.randn((T, n * D), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            w = torch.randn((n * D,), generator=gen, device="cuda").to(dtype)
            got = _split_rms(x, w, g, n, eps, True)
            plain = _split_rms(x, w, g, n, eps, False,
                               torch.float64 if dtype == torch.float32
                               else torch.float32)
            y_w, inv_w = krms.rmsnorm_cuda(x, w, eps, return_inv=True)
            whole = (y_w, inv_w) + krms.rmsnorm_bwd_cuda(x, w, inv_w, g)
            torch.cuda.synchronize()
            for half, idx in (("fwd", (0, 1)), ("bwd", (2, 3))):
                ok, err, err_whole = True, 0.0, 0.0
                for i in idx:
                    tol = TOL[dtype if got[i].dtype == dtype
                              else torch.float32]
                    ok_i, err_i = _close(got[i], plain[i], tol)
                    ok_w, err_w = _close(got[i], whole[i], tol)
                    ok, err = ok and ok_i and ok_w, max(err, err_i)
                    err_whole = max(err_whole, err_w)
                worst[half] = max(worst[half], err)
                row = {"half": half, "shard": [T, D], "whole_row": n * D,
                       "shards": n, "dtype": str(dtype)[6:],
                       "max_abs_err": err, "max_abs_err_whole_kernel":
                       err_whole, "ok": ok}
                if dtype == torch.bfloat16:
                    _time_split_rms(row, half, x[:, :D].contiguous(),
                                    w[:D].contiguous(), g[:, :D].contiguous(),
                                    x, w, g, n * D, eps)
                log("rmsnorm_split", json.dumps(row))
                if not ok:
                    failures.append(f"rmsnorm_split {half} {shape} {dtype}: "
                                    f"max err {err} (plain), {err_whole} "
                                    f"(whole-row kernel)")
                if shape == RMS_SPLIT[0] and dtype == torch.bfloat16:
                    rows[half] = row
            del x, g, w, got, plain, whole
    return tuple(dict(rows[h], max_abs_err=worst[h]) for h in ("fwd", "bwd"))


def _time_split_rms(row: dict, half: str, x, w, g, xw, ww, gw,
                    d_whole: int, eps: float) -> None:
    """Times one shard's launches of ``half`` (cold, as phase rmsnorm):
    the statistic's (``stat_ms``), the rows' (``rows_ms``) and both
    (``ms``), the plain twin's two steps (``plain_ms``), each launch's
    bound and their sum (``bound_ms``), and ``F.rms_norm`` on the whole
    row (``whole_row_library_ms``)."""
    stat = krms.rmsnorm_stat_cuda(x, w)
    _, inv = krms.rmsnorm_split_cuda(x, w, stat, d_whole, eps)
    bstat = krms.rmsnorm_bwd_stat_cuda(x, w, inv, g)
    if half == "fwd":
        fns = {"stat_ms": lambda x, w, g, inv: krms.rmsnorm_stat_cuda(x, w),
               "rows_ms": lambda x, w, g, inv: krms.rmsnorm_split_cuda(
                   x, w, stat, d_whole, eps),
               "ms": lambda x, w, g, inv: krms.rmsnorm_split_cuda(
                   x, w, krms.rmsnorm_stat_cuda(x, w), d_whole, eps),
               "plain_ms": lambda x, w, g, inv: ref.rmsnorm_split_fwd_ref(
                   x, w, ref.rmsnorm_stat_ref(x), d_whole, eps)}
        works = (krms.stat_work(x), krms.work(x, w, inv=True))
    else:
        fns = {"stat_ms": lambda x, w, g, inv: krms.rmsnorm_bwd_stat_cuda(
                   x, w, inv, g),
               "rows_ms": lambda x, w, g, inv: krms.rmsnorm_split_bwd_cuda(
                   x, w, inv, g, bstat, d_whole),
               "ms": lambda x, w, g, inv: krms.rmsnorm_split_bwd_cuda(
                   x, w, inv, g, krms.rmsnorm_bwd_stat_cuda(x, w, inv, g),
                   d_whole),
               "plain_ms": lambda x, w, g, inv: ref.rmsnorm_split_bwd_ref(
                   x, w, inv, g, ref.rmsnorm_bwd_stat_ref(x, w, inv, g),
                   d_whole)}
        works = (krms.stat_work(x, g=True), krms.bwd_work(x, w))
    n_bytes = sum(b for _, b in works)
    sets = [(x, w, g, inv)] + [tuple(t.clone() for t in (x, w, g, inv))
                               for _ in range(cold_sets(n_bytes) - 1)]
    _time_row(row, fns, sets)
    bounds = [_bound(b, f, x.dtype) for f, b in works]
    row["stat_bound_ms"], row["rows_bound_ms"] = (b[0] for b in bounds)
    row["bound_ms"] = sum(b[0] for b in bounds)
    row["bound_by"] = "bytes" if all(b[1] == "bytes" for b in bounds) \
        else "operations"
    row["library_ms"] = None  # no PyTorch call normalises a partial row
    D = xw.shape[-1]
    whole = {}
    if half == "fwd":
        _time_row(whole, {"lib": lambda x, w: F.rms_norm(x, (D,), w, eps)},
                  [(xw, ww)])
        row["whole_row_library_ms"] = whole["lib"]
    else:
        _grad_ms(whole, "lib", lambda x, w: F.rms_norm(x, (D,), w, eps),
                 lambda x, w: (x, w), gw,
                 [(xw.clone().requires_grad_(), ww.clone().requires_grad_())])
        row["whole_row_library_ms"] = whole["lib"]
    del sets


def phase_flash_bwd(gen: torch.Generator, failures: list) -> dict:
    """The forward's ``lse`` against the plain forward's, and the backward
    kernels (dq, dk, dv) against the plain backward on the same out, lse
    and dout, at the CASES and the training shapes (yi-6b's, zamba2's
    shared block, FLASH_TRAIN_NEW's); at the training shapes also the
    forward writing ``lse`` timed (rows "flash_lse")."""
    main = None
    fwd_rows = []
    worst = worst_lse = 0.0
    for case in FLASH_CASES + [FLASH_TRAIN, FLASH_TRAIN_ZAMBA2] + \
            FLASH_TRAIN_NEW:
        B, Sq, Sk, Hq, Hkv, D, causal, window, q_off, kv_len = case
        kw = dict(causal=causal, sliding_window=window, q_offset=q_off,
                  kv_len=kv_len)
        mask = _flash_mask(Sq, Sk, causal, window, q_off, kv_len)
        for dtype in (torch.bfloat16, torch.float32):
            q, do = (torch.randn((B, Sq, Hq, D), generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((B, Sk, Hkv, D), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            _, lse = kflash.flash_attention_cuda(q, k, v, return_lse=True,
                                                 **kw)
            o, lse_ref = ref.flash_attention_fwd_ref(q, k, v, **kw)
            got = kflash.flash_attention_bwd_cuda(q, k, v, o, lse_ref, do,
                                                  **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse_ref, do, **kw)
            torch.cuda.synchronize()
            ok, err_lse = _close(lse, lse_ref, TOL[dtype])
            err = 0.0
            for a, b in zip(got, want):
                ok_i, err_i = _close(a, b, TOL[dtype])
                ok, err = ok and ok_i, max(err, err_i)
            worst, worst_lse = max(worst, err), max(worst_lse, err_lse)
            flops, n_bytes = kflash.bwd_work(q, k, **kw)
            is_main = case == FLASH_TRAIN and dtype == torch.bfloat16
            train = dtype == torch.bfloat16 and case in [
                FLASH_TRAIN, FLASH_TRAIN_ZAMBA2] + FLASH_TRAIN_NEW
            row = {"case": list(case), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "lse_max_abs_err": err_lse, "ok": ok}
            if dtype == torch.float32 and case in FLASH_F32_UNTIMED:
                log("flash_bwd", json.dumps(row))
                if not ok:
                    failures.append(f"flash bwd/lse {case} {dtype}: max "
                                    f"err {err}, lse {err_lse}")
                continue
            inputs = (q, k, v, o, lse_ref, do)
            sets = [inputs] + ([tuple(t.clone() for t in inputs)
                                for _ in range(cold_sets(n_bytes) - 1)]
                               if train else [])
            # the plain versions take 15-40 ms a call at zamba2's shape
            calls = NEW_SHAPE_CALLS if case in FLASH_TRAIN_NEW else (
                3 if case == FLASH_TRAIN_ZAMBA2 else 10)
            _time_row(row, {
                "ms": lambda q, k, v, o, lse, do:
                    kflash.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                    **kw),
                "plain_ms": lambda q, k, v, o, lse, do:
                    ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)},
                sets, calls)
            # library yardstick: SDPA with K/V repeated to Hq heads (timed
            # only; the port never calls it); causal self-attention as
            # is_causal, any other mask as a boolean mask
            plain_causal = (causal and Sq == Sk and not window and not q_off
                            and kv_len is None)
            lib_sets = [tuple(t.detach().requires_grad_() for t in
                              _sdpa_inputs(*st[:3])) for st in sets]
            _grad_ms(row, "library_ms",
                     lambda qt, kt, vt: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=plain_causal,
                         attn_mask=None if plain_causal else mask),
                     lambda qt, kt, vt: (qt, kt, vt), do.transpose(1, 2),
                     lib_sets, calls)
            row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops, dtype)
            if is_main:
                # device time of each of the backward's kernels in one call
                row["split"] = _profile(
                    lambda: kflash.flash_attention_bwd_cuda(*inputs, **kw),
                    pick=("flash_bwd",))["picked"]
            log("flash_bwd", json.dumps(row))
            if not ok:
                failures.append(f"flash bwd/lse {case} {dtype}: max err "
                                f"{err}, lse {err_lse}")
            if is_main:
                main = row
            if train:
                fwd = {"case": list(case), "dtype": str(dtype)[6:]}
                # the training forward: the same kernel writing lse too
                sets = [st[:3] + _sdpa_inputs(*st[:3]) for st in sets]
                _time_row(fwd, {
                    "ms": lambda q, k, v, *_: kflash.flash_attention_cuda(
                        q, k, v, return_lse=True, **kw),
                    "plain_ms": lambda q, k, v, *_:
                        ref.flash_attention_fwd_ref(q, k, v, **kw),
                    "library_ms": lambda q, k, v, qt, kt, vt:
                        F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=plain_causal,
                            attn_mask=None if plain_causal else mask)},
                    sets, calls)
                fwd_flops, fwd_bytes = kflash.work(q, k, lse=True, **kw)
                fwd["bound_ms"], fwd["bound_by"] = _bound(fwd_bytes,
                                                          fwd_flops, dtype)
                fwd_rows.append(fwd)
            del sets, lib_sets
    # yi-6b's training shape, zamba2's, then FLASH_TRAIN_NEW's
    for fwd in fwd_rows:
        log("flash_lse", json.dumps(dict(fwd, max_abs_err=worst_lse)))
    return dict(main, max_abs_err=worst)


def phase_cross_entropy(gen: torch.Generator, failures: list) -> dict:
    """The CE kernel's per-token (nll, lse) against the plain blockwise
    statistics, timed at the loss heads' shapes in bf16 (yi-6b's, the
    main row, then mamba2-130m's and zamba2-1.2b's).  Their vocab
    matrices (524, 77 and 131 MB) are past L2, so warm times only."""
    main = None
    worst = 0.0
    for shape in CE_SHAPES:
        T, D, V = shape
        for dtype in (torch.bfloat16, torch.float32):
            h = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((V, D), generator=gen, device="cuda")
                 * D ** -0.5).to(dtype)
            t = torch.randint(0, V, (T,), generator=gen, device="cuda")
            got = kce.cross_entropy_cuda(h, w, t)
            want = ref.cross_entropy_stats_ref(h, w, t, block_v=8192)
            torch.cuda.synchronize()
            ok, err = True, 0.0
            for a, b in zip(got, want):
                ok_i, err_i = _close(a, b, TOL[dtype])
                ok, err = ok and ok_i, max(err, err_i)
            worst = max(worst, err)
            row = {"shape": list(shape), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok}
            is_main = shape == CE_MAIN and dtype == torch.bfloat16
            if dtype == torch.bfloat16 and shape in [CE_MAIN] + CE_SSM \
                    + CE_NEW:
                # library yardstick: logits by cuBLAS, then cross_entropy
                _time_row(row, {
                    "ms": lambda h, w, t: kce.cross_entropy_cuda(h, w, t),
                    "plain_ms": lambda h, w, t: ref.cross_entropy_stats_ref(
                        h, w, t, block_v=8192),
                    "library_ms": lambda h, w, t: F.cross_entropy(
                        torch.matmul(h, w.t()).float(), t,
                        reduction="none")}, [(h, w, t)], calls=3)
                flops, n_bytes = kce.work(h, w)
                row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops,
                                                          dtype)
            if is_main:
                main = row
            log("cross_entropy", json.dumps(row))
            if not ok:
                failures.append(f"cross_entropy {shape} {dtype}: max err "
                                f"{err}")
            del h, w
    return dict(main, max_abs_err=worst)


def _ssd_inputs(gen: torch.Generator, case, dtype):
    """The inputs of tests/test_kernels.py's SSD sweep, on the card."""
    B, S, H, P, G, N, _ = case

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return ((rn(B, S, H, P) * 0.5).to(dtype), F.softplus(rn(B, S, H)),
            -torch.exp(rn(H) * 0.3), (rn(B, S, G, N) * 0.3).to(dtype),
            (rn(B, S, G, N) * 0.3).to(dtype))


def phase_ssd(gen: torch.Generator, failures: list) -> dict:
    """The SSD kernel's y and final state against ``ssd_ref`` on every
    case and dtype, the models' shapes timed cold and warm; then two calls
    chained through ``init_state`` against one call over the whole."""
    main = None
    worst = 0.0
    for case in SSD_CASES:
        chunk = case[-1]
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, A, Bm, Cm = _ssd_inputs(gen, case, dtype)
            got = kssd.ssd_cuda(x, dt, A, Bm, Cm, chunk=chunk,
                                return_state=True)
            want = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk,
                               return_state=True)
            torch.cuda.synchronize()
            ok, err = True, 0.0
            for a, b in zip(got, want):
                ok_i, err_i = _close(a, b, SSD_TOL[dtype])
                ok, err = ok and ok_i, max(err, err_i)
            worst = max(worst, err)
            row = {"case": list(case), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok}
            del got, want
            flops, n_bytes = kssd.work(x, Bm, chunk=chunk)
            model = case in [SSD_ZAMBA2, SSD_MAMBA2] + SSD_LOCAL
            if model and dtype == torch.bfloat16:
                inputs = (x, dt, A, Bm, Cm)
                sets = [inputs] + [tuple(t.clone() for t in inputs)
                                   for _ in range(cold_sets(n_bytes) - 1)]
                _time_row(row, {
                    "ms": lambda *t: kssd.ssd_cuda(*t, chunk=chunk,
                                                   return_state=True),
                    "plain_ms": lambda *t: ref.ssd_ref(*t, chunk=chunk,
                                                       return_state=True)},
                    sets, calls=4)
                del sets
                row["library_ms"] = None  # no PyTorch call computes it
                if case == SSD_ZAMBA2:
                    main = row
            row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops, dtype)
            log("ssd", json.dumps(row))
            if not ok:
                failures.append(f"ssd {case} {dtype}: max err {err}")
            del x, dt, A, Bm, Cm
    # two calls chained through the state against one over the whole
    case, cut = (2, 300, 8, 64, 1, 64, 128), 137
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, Bm, Cm = _ssd_inputs(gen, case, dtype)
        h0 = torch.randn((2, 8, 64, 64), generator=gen, device="cuda") * 0.1
        y1, h1 = kssd.ssd_cuda(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                               Cm[:, :cut], chunk=128, init_state=h0,
                               return_state=True)
        y2, h2 = kssd.ssd_cuda(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                               Cm[:, cut:], chunk=128, init_state=h1,
                               return_state=True)
        want_y, want_h = ref.ssd_ref(x, dt, A, Bm, Cm, chunk=128,
                                     init_state=h0, return_state=True)
        torch.cuda.synchronize()
        ok_y, err_y = _close(torch.cat([y1, y2], 1), want_y, SSD_TOL[dtype])
        ok_h, err_h = _close(h2, want_h, SSD_TOL[dtype])
        worst = max(worst, err_y, err_h)
        log("ssd_chain", json.dumps({
            "case": list(case), "cut": cut, "dtype": str(dtype)[6:],
            "max_abs_err": max(err_y, err_h), "ok": ok_y and ok_h}))
        if not (ok_y and ok_h):
            failures.append(f"ssd init_state chain {dtype}: y err {err_y}, "
                            f"state err {err_h}")
    return dict(main, max_abs_err=worst)


def _f32_chunk_rates(case, call) -> dict:
    """What held the CUDA-core chunk kernel of the backward's first
    design: ``ssd_bwd_chunk_kernel<f32>`` (its f32 instance, which the f32
    path keeps) profiled in one ``call``, and the warp instructions its
    loops execute at ``case`` (8 warps a block, a block per (chunk, head,
    batch)): FMAs and 32-bit shared-memory loads, as shares of what the
    SMs can execute in that time at the card's maximum SM clock (4 warp
    FMAs and 1 warp shared-memory load a clock a SM: 128 FP32 lanes, 32
    banks of 4 bytes)."""
    B, S, H, P, G, N, Q = case
    kp, kn = -(-P // 32), -(-N // 32)
    # the staged slices of dx, dC and dB (i or j over Q, then the inter-
    # chunk product over a 32 x 32 slice of the state), 16 FMAs and 10
    # loads a step; the two Q x Q tiles, 64 FMAs and 16 loads a step
    steps = kp * Q + kp * kn * 32 + 2 * (kn * Q + kn * kp * 32)
    warps = 8 * -(-S // Q) * H * B
    fma = warps * (64 * 32 * (kp + kn) + 16 * steps)
    lds = warps * (16 * 32 * (kp + kn) + 10 * steps)
    for _ in range(2):  # the profiler has come back empty once
        prof = _profile(call, pick=("ssd_bwd_chunk_kernel",))
        ms = sum(t for _, t, _ in prof["picked"])
        if ms > 0:
            break
    else:
        return {"ms": None, "not_measured": "the profiler saw no "
                "ssd_bwd_chunk_kernel in two tries"}
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    slots = torch.cuda.get_device_properties(0).multi_processor_count \
        * mhz * 1e6 * ms * 1e-3
    return {"ms": ms, "max_sm_mhz": mhz, "warp_fma": fma, "warp_lds": lds,
            "fma_share": fma / (4 * slots), "lds_share": lds / slots}


def phase_ssd_bwd(gen: torch.Generator, failures: list) -> dict:
    """The SSD backward kernels against ``ssd_bwd_ref`` on every case and
    dtype, with an initial state and a cotangent of the final state: dx,
    ddt, dB, dC and d_init elementwise at SSD_TOL, dA (a sum over B * S
    terms) at relative L2 SSD_TOL; the models' training shapes timed cold
    and warm (no initial state, as in training).  The f32 kernel is held
    against ``ssd_bwd_ref`` evaluated in f64: at the models' shapes the
    f32 kernel and the f32 plain version each lie within SSD_TOL of it,
    but not always of each other (the chunk's cumulative decay, rounded in
    f32 at magnitudes near 100, moves every term of sums that cancel by
    ~1e-5 relative); the f32 plain version's own distance from it is
    logged beside."""
    main = None
    worst = 0.0
    names = ("dx", "ddt", "dA", "dB", "dC", "d_init")
    for case in SSD_CASES:
        B, S, H, P, G, N, chunk = case
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, A, Bm, Cm = _ssd_inputs(gen, case, dtype)
            h0, dh = (torch.randn((B, H, P, N), generator=gen, device="cuda")
                      * 0.1 for _ in range(2))
            dy = torch.randn((B, S, H, P), generator=gen,
                             device="cuda").to(dtype)
            kw = dict(chunk=chunk, init_state=h0, d_state=dh)
            got = kssd.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, **kw)
            want = ref.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, **kw)
            if dtype == torch.float32:
                plain, want = want, ref.ssd_bwd_ref(
                    x, dt, A, Bm, Cm, dy, compute_dtype=torch.float64, **kw)
            torch.cuda.synchronize()

            def errors(got):
                ok, err, errs = True, 0.0, {}
                for name, a, b in zip(names, got, want):
                    if name == "dA":
                        errs["dA_rel_l2"] = _rel_l2(a, b)
                        ok = ok and errs["dA_rel_l2"] <= SSD_TOL[dtype]
                        continue
                    ok_i, err_i = _close(a, b, SSD_TOL[dtype])
                    ok, err = ok and ok_i, max(err, err_i)
                    errs[name] = err_i
                return ok, err, errs

            ok, err, errs = errors(got)
            worst = max(worst, err)
            row = {"case": list(case), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "errs": errs, "ok": ok}
            if dtype == torch.float32:
                row["plain_f32_vs_f64"] = errors(plain)[2]
                del plain
            del got, want
            flops, n_bytes = kssd.bwd_work(x, Bm, chunk=chunk)
            if case in [SSD_ZAMBA2, SSD_MAMBA2] + SSD_LOCAL \
                    and dtype == torch.bfloat16:
                inputs = (x, dt, A, Bm, Cm, dy)
                sets = [inputs] + [tuple(t.clone() for t in inputs)
                                   for _ in range(cold_sets(n_bytes) - 1)]
                _time_row(row, {
                    "ms": lambda *t: kssd.ssd_bwd_cuda(*t, chunk=chunk),
                    "plain_ms": lambda *t: ref.ssd_bwd_ref(*t, chunk=chunk)},
                    sets, calls=4)
                # each launch's device time (the state passes, the chunk
                # kernels, the reduction), a call of the last input set,
                # and the scratch a call allocates beside the f32 path's
                # layout (f32 states, a partial a head)
                prof = _profile(lambda: [kssd.ssd_bwd_cuda(
                    *sets[-1], chunk=chunk) for _ in range(3)],
                    pick=("ssd_bwd",))
                row["launch_ms"] = {name: ms / n
                                    for name, ms, n in prof["picked"]}
                row["scratch_bytes"] = kssd.bwd_scratch_bytes(
                    B, S, H, P, G, N, chunk, dtype)
                row["scratch_bytes_f32_layout"] = kssd.bwd_scratch_bytes(
                    B, S, H, P, G, N, chunk, torch.float32)
                del sets
                row["library_ms"] = None  # no PyTorch call computes it
                if case == SSD_ZAMBA2:
                    main = row
            if case in (SSD_ZAMBA2, SSD_MAMBA2) and dtype == torch.float32:
                row["f32_chunk_kernel"] = _f32_chunk_rates(
                    case, lambda: kssd.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy,
                                                    chunk=chunk))
            row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops, dtype)
            log("ssd_bwd", json.dumps(row))
            if not ok:
                failures.append(f"ssd_bwd {case} {dtype}: {errs}")
            del x, dt, A, Bm, Cm, dy, h0, dh
    return dict(main, max_abs_err=worst)


def _adamw_state(trees: dict, gen: torch.Generator) -> dict:
    """``trees`` (name -> tree of meta tensors) as CUDA tensors drawn from
    ``gen`` (N(0, 0.02): far above a clip of 1 over a model's leaves)."""
    def draw(t):
        return torch.empty(t.shape, dtype=t.dtype, device="cuda").normal_(
            0.0, 0.02, generator=gen)
    return {k: P.tree_map(draw, t) for k, t in trees.items()}


def _adamw_library(params, grads, lr: float):
    """``torch._fused_adamw_`` over the same params and gradients, grouped
    by dtype, with zero moments of the params' dtype (it takes no other):
    the yardstick of the update alone (no norm, no clip).  Returns (ms, the
    bytes it moves), or (None, 0) where those moments do not fit."""
    leaves = list(zip(P.tree_leaves(params), P.tree_leaves(grads)))
    n_bytes = sum(7 * p.numel() * p.element_size() for p, _ in leaves)
    if 2 * n_bytes / 7 > torch.cuda.mem_get_info()[0] - 2**30:
        return None, 0
    groups: dict = {}
    for p, g in leaves:
        groups.setdefault(p.dtype, []).append(
            (p, g, torch.zeros_like(p), torch.zeros_like(p),
             torch.ones((), device="cuda")))

    def call():
        for ls in groups.values():
            ps, gs, ms, vs, steps = (list(x) for x in zip(*ls))
            torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=lr, beta1=0.9,
                                beta2=0.95, weight_decay=0.1, eps=1e-8,
                                amsgrad=False, maximize=False)
    return _eager_ms(call), n_bytes


def _adamw_twins(params, grads, opt, lr: float, max_grad_norm: float
                 ) -> tuple:
    """Three steps of ``adamw_update`` on ``params`` and ``opt`` through
    the kernels and on clones through the plain version.  Returns (p, m
    and v bit for bit after each step, the largest relative gap of the
    two norms)."""
    twin = {"p": P.tree_map(torch.clone, params),
            "opt": {"m": P.tree_map(torch.clone, opt["m"]),
                    "v": P.tree_map(torch.clone, opt["v"]),
                    "step": opt["step"]}}
    same, norm_rel = True, 0.0
    for _ in range(3):
        mk = adamw_update(params, grads, opt, lr=lr,
                          max_grad_norm=max_grad_norm, use_kernels=True)[2]
        mp = adamw_update(twin["p"], grads, twin["opt"], lr=lr,
                          max_grad_norm=max_grad_norm, use_kernels=False)[2]
        norm_rel = max(norm_rel, abs(float(mk["grad_norm"])
                                     - float(mp["grad_norm"]))
                       / float(mp["grad_norm"]))
        same &= all(torch.equal(a[k], b[k]) for a, b in (
            (params, twin["p"]), (opt["m"], twin["opt"]["m"]),
            (opt["v"], twin["opt"]["v"])) for k in a)
    torch.cuda.synchronize()
    return same, norm_rel


def phase_adamw(gen: torch.Generator, failures: list) -> dict:
    """AdamW's kernels (``kernels/adamw.py``) against the plain version:
    yi-6b's largest leaf, ADAMW_LEAF, bf16 params and gradients, f32
    moments, three steps through ``adamw_update`` on each path
    (``_adamw_twins``), twice.  With no clip over N(0, 0.02) gradients:
    p, m and v bit for bit, the norm within 1e-5 (the two paths sum the
    squares in other orders).  With the clip on (at 0.3 of the norm, so a
    scale that is no power of two) over gradients whose norm both paths
    sum exactly (every 4096th element k / 64, |k| <= 6: at most 12.7 M
    units of 1/4096, below 2**24), so that both clip by the same scale:
    p, m and v bit for bit and the norms equal.  Then the leaf and the
    whole ADAMW_TREES states timed (eager, CUDA events, a step with the
    clip on): the kernels, the plain version and ``torch._fused_adamw_``
    (``_adamw_library``), beside the bound of the bytes the kernels move;
    the launches of a step, 2 x leaves + 1."""
    lr = 3e-4
    leaf = {"w": torch.empty(ADAMW_LEAF, dtype=torch.bfloat16,
                             device="meta")}
    st = _adamw_state({"p": leaf, "g": leaf}, gen)
    opt = adamw_init(st["p"])
    same, norm_rel = _adamw_twins(st["p"], st["g"], opt, lr, 1e30)
    if not (same and norm_rel <= 1e-5):
        failures.append(f"adamw {ADAMW_LEAF}: bit-equal {same}, norm "
                        f"relative {norm_rel}")
    sparse = torch.zeros(ADAMW_LEAF, dtype=torch.bfloat16, device="cuda")
    nz = sparse.view(-1)[::4096]
    nz.copy_(torch.randint(-6, 7, nz.shape, generator=gen,
                           device="cuda") / 64)
    clip_same, clip_rel = _adamw_twins(
        st["p"], {"w": sparse}, opt, lr, 0.3 * float(nz.double().norm()))
    if not (clip_same and clip_rel == 0.0):
        failures.append(f"adamw {ADAMW_LEAF} clipped: bit-equal "
                        f"{clip_same}, norm relative {clip_rel}")
    del sparse, nz
    rows = [_adamw_row("leaf", list(ADAMW_LEAF), st["p"], st["g"], opt, lr,
                       failures)]
    rows[0].update(bit_equal=same, norm_rel=norm_rel,
                   clip_bit_equal=clip_same, clip_norm_rel=clip_rel,
                   max_abs_err=0.0 if same and clip_same else float("nan"))
    del st, opt
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ADAMW_TREES:
        defs = registry.param_defs(get_config(arch))
        st = _adamw_state({"p": P.abstract(defs), "g": P.abstract(defs)},
                          gen)
        opt = adamw_init(st["p"])
        rows.append(_adamw_row(arch, arch, st["p"], st["g"], opt, lr,
                               failures))
        del st, opt
        gc.collect()
        torch.cuda.empty_cache()
    return dict(rows[0], trees=rows[1:])


def _adamw_row(label: str, shape, params, grads, opt, lr: float,
               failures: list) -> dict:
    """One AdamW timing row (see ``phase_adamw``)."""
    leaves = list(P.tree_leaves(params))
    n_bytes = flops = 0
    for p, g, m, v in zip(leaves, P.tree_leaves(grads),
                          P.tree_leaves(opt["m"]), P.tree_leaves(opt["v"])):
        for f, b in (kadamw.norm_work(g),
                     kadamw.update_work(p, g, m, v, clip=True,
                                        decay=p.dim() >= 2)):
            flops, n_bytes = flops + f, n_bytes + b
    step = lambda kernel: adamw_update(params, grads, opt, lr=lr,
                                       use_kernels=kernel)
    allocated = torch.cuda.memory_allocated()
    reset_launches()
    step(True)
    torch.cuda.synchronize()
    launches = {"adamw": kadamw.launches, "adamw_norm": kadamw.norm_launches}
    want = {"adamw": len(leaves), "adamw_norm": len(leaves) + 1}
    row = {"shape": shape, "leaves": len(leaves),
           "elements": sum(p.numel() for p in leaves), "bytes": n_bytes,
           "allocated_bytes": allocated, "launches_a_step": launches,
           "expected_launches": want,
           "ms": _eager_ms(lambda: step(True)),
           "plain_ms": _eager_ms(lambda: step(False))}
    row["library_ms"], row["library_bytes"] = _adamw_library(params, grads,
                                                             lr)
    row["finite"] = all(bool(torch.isfinite(t).all()) for t in leaves)
    row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops, torch.float32)
    log(f"adamw {label}", json.dumps(row))
    if launches != want or not row["finite"]:
        failures.append(f"adamw {label}: launches {launches} != {want} or "
                        f"not finite")
    return row


def _moe_routes(T: int, K: int, E: int, uneven: bool,
                gen: torch.Generator):
    """(top_e ascending, top_w) of T tokens, K distinct experts each:
    drawn uniformly, or ``uneven``: expert 5 every token, expert 3 none,
    the rest with weights falling as 1 / (e + 1)."""
    if uneven:
        w = 1.0 / torch.arange(1, E + 1, device="cuda", dtype=torch.float32)
        w[3] = w[5] = 0.0
        rest = torch.multinomial(w.expand(T, E), K - 1, generator=gen)
        top_e = torch.cat([rest, torch.full((T, 1), 5, device="cuda")], 1)
    else:
        top_e = torch.rand(T, E, generator=gen, device="cuda").topk(
            K, dim=1).indices
    top_w = torch.rand(T, K, generator=gen, device="cuda")
    return torch.sort(top_e, dim=1).values, top_w / top_w.sum(1,
                                                              keepdim=True)


def phase_moe_experts(gen: torch.Generator, failures: list) -> dict:
    """The grouped expert kernels (``kernels/moe_experts.py``) against
    their plain twin ``moe_experts_ref`` on the same inputs, at GRANITE's
    widths and the shapes its serving path gives them: a prefill block of
    ``MOE_TOKEN_BLOCK`` tokens (81,920 pairs) and a decode step of
    GRANITE_BATCH rows (160 pairs, the decode kernels), routes uniform and
    uneven (an expert with no rows, one with every token): TOL in bf16,
    and the same bits from two calls.  The uniform shapes are timed: the
    kernels, the plain twin (its expert bounds on the host, so that a
    graph holds it) and ``torch._grouped_mm`` (gate and up as one
    product, then down; where the card's torch has it), beside the bound
    of ``kmoe.work``."""
    cfg = get_config(GRANITE)
    E, K, d, f = (cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model,
                  cfg.d_ff)
    bf = torch.bfloat16
    w = [(torch.randn(E, a, b, generator=gen, device="cuda")
          * a ** -0.5).to(bf) for a, b in ((d, f), (d, f), (f, d))]
    main = None
    for T in (layers.MOE_TOKEN_BLOCK, GRANITE_BATCH):
        decode = T == GRANITE_BATCH
        for uneven in (False, True):
            x = torch.randn(T, d, generator=gen, device="cuda").to(bf)
            r = layers.moe_sort(cfg, *_moe_routes(T, K, E, uneven, gen))
            rows = (r.offsets[1:] - r.offsets[:-1]).tolist()
            got, again = (kmoe.moe_experts_cuda(x, r.token, r.offsets, *w,
                                                decode=decode)
                          for _ in range(2))
            want = kmoe.moe_experts_ref(x, r.token, r.offsets, *w)
            torch.cuda.synchronize()
            ok, err = _close(got, want, TOL[bf])
            same = bool(torch.equal(got, again))
            loads = not uneven or (rows[3] == 0 and rows[5] == T)
            row = {"tokens": T, "pairs": T * K, "decode": decode,
                   "routes": "uneven" if uneven else "uniform",
                   "rows_min": min(rows), "rows_max": max(rows),
                   "max_abs_err": err, "rel_l2": _rel_l2(got, want),
                   "bit_equal": same, "ok": ok and same and loads}
            del got, again, want
            if not uneven:
                _moe_times(row, x, r, w, decode)
                flops, n_bytes = kmoe.work(x, T * K, w[0])
                row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops, bf)
                if not decode:
                    main = row
            log("moe_experts", json.dumps(row))
            if not row["ok"]:
                failures.append(f"moe_experts {T} tokens {row['routes']}: "
                                f"max err {err}, bit-equal {same}, loads "
                                f"{rows[3]}, {rows[5]}")
            del x, r
    return main


def _moe_times(row: dict, x, r, w, decode: bool) -> None:
    """``phase_moe_experts``' timings of one shape into ``row``."""
    host = r.offsets.cpu()
    f = w[0].shape[2]
    _time_row(row, {
        "ms": lambda xs: kmoe.moe_experts_cuda(xs, r.token, r.offsets, *w,
                                               decode=decode),
        "plain_ms": lambda xs: kmoe.moe_experts_ref(xs, r.token, host, *w)},
        [(x,), (x.clone(),)], calls=4)
    row["library_ms"] = None
    if not hasattr(torch, "_grouped_mm"):
        return
    ends, wgu = r.offsets[1:].contiguous(), torch.cat(w[:2], dim=2)

    def library(xs):
        hu = torch._grouped_mm(xs[r.token.long()], wgu, offs=ends)
        return torch._grouped_mm(F.silu(hu[:, :f]) * hu[:, f:], w[2],
                                 offs=ends)
    lib = {}
    try:
        _time_row(lib, {"ms": library}, [(x,), (x.clone(),)], calls=4)
    except RuntimeError as e:  # logged, not a failure: a yardstick only
        row["library_error"] = str(e)[:200]
        return
    row["library_ms"], row["library_ms_warm"] = lib["ms"], lib["ms_warm"]


def serving_launches(cfg, gen: int) -> dict:
    """Kernel launches one ``run_serving`` with ``gen`` tokens implies: the
    norms of ``gen`` forwards (one prefill, gen - 1 decode steps); flash
    attention and the SSD scan in the prefill only (decode runs the plain
    ``_attention_kvseq`` and ``ssd_decode``).  whisper's encoder runs in
    the prefill only: two norms and one attention a block and its final
    norm; a decoder block has three norms and two attentions (self and
    cross), then the decoder's final norm."""
    L = cfg.num_layers
    if cfg.family == "encdec":
        Le = cfg.encoder_layers
        return {"rmsnorm": 2 * Le + 1 + (3 * L + 1) * gen,
                "flash_attention": Le + 2 * L, "ssd_scan": 0,
                "rmsnorm_split": 0}
    attn = {"dense": L, "moe": L, "vlm": L, "ssm": 0,
            "hybrid": L // max(cfg.attn_every, 1)}[cfg.family]
    ssd = 0 if cfg.family in ("dense", "moe", "vlm") else L
    # dense and moe: ln1, ln2 a block; mamba: ln and the gated norm a
    # block; the shared block: ln1, ln2 an application; ln_f
    norms = 2 * L + (2 * attn if cfg.family == "hybrid" else 0) + 1
    return {"rmsnorm": norms * gen, "flash_attention": attn,
            "ssd_scan": ssd, "rmsnorm_split": 0}


def split_launches(want: dict, cfg, forwards: int, backwards: int = 0
                   ) -> dict:
    """``want`` (a formula above, at one rank) for a rank of a ``model``
    split where the mamba blocks split: each block's gated norm runs on the
    split-row kernels, two launches a forward (``forwards`` a block) and
    two a backward (``backwards``) in place of one each."""
    L = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    out = dict(want, rmsnorm=want["rmsnorm"] - L * forwards,
               rmsnorm_split=2 * L * forwards)
    if "rmsnorm_bwd" in want:
        out.update(rmsnorm_bwd=want["rmsnorm_bwd"] - L * backwards,
                   rmsnorm_split_bwd=2 * L * backwards)
    return out


def _config(arch: str, layers=None):
    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def phase_serving(failures: list, arch: str = ARCH, prompt: int = PROMPT,
                  label: str = "serving", layers=None,
                  batch: int = BATCH) -> dict:
    krms.launches = kflash.launches = kssd.launches = 0
    krms.split_launches = 0
    res = serve.run_serving(arch, smoke=False, prompt_len=prompt, gen=GEN,
                            batch=batch, device=DEVICE, num_layers=layers)
    counts = {"rmsnorm": krms.launches, "flash_attention": kflash.launches,
              "ssd_scan": kssd.launches,
              "rmsnorm_split": krms.split_launches}
    cfg = _config(arch, layers)
    want = serving_launches(cfg, GEN)
    tok = res.pop("tokens")
    in_range = bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
    log(label, json.dumps(dict(res, prompt=prompt, batch=batch,
                               kv_cache_dtype=cfg.kv_cache_dtype,
                               launches=counts, expected_launches=want,
                               tokens_in_range=in_range)))
    if counts != want:
        failures.append(f"{arch} launch counts {counts} != expected {want}")
    TIMED_RUNS.append(dict(
        label=label, arch=arch, layers=layers, kind="serve", batch=batch,
        length=prompt, prefill_s=res["prefill_s"],
        decode_step_s=res["decode_s"] / (GEN - 1),
        peak_bytes=res["peak_mem_bytes"], launches=counts, steps=1))
    if not in_range or tuple(tok.shape) != (batch, GEN):
        failures.append(f"{arch} bad tokens: shape {tuple(tok.shape)}")
    return counts


def granite_launches(cfg, batch: int, prompt: int, gen: int) -> dict:
    """Kernel launches one ``run_serving`` of the granite_hybrid family
    with ``gen`` tokens implies: each forward the two norms a layer and
    the final norm; the Mamba2 mixers' gated norm and SSD scan once a
    block of rows at prefill (``MIXER_TOKEN_BLOCK`` tokens' worth of rows
    at a time), the gated norm once a decode step (the SSD state update
    is plain); flash attention once an attention layer at prefill; the
    grouped expert kernels two launches a call, a call for every
    ``MOE_TOKEN_BLOCK`` tokens a layer at prefill and one a layer a
    decode step."""
    L, mamba = cfg.num_layers, cfg.num_layers - len(cfg.attn_layers)
    blocks = -(-batch // max(1, granite_hybrid.MIXER_TOKEN_BLOCK // prompt))
    moe_calls = -(-batch * prompt // layers.MOE_TOKEN_BLOCK)
    return {"rmsnorm": (2 * L + 1) * gen + mamba * (blocks + gen - 1),
            "flash_attention": len(cfg.attn_layers),
            "ssd_scan": mamba * blocks, "rmsnorm_split": 0,
            "moe_experts": 2 * L * (moe_calls + gen - 1)}


def phase_serving_granite(failures: list) -> dict:
    """``run_serving`` of GRANITE at full width and depth (GRANITE_BATCH x
    GRANITE_PROMPT, GEN tokens), its launch counters set to 0 just before
    and read just after, held against ``granite_launches``."""
    krms.launches = kflash.launches = kssd.launches = kmoe.launches = 0
    krms.split_launches = 0
    res = serve.run_serving(GRANITE, smoke=False, prompt_len=GRANITE_PROMPT,
                            gen=GEN, batch=GRANITE_BATCH, device=DEVICE)
    counts = {"rmsnorm": krms.launches, "flash_attention": kflash.launches,
              "ssd_scan": kssd.launches,
              "rmsnorm_split": krms.split_launches,
              "moe_experts": kmoe.launches}
    cfg = get_config(GRANITE)
    want = granite_launches(cfg, GRANITE_BATCH, GRANITE_PROMPT, GEN)
    tok = res.pop("tokens")
    in_range = bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
    log("serving_granite", json.dumps(dict(
        res, prompt=GRANITE_PROMPT, batch=GRANITE_BATCH, launches=counts,
        expected_launches=want, tokens_in_range=in_range)))
    if counts != want:
        failures.append(f"{GRANITE} launch counts {counts} != expected "
                        f"{want}")
    if not in_range or tuple(tok.shape) != (GRANITE_BATCH, GEN):
        failures.append(f"{GRANITE} bad tokens: shape {tuple(tok.shape)}")
    return counts


def _modality_inputs(cfg, batch: int, gen: torch.Generator) -> dict:
    """whisper's frames or llava's patch embeddings for ``batch`` prompts,
    as ``synth_inputs`` draws them from ``gen``; nothing for the other
    families."""
    inputs = registry.synth_inputs(gen, cfg, ShapeConfig("e2e", 1, batch,
                                                         "prefill"),
                                   device=DEVICE)
    inputs.pop("tokens")
    return inputs


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@contextlib.contextmanager
def _recording_routes(routes: list, replay=None):
    """Records each ``layers.moe_route`` call's top-K choices (experts,
    kept pairs) into ``routes``.  With ``replay`` (another run's
    ``routes``, its calls in the same order), the n-th call routes by the
    n-th recorded choice instead of its own, weighted by its own gates."""
    route = layers.moe_route

    def recorded(p, cfg, x):
        r = route(p, cfg, x)
        routes.append((r.experts, r.keep))
        if replay is None:
            return r
        gates = torch.softmax(x.float() @ p["router"].float(), dim=-1)
        return layers.moe_assign(cfg, gates, replay[len(routes) - 1][0])

    layers.moe_route = recorded
    try:
        yield routes
    finally:
        layers.moe_route = route


def phase_end_to_end(failures: list, arch: str = ARCH, prompt: int = PROMPT,
                     label: str = "end_to_end", layers=None,
                     batch: int = BATCH):
    """(a) prefill logits through the kernels against the plain versions;
    (b) decode at position S against a prefill of S + 1.  For an MoE
    arch, (a) runs at the config's capacity factor (the share of (token,
    expert) pairs it drops and the top-K choices that differ between the
    two paths are logged) and (b) at E / K, where C >= S and nothing
    drops: a longer prefill can drop its last token from an overflowing
    expert, decode (C = 1 a row) never does."""
    cfg = _config(arch, layers)
    moe = cfg.family == "moe"
    cfg_d = (cfg.replace(moe_capacity_factor=cfg.num_experts
                         / cfg.num_experts_per_tok) if moe else cfg)
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    params = serve.init_params(cfg, 1, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt + 1),
                         generator=g, device=dev)
    # whisper's frames or llava's patches, the same for every call
    mod = _modality_inputs(cfg, batch, g)
    prompt_in = dict(mod, tokens=toks[:, :prompt])
    extra = cfg.num_img_patches if cfg.family == "vlm" else 0
    max_len = prompt + extra + GEN + 8
    kern, plain = RunConfig(), RunConfig(use_kernels=False)
    routes_k, routes_p = [], []
    with torch.inference_mode():
        cache = engine.init_cache(cfg, batch, max_len, dev)
        with _recording_routes(routes_k):
            lk, cache = registry.prefill(params, cfg, kern, prompt_in, cache)
        with _recording_routes(routes_p):
            lp, _ = registry.prefill(params, cfg, plain, prompt_in,
                                     engine.init_cache(cfg, batch, max_len,
                                                       dev))
        if moe:
            _, cache = registry.prefill(
                params, cfg_d, kern, prompt_in,
                engine.init_cache(cfg, batch, max_len, dev))
        ld, _ = registry.decode(params, cfg_d, kern, toks[:, prompt:], cache,
                                prompt + extra)
        ll, _ = registry.prefill(params, cfg_d, kern, dict(mod, tokens=toks),
                                 engine.init_cache(cfg, batch, max_len, dev))
        del cache
        # a yardstick for (a), not a check: the plain path with the same
        # weights in f32 (f32 activations; the KV cache as configured),
        # where the f32 copy fits beside the bf16 weights
        f32_bytes = sum(4 * t.numel() for t in P.tree_leaves(params))
        free = torch.cuda.mem_get_info()[0]
        lf = None
        if f32_bytes + F32_MARGIN_BYTES <= free:
            lf, _ = registry.prefill(
                P.cast_tree(params, torch.float32), cfg, plain, prompt_in,
                engine.init_cache(cfg, batch, max_len, dev))
    finite = all(bool(torch.isfinite(t).all()) for t in (lk, lp, ld, ll))
    a = _rel_l2(lk[:, -1], lp[:, -1])
    b = _rel_l2(ld[:, -1], ll[:, -1])
    row = {"arch": arch, "layers": cfg.num_layers, "batch": batch,
           "prompt": prompt, "prefix": extra,
           "kv_cache_dtype": cfg.kv_cache_dtype,
           "kernel_vs_plain_prefill_rel_l2": a,
           "decode_vs_longer_prefill_rel_l2": b, "logits_finite": finite,
           "tol": E2E_TOL}
    if lf is None:
        row["f32_yardstick"] = (f"skipped: the f32 copy needs {f32_bytes} B, "
                                f"{free} B free")
    else:
        row["kernel_vs_f32_plain_rel_l2"] = _rel_l2(lk[:, -1], lf[:, -1])
        row["plain_vs_f32_plain_rel_l2"] = _rel_l2(lp[:, -1], lf[:, -1])
    if moe:
        kept = sum(int(k.sum()) for _, k in routes_k)
        pairs = sum(k.numel() for _, k in routes_k)
        row.update(
            capacity_factor=cfg.moe_capacity_factor,
            decode_check_capacity_factor=cfg_d.moe_capacity_factor,
            prefill_dropped_pair_share=1 - kept / pairs,
            routing_flips_kernel_vs_plain=sum(
                int((ek != ep).any(-1).sum())
                for (ek, _), (ep, _) in zip(routes_k, routes_p)),
            routed_tokens=sum(ek.shape[0] * ek.shape[1]
                              for ek, _ in routes_k))
    row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(label, json.dumps(row))
    if not finite:
        failures.append(f"{arch}: non-finite logits")
    if not a <= E2E_TOL:
        failures.append(f"{arch}: kernel vs plain prefill rel L2 {a} > "
                        f"{E2E_TOL}")
    if not b <= E2E_TOL:
        failures.append(f"{arch}: decode vs prefill rel L2 {b} > {E2E_TOL}")
    return params, prompt_in


def _profile(fn, top: int = 8, ops: bool = False, pick=()) -> dict:
    """Wall time of ``fn`` (synchronised), the device time of the kernels
    the profiler saw inside it, their ratio (busy share), the top kernels,
    with ``ops`` the top operators by device time, and the kernels whose
    names hold one of ``pick`` (device ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    out = {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
           "busy_share": dev_us / 1e3 / (wall * 1e3),
           "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                   for e in kernels[:top]]}
    if pick:
        out["picked"] = [[e.key[:60], e.self_device_time_total / 1e3,
                          e.count] for e in kernels
                         if any(p in e.key for p in pick)]
    if ops:
        aten = sorted((e for e in events if e.device_type == DeviceType.CPU
                       and e.key.startswith("aten::")
                       and e.self_device_time_total > 0),
                      key=lambda e: e.self_device_time_total, reverse=True)
        out["top_ops"] = [[e.key, e.self_device_time_total / 1e3, e.count]
                          for e in aten[:top]]
    return out


def phase_breakdown(params, prompt: dict, arch: str = ARCH,
                    label: str = "breakdown", layers=None,
                    ops: bool = False) -> None:
    """Where the time goes in one warm prefill and four warm decode steps
    on the kernel path (torch.profiler; the shapes ran before, so cuBLAS
    and the allocator are warm); with ``ops`` the top operators too.
    ``prompt`` is the prefill's inputs, tokens and any frames or
    patches."""
    cfg = _config(arch, layers)
    run = RunConfig()
    B, S = prompt["tokens"].shape
    S += cfg.num_img_patches if cfg.family == "vlm" else 0
    max_len = S + GEN + 8
    with torch.inference_mode():
        cache = engine.init_cache(cfg, B, max_len, torch.device(DEVICE))
        box = {}

        def prefill():
            box["tok"], _ = engine.prefill_step(params, prompt, cache,
                                                cfg=cfg, run=run)

        def decode4():
            tok = box["tok"]
            for i in range(4):
                tok, _ = engine.decode_step(params, tok, cache, S + i,
                                            cfg=cfg, run=run)

        log(label + "_prefill", json.dumps(_profile(prefill, ops=ops)))
        log(label + "_decode4", json.dumps(_profile(decode4, ops=ops)))


def _eager_ms(fn, reps: int = 5) -> float:
    """Time of one call of ``fn`` as the serving loop runs it (eager, the
    host's launches included): CUDA events around ``reps`` calls after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def phase_serving_parts(params, cfg, batch: int, prompt: int,
                        label: str) -> None:
    """The parts of a layer that no kernel of the port computes, timed
    alone on layer 0's weights (plain torch, as the JAX package computes
    them in jnp): for an MoE arch the routing, the three expert products
    and the whole block, at the prefill's (batch, prompt) tokens and a
    decode step's (batch, 1), with the expert products' bound; for an
    int8 cache a quantisation of one layer's new K (prefill, decode) and
    a dequantisation of one layer's whole K cache."""
    g = torch.Generator(device=DEVICE).manual_seed(17)
    row = {"arch": cfg.name, "layers": cfg.num_layers}
    with torch.inference_mode():
        if cfg.family == "moe":
            p = P.layer(params["blocks"]["moe"], 0)
            E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
            act = layers.act_fn(cfg.act)
            for tag, S in (("prefill", prompt), ("decode", 1)):
                x = torch.randn((batch, S, d), generator=g, device=DEVICE,
                                dtype=torch.bfloat16)
                C = layers.moe_route(p, cfg, x).capacity
                xe = torch.randn((E, batch * C, d), generator=g,
                                 device=DEVICE, dtype=torch.bfloat16)

                def experts():
                    h = act(torch.bmm(xe, p["w_gate"])) * torch.bmm(
                        xe, p["w_up"])
                    return torch.bmm(h, p["w_down"])

                n_bytes = 2 * (3 * E * d * f + 2 * E * batch * C * d)
                bound, by = _bound(n_bytes, 6.0 * E * batch * C * d * f,
                                   torch.bfloat16)
                row[tag] = {
                    "tokens": batch * S, "capacity": C,
                    "route_ms": _eager_ms(
                        lambda: layers.moe_route(p, cfg, x)),
                    "experts_ms": _eager_ms(experts),
                    "experts_bound_ms": bound, "experts_bound_by": by,
                    "block_ms": _eager_ms(
                        lambda: layers.moe_block(p, cfg, RunConfig(), x))}
        if cfg.kv_cache_dtype == "int8":
            shp = (batch, prompt + GEN + 8, cfg.num_kv_heads, cfg.head_dim)
            cache = layers.quantize_kv(torch.randn(
                shp, generator=g, device=DEVICE, dtype=torch.bfloat16))
            k_new = torch.randn((batch, prompt) + shp[2:], generator=g,
                                device=DEVICE, dtype=torch.bfloat16)
            row["int8"] = {
                "quantize_prefill_k_ms": _eager_ms(
                    lambda: layers.quantize_kv(k_new)),
                "quantize_decode_k_ms": _eager_ms(
                    lambda: layers.quantize_kv(k_new[:, :1])),
                "dequantize_cache_k_ms": _eager_ms(
                    lambda: layers.dequantize_kv(*cache)),
                "cache_shape": list(shp)}
    log(label, json.dumps(row))


TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd", "cross_entropy", "ssd_scan",
                 "ssd_scan_bwd", "rmsnorm_split", "rmsnorm_split_bwd")


def training_launches(layers: int, steps: int, arch: str = ARCH,
                      cfg=None, optimizer_steps=None) -> dict:
    """Kernel launches of ``steps`` training steps of ``arch`` at
    ``layers`` layers: per step, with remat "full" or "dots", each block's
    forward runs twice (the forward, then the recompute in the backward):
    a transformer block's two norms and flash attention, a mamba block's
    two norms and SSD scan; the hybrid's shared block (one application
    every ``attn_every`` mamba blocks) is not checkpointed, so its two
    norms and flash attention run once; each block's backward runs once;
    ln_f is outside the checkpointed blocks; one CE call.  MoE and VLM
    blocks launch what a dense block does.  whisper (``layers`` decoder
    blocks, the config's encoder blocks, both stacks checkpointed): an
    encoder block's two norms and one attention, a decoder block's three
    norms and two attentions (self and cross), and two final norms.
    AdamW, in ``optimizer_steps`` of them (None: ``steps``; 0 for
    gradients alone): a norm launch and an update launch a param leaf
    and one finalize.  ``cfg``: the config, if not ``arch``'s (a smoke
    config)."""
    cfg = cfg or get_config(arch)
    L, family = layers, cfg.family
    opt = steps if optimizer_steps is None else optimizer_steps
    leaves = len(list(P.tree_leaves(registry.param_defs(cfg))))
    optim = {"adamw": leaves * opt, "adamw_norm": (leaves + 1) * opt}
    if family == "encdec":
        norms, attn = 2 * cfg.encoder_layers + 3 * L, cfg.encoder_layers \
            + 2 * L
        return {**{k: n * steps for k, n in zip(TRAIN_KERNELS, (
            2 * norms + 2, norms + 2, 2 * attn, attn, 1, 0, 0, 0, 0))},
                **optim}
    if family in ("moe", "vlm"):
        family = "dense"
    attn = {"dense": L, "ssm": 0,
            "hybrid": L // max(cfg.attn_every, 1)}[family]
    ssd = 0 if family == "dense" else L
    remat_attn = attn if family == "dense" else 0  # run again in backward
    norms = 2 * L + (2 * attn if family == "hybrid" else 0) + 1
    return {**{k: n * steps for k, n in zip(TRAIN_KERNELS, (
        norms + 2 * L, norms, attn + remat_attn, attn, 1, 2 * ssd, ssd, 0,
        0))}, **optim}


def reset_launches() -> None:
    for mod in (krms, kflash, kce, kssd, kadamw):
        mod.launches = 0
    krms.bwd_launches = kflash.bwd_launches = kssd.bwd_launches = 0
    krms.split_launches = krms.split_bwd_launches = 0
    kadamw.norm_launches = 0


def read_launches() -> dict:
    return {"rmsnorm": krms.launches, "rmsnorm_bwd": krms.bwd_launches,
            "flash_attention": kflash.launches,
            "flash_attention_bwd": kflash.bwd_launches,
            "cross_entropy": kce.launches, "ssd_scan": kssd.launches,
            "ssd_scan_bwd": kssd.bwd_launches,
            "rmsnorm_split": krms.split_launches,
            "rmsnorm_split_bwd": krms.split_bwd_launches,
            "adamw": kadamw.launches, "adamw_norm": kadamw.norm_launches}


def _timed_run(failures: list, label: str, layers: int, steps: int,
               arch: str = ARCH, seq_len: int = TRAIN_SEQ,
               global_batch: int = TRAIN_BATCH, **kw) -> tuple:
    """One ``run_training`` of ``arch`` at full width and ``layers``
    layers, counted (launch counters reset just before, read just after,
    held against ``training_launches``), its losses checked finite, and
    timed through ``on_step``.  Returns (result, launches, step stamps,
    start time)."""
    stamps = []

    def on_step(i, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    reset_launches()
    t0 = time.perf_counter()
    res = train.run_training(
        arch, smoke=False, num_layers=layers, steps=steps, seq_len=seq_len,
        global_batch=global_batch, device=DEVICE, on_step=on_step, **kw)
    counts = read_launches()
    want = training_launches(layers, res["steps"], arch)
    if counts != want:
        failures.append(f"{label} launch counts {counts} != {want}")
    if res["steps"] != steps or not all(
            torch.isfinite(torch.tensor(res["losses"]))):
        failures.append(f"{label}: {res['steps']} steps, losses "
                        f"{res['losses']}")
    return res, counts, stamps, t0


def phase_training(failures: list) -> tuple:
    """The training path at full width and depth, counted and timed; then
    one more step (warm) under the profiler."""
    cfg = get_config(ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the allocator's retries (a cudaMalloc that failed, the cache freed,
    # then retried), cumulative, at the points of this phase
    retries = {"before": torch.cuda.memory_stats()["num_alloc_retries"]}
    L = cfg.num_layers
    res, counts, stamps, t0 = _timed_run(failures, "training", L,
                                         TRAIN_STEPS, carousel=False)
    peak = torch.cuda.max_memory_allocated()
    retries["after_run_training"] = torch.cuda.memory_stats()[
        "num_alloc_retries"]
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log("training", json.dumps({
        "arch": ARCH, "layers": L, "steps": res["steps"],
        "tokens_per_step": tokens, "losses": res["losses"],
        "first_step_s": stamps[0] - t0 if stamps else None,
        "step_s_2_3": steps_s,
        "tokens_per_s": tokens / statistics.mean(steps_s),
        "wall_s": res["wall_s"], "peak_mem_bytes": peak,
        "opt_state_dtype": train.default_run_config(
            cfg, TRAIN_STEPS).opt_state_dtype,
        "launches": counts,
        "expected_launches": training_launches(L, TRAIN_STEPS)}))
    TIMED_RUNS.append(dict(
        label="training", arch=ARCH, layers=None, kind="train",
        batch=TRAIN_BATCH, length=TRAIN_SEQ,
        step_s=statistics.mean(steps_s), peak_bytes=peak, launches=counts,
        steps=res["steps"]))

    run = train.default_run_config(cfg, TRAIN_STEPS)
    batch = registry.synth_inputs(
        torch.Generator(device=DEVICE).manual_seed(TRAIN_STEPS), cfg,
        ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), "train",
        device=DEVICE)
    step_fn = tstep.make_train_step(cfg, run)
    state = res.pop("state")
    row = _profile(lambda: step_fn(state, batch), top=15, ops=True,
                   pick=("flash_fwd", "flash_bwd", "rmsnorm_bwd",
                         "rmsnorm_dw", "ce_fwd", "ce_merge"))
    retries["after_profiled_step"] = torch.cuda.memory_stats()[
        "num_alloc_retries"]
    # the step's two halves, each timed alone (synchronised), in
    # HALF_STEPS more warm steps
    row["grads_and_metrics_ms"], row["adamw_update_ms"] = [], []
    for _ in range(HALF_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, _ = tstep.grads_and_metrics(state["params"], cfg, run, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        adamw_update(state["params"], grads, state["opt"],
                     lr=run.learning_rate, weight_decay=run.weight_decay,
                     max_grad_norm=run.max_grad_norm)
        torch.cuda.synchronize()
        row["grads_and_metrics_ms"].append((t1 - t0) * 1e3)
        row["adamw_update_ms"].append((time.perf_counter() - t1) * 1e3)
        del grads
    retries["after_halves"] = torch.cuda.memory_stats()["num_alloc_retries"]
    row["num_alloc_retries"] = retries
    log("breakdown_train_step", json.dumps(row))
    del state, res, batch
    torch.cuda.empty_cache()
    return counts, steps_s


def phase_training_arch(failures: list, arch: str, layers=None,
                        seq_len: int = SSM_TRAIN_SEQ,
                        batch: int = TRAIN_BATCH, label=None) -> dict:
    """``run_training(arch, smoke=False, num_layers=layers, steps=
    TRAIN_STEPS, seq_len=seq_len, global_batch=batch, carousel=False)`` at
    full width (``layers`` None: full depth), counted and timed as phase
    "training" is; then one more (warm) step under the profiler, the
    kernels picked out."""
    cfg = _config(arch, layers)
    label = label or "training_" + arch.split("-")[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L = cfg.num_layers
    res, counts, stamps, t0 = _timed_run(
        failures, label, L, TRAIN_STEPS, arch=arch, seq_len=seq_len,
        global_batch=batch, carousel=False)
    peak = torch.cuda.max_memory_allocated()
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    # the tokens a step trains on, a VLM's patches included
    tokens = batch * (seq_len + (cfg.num_img_patches if cfg.family == "vlm"
                                 else 0))
    run = train.default_run_config(cfg, TRAIN_STEPS)
    inputs = registry.synth_inputs(
        torch.Generator(device=DEVICE).manual_seed(TRAIN_STEPS), cfg,
        ShapeConfig("train", seq_len, batch, "train"), "train",
        device=DEVICE)
    state = res.pop("state")
    prof = _profile(lambda: tstep.make_train_step(cfg, run)(state, inputs),
                    top=12, pick=("ssd_", "flash_", "rmsnorm_", "ce_"))
    log(label, json.dumps({
        "arch": arch, "layers": L, "steps": res["steps"], "batch": batch,
        "seq_len": seq_len, "tokens_per_step": tokens,
        "losses": res["losses"],
        "first_step_s": stamps[0] - t0 if stamps else None,
        "step_s_2_3": steps_s,
        "tokens_per_s": tokens / statistics.mean(steps_s),
        "wall_s": res["wall_s"], "peak_mem_bytes": peak,
        "launches": counts,
        "expected_launches": training_launches(L, TRAIN_STEPS, arch),
        "profiled_step": prof}))
    TIMED_RUNS.append(dict(
        label=label, arch=arch, layers=layers, kind="train", batch=batch,
        length=seq_len, step_s=statistics.mean(steps_s), peak_bytes=peak,
        launches=counts, steps=res["steps"]))
    del state, res, inputs
    torch.cuda.empty_cache()
    return counts


def _cost_part(res: dict, measured_s: float) -> dict:
    """One counted call beside its measured time: the roofline of
    ``launch/dryrun.py`` at the H100's data-sheet rates, and the bound's
    share of the measured time."""
    rf = dryrun.roofline_terms({"chips": 1, "hlo_flops": res["flops"],
                                "hlo_bytes": res["hbm_bytes"],
                                "collective_total": 0.0})
    return {"flops": res["flops"], "bytes": res["hbm_bytes"],
            "peak_bytes": res["peak_bytes"], "bound_s": rf["bound_s"],
            "dominant": rf["dominant"], "measured_s": measured_s,
            "bound_share": rf["bound_s"] / measured_s}


def phase_cost_model(failures: list) -> None:
    """Each run of TIMED_RUNS counted again by the dry run's cost model
    (``launch/dryrun.py::count_cell``, kernel mode, on the meta device) at
    its config, depth, batch and length: a serving run's prefill (its
    cache as ``run_serving`` sizes it) and one decode step, a training
    run's step.  Logs FLOPs, bytes, the bound and its dominant term, the
    bound's share of the measured time (prefill_s, a decode step, the
    mean of steps 2-3), and the counted peak beside the run's
    ``max_memory_allocated`` (which also holds the weights' initialisation
    and, serving, the whole generation).  Fails when a count is not finite
    and positive, or when the calls of a kernel over the run (one prefill
    and GEN - 1 decode steps, or every step) differ from the launch
    counters the run read on the card."""
    for r in TIMED_RUNS:
        cfg = _config(r["arch"], r["layers"])
        B, n = r["batch"], r["length"]
        if r["kind"] == "serve":
            max_len = n + (cfg.num_img_patches if cfg.family == "vlm"
                           else 0) + GEN + 8
            pre = dryrun.count_cell(cfg, ShapeConfig("serve", n, B,
                                                     "prefill"),
                                    max_len=max_len)
            dec = dryrun.count_cell(cfg, ShapeConfig("serve", max_len, B,
                                                     "decode"))
            parts = {"prefill": _cost_part(pre, r["prefill_s"]),
                     "decode_step": _cost_part(dec, r["decode_step_s"])}
            names = set(pre["calls"]) | set(dec["calls"]) | set(r["launches"])
            calls = {k: pre["calls"].get(k, 0) + (GEN - 1)
                     * dec["calls"].get(k, 0) for k in names}
            peak = max(pre["peak_bytes"], dec["peak_bytes"])
        else:
            run = train.default_run_config(cfg, TRAIN_STEPS)
            st = dryrun.count_cell(cfg, ShapeConfig("train", n, B, "train"),
                                   run)
            parts = {"step": _cost_part(st, r["step_s"])}
            names = set(st["calls"]) | set(r["launches"])
            calls = {k: r["steps"] * st["calls"].get(k, 0) for k in names}
            peak = st["peak_bytes"]
        launches = {k: r["launches"].get(k, 0) for k in names}
        row = dict(label=r["label"], arch=r["arch"],
                   layers=cfg.num_layers, batch=B, length=n, **parts,
                   calls=calls, launches=launches, peak_bytes=peak,
                   measured_peak_bytes=r["peak_bytes"],
                   peak_ratio=peak / r["peak_bytes"])
        log("cost_model", json.dumps(row))
        if calls != launches:
            failures.append(f"cost_model {r['label']}: calls {calls} != "
                            f"launches {launches}")
        for name, p in parts.items():
            if not all(math.isfinite(p[k]) and p[k] > 0
                       for k in ("flops", "bytes", "peak_bytes",
                                 "bound_s")):
                failures.append(f"cost_model {r['label']} {name}: {p}")


def _tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _zero_grad_leaf(name: str, cfg) -> bool:
    """A key bias adds the same q . b to every key a query sees, which the
    softmax drops: its gradient is zero but for rounding (whisper's
    ``bk``), so it has no relative error to speak of."""
    return cfg.family == "encdec" and name.endswith("/bk")


def phase_training_end_to_end(failures: list, arch: str = ARCH,
                              layers: int = E2E_TRAIN_LAYERS,
                              seq_len: int = TRAIN_SEQ,
                              label: str = "end_to_end_training",
                              batch: int = TRAIN_BATCH) -> dict:
    """One ``grads_and_metrics`` through the kernels against one through
    the plain versions, at full width and ``layers`` layers; the kernel
    run's launches are returned (a comparison's, not the main path's).
    An MoE arch runs at capacity factor E / K, where nothing drops; its
    row logs the top-K choices that differ between the two paths and the
    share of pairs the config's own factor would drop from the kernel
    path's choices (each over the forward's and the recompute's calls);
    the plain path then routes by the kernel path's choices, so that the
    gradients differ by what the kernels compute and not by a discrete
    choice that a rounding flips (ROADMAP C5).
    A gradient that is zero but for rounding (``_zero_grad_leaf``) is
    held by its distance against the norm of the matching value bias's
    gradient."""
    cfg = get_config(arch).replace(num_layers=layers)
    moe = cfg.family == "moe"
    if moe:
        cfg = cfg.replace(moe_capacity_factor=cfg.num_experts
                          / cfg.num_experts_per_tok)
    dev = torch.device(DEVICE)
    params = serve.init_params(cfg, 11, dev)
    inputs = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(12), cfg,
        ShapeConfig("train", seq_len, batch, "train"), "train",
        device=dev)
    run = train.default_run_config(cfg, TRAIN_STEPS)
    routes_k, routes_p = [], []
    reset_launches()
    with _recording_routes(routes_k):
        gk, mk = tstep.grads_and_metrics(params, cfg, run, inputs)
    counts = read_launches()
    with _recording_routes(routes_p, routes_k if moe else None):
        gp, mp = tstep.grads_and_metrics(
            params, cfg, run.replace(use_kernels=False), inputs)
    lk, lp = float(mk["loss"]), float(mp["loss"])
    loss_rel = abs(lk - lp) / abs(lp)
    grads_p = dict(_tree_items(gp))
    rel, zero = {}, {}
    for (name, a), (_, b) in zip(_tree_items(gk), _tree_items(gp)):
        if _zero_grad_leaf(name, cfg):
            zero[name] = float((a.float() - b.float()).norm() / grads_p[
                name[:-2] + "bv"].float().norm())
        else:
            rel[name] = _rel_l2(a, b)
    finite = all(bool(torch.isfinite(g).all()) for g in P.tree_leaves(gk))
    want = training_launches(layers, 1, arch, optimizer_steps=0)
    row = {"arch": arch, "layers": layers, "seq_len": seq_len,
           "batch": batch, "loss_kernels": lk, "loss_plain": lp,
           "loss_rel": loss_rel, "loss_tol": LOSS_TOL, "grad_rel_l2": rel,
           "worst_leaf": max(rel.items(), key=lambda kv: kv[1]),
           "ssd_fed_rel_l2": {k: r for k, r in rel.items()
                              if k.rsplit("/", 1)[-1] in SSD_FED_LEAVES},
           "grad_tol": E2E_TOL, "grads_finite": finite, "launches": counts}
    if zero:
        row["zero_grad_leaves_vs_bv_grad"] = zero
    if moe:
        own = get_config(arch)
        E, K = own.num_experts, own.num_experts_per_tok
        S = seq_len
        C = max(int(math.ceil(S * K / E * own.moe_capacity_factor)), 1)
        dropped = pairs = 0
        for ek, _ in routes_k:
            per = torch.zeros((ek.shape[0], E), dtype=torch.long,
                              device=ek.device)
            per.scatter_add_(1, ek.reshape(ek.shape[0], -1),
                             torch.ones_like(ek.reshape(ek.shape[0], -1)))
            dropped += int(torch.clamp(per - C, min=0).sum())
            pairs += ek.numel()
        row.update(
            capacity_factor=cfg.moe_capacity_factor,
            own_capacity_factor=own.moe_capacity_factor,
            own_factor_dropped_pair_share=dropped / pairs,
            plain_routed_by_kernel_choices=True,
            routing_flips_kernel_vs_plain=sum(
                int((ek != ep).any(-1).sum())
                for (ek, _), (ep, _) in zip(routes_k, routes_p)),
            routed_tokens=sum(ek.shape[0] * ek.shape[1]
                              for ek, _ in routes_k))
    log(label, json.dumps(row))
    if not loss_rel <= LOSS_TOL:
        failures.append(f"{label} loss kernels {lk} vs plain {lp}")
    bad = {k: r for k, r in list(rel.items()) + list(zero.items())
           if not r <= E2E_TOL}
    if bad or not finite:
        failures.append(f"{label} grads rel L2 > {E2E_TOL}: {bad}, "
                        f"finite={finite}")
    if counts != want:
        failures.append(f"{label} launch counts {counts} != {want}")
    del params, gk, gp
    torch.cuda.empty_cache()
    return counts


def _carousel_row(res: dict) -> dict:
    car = res["carousel"]
    return {"time_to_first_batch_s": res["time_to_first_batch_s"],
            "delivery_first_batch_s": car["time_to_first_batch_s"],
            "next_wait_s": car["next_wait_s"], "reads": car["reads"],
            "failed_reads": car["failed_reads"], "hedges": car["hedges"],
            "shards_landed": car["shards_landed"],
            "rows_delivered": car["rows_delivered"],
            "rows_received": car["rows_received"],
            "skipped_shards": car["skipped_shards"]}


def phase_training_carousel(failures: list, training_steps_s: list) -> list:
    """``run_training`` as its default runs it, on the carousel (8 shards,
    4 drives, 1 ms a tape read, fault rate 0.02), at full width and depth:
    counted and timed as phase "training" is."""
    cfg = get_config(ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts, stamps, t0 = _timed_run(
        failures, "training_carousel", cfg.num_layers, TRAIN_STEPS,
        carousel=True)
    peak = torch.cuda.max_memory_allocated()
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row = dict(_carousel_row(res), arch=ARCH, layers=cfg.num_layers,
               steps=res["steps"], losses=res["losses"],
               first_step_s=stamps[0] - t0, step_s_2_3=steps_s,
               training_step_s_2_3=training_steps_s,
               tokens_per_s=tokens / statistics.mean(steps_s),
               wall_s=res["wall_s"], peak_mem_bytes=peak, launches=counts,
               expected_launches=training_launches(cfg.num_layers,
                                                   TRAIN_STEPS))
    log("training_carousel", json.dumps(row))
    if row["rows_delivered"] < TRAIN_STEPS * TRAIN_BATCH or \
            row["rows_received"] < row["rows_delivered"]:
        failures.append(f"training_carousel rows: delivered "
                        f"{row['rows_delivered']}, received "
                        f"{row['rows_received']}")
    del res
    torch.cuda.empty_cache()
    return [counts]


def phase_carousel_fine_vs_coarse(failures: list) -> list:
    """Time to the first batch with fine delivery against coarse, the
    tape slow (one drive, 0.4 s a shard): coarse waits for all 8 shards.
    Full width, E2E_TRAIN_LAYERS layers."""
    out, all_counts = {}, []
    for coarse in (False, True):
        mode = "coarse" if coarse else "fine"
        res, counts, stamps, t0 = _timed_run(
            failures, f"carousel_{mode}", E2E_TRAIN_LAYERS,
            FINE_COARSE["steps"], carousel=True, coarse=coarse,
            tape_latency=FINE_COARSE["tape_latency"],
            drives=FINE_COARSE["drives"])
        out[mode] = dict(_carousel_row(res), losses=res["losses"],
                         step_s=[b - a for a, b in zip(stamps, stamps[1:])])
        all_counts.append(counts)
        del res
    gap = (out["coarse"]["time_to_first_batch_s"]
           - out["fine"]["time_to_first_batch_s"])
    log("carousel_fine_vs_coarse", json.dumps(dict(
        out, layers=E2E_TRAIN_LAYERS, **FINE_COARSE, gap_s=gap,
        min_gap_s=FINE_COARSE_GAP_S)))
    if not gap > FINE_COARSE_GAP_S:
        failures.append(f"coarse's first batch only {gap} s after fine's")
    torch.cuda.empty_cache()
    return all_counts


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, int):
        return a == int(b)
    return a.dtype == b.dtype and torch.equal(a, b)


def phase_checkpoint_resume(failures: list) -> list:
    """CKPT_STEPS carousel-fed steps saving every CKPT_EVERY into a
    temporary directory, then a resume for CKPT_RESUME_STEPS more; the
    newest checkpoint of the first run, loaded onto the card, against the
    state it saved; one step from each on the same batch.  Full width,
    E2E_TRAIN_LAYERS layers."""
    import tempfile

    from repro_torch.ckpt import latest_step, load_checkpoint

    cfg = get_config(ARCH).replace(num_layers=E2E_TRAIN_LAYERS)
    run = train.default_run_config(cfg, CKPT_STEPS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as out:
        r1, c1, _, _ = _timed_run(failures, "checkpoint_run", cfg.num_layers,
                                  CKPT_STEPS, out_dir=out,
                                  ckpt_every=CKPT_EVERY)
        state = r1.pop("state")
        newest = latest_step(out)
        step_dir = Path(out) / f"step_{newest:08d}"
        disk_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded, meta = load_checkpoint(out, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        equal = _tree_equal(state, loaded)
        # one step from the loaded state and one from the state in memory
        loaded["opt"]["step"] = int(loaded["opt"]["step"])
        batch = registry.synth_inputs(
            torch.Generator(device=DEVICE).manual_seed(21), cfg,
            ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), "train",
            device=DEVICE)
        step_fn = tstep.make_train_step(cfg, run)
        _, m_loaded = step_fn(loaded, batch)
        _, m_mem = step_fn(state, batch)
        loss_diff = float(m_loaded["loss"]) - float(m_mem["loss"])
        del loaded, state, batch
        torch.cuda.empty_cache()
        r2, c2, _, _ = _timed_run(failures, "checkpoint_resume",
                                  cfg.num_layers, CKPT_RESUME_STEPS,
                                  out_dir=out, ckpt_every=CKPT_EVERY,
                                  resume=True)
        del r2["state"]
        kept = sorted(p.name for p in Path(out).iterdir())
    ck = r1["checkpoint"]
    log("checkpoint_resume", json.dumps({
        "layers": cfg.num_layers, "steps": CKPT_STEPS,
        "ckpt_every": CKPT_EVERY, "newest_step": newest,
        "meta_step": meta["step"], "leaves_equal": equal,
        "loss_loaded_minus_in_memory": loss_diff,
        "bytes_on_disk": disk_bytes, "bytes_written": ck["bytes_written"],
        "saves": len(ck["copy_s"]), "host_copy_s": ck["copy_s"],
        "writer_s": ck["write_s"], "load_s": load_s,
        "resume_final_step": r2["final_step"],
        "resume_losses": r2["losses"],
        "resume_host_copy_s": r2["checkpoint"]["copy_s"],
        "resume_writer_s": r2["checkpoint"]["write_s"],
        "kept_after_resume": kept}))
    if newest != CKPT_STEPS or meta["step"] != CKPT_STEPS:
        failures.append(f"checkpoint: newest step {newest}, meta "
                        f"{meta['step']}")
    if not equal:
        failures.append("checkpoint: loaded leaves differ from the state "
                        "at the save")
    if r2["final_step"] != CKPT_STEPS + CKPT_RESUME_STEPS:
        failures.append(f"resume: final step {r2['final_step']}")
    torch.cuda.empty_cache()
    return [c1, c2]


def phase_remat_dots(failures: list) -> list:
    """``remat="dots"`` at full width and E2E_TRAIN_LAYERS layers: one
    ``grads_and_metrics`` through the kernels against the plain path and
    against "full" through the kernels, launches equal to "full"'s; then
    step time, peak memory and allocator retries of "full" and "dots" at
    REMAT_LAYERS, and one profiled step of each."""
    cfg = get_config(ARCH).replace(num_layers=E2E_TRAIN_LAYERS)
    dev = torch.device(DEVICE)
    params = serve.init_params(cfg, 13, dev)
    batch = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(14), cfg,
        ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), "train",
        device=dev)
    run = train.default_run_config(cfg, TRAIN_STEPS)
    out, counts = {}, {}
    for key, r in (("dots", run.replace(remat="dots")),
                   ("full", run.replace(remat="full")),
                   ("dots_plain", run.replace(remat="dots",
                                              use_kernels=False))):
        reset_launches()
        out[key] = tstep.grads_and_metrics(params, cfg, r, batch)
        counts[key] = read_launches()
    (gd, md), (gf, mf), (gp, mp) = out["dots"], out["full"], out["dots_plain"]
    ld, lf, lp = float(md["loss"]), float(mf["loss"]), float(mp["loss"])
    rel_plain = {n: _rel_l2(a, b) for (n, a), (_, b) in
                 zip(_tree_items(gd), _tree_items(gp))}
    rel_full = {n: _rel_l2(a, b) for (n, a), (_, b) in
                zip(_tree_items(gd), _tree_items(gf))}
    finite = all(bool(torch.isfinite(g).all()) for g in P.tree_leaves(gd))
    want = training_launches(E2E_TRAIN_LAYERS, 1, optimizer_steps=0)
    row = {"layers": E2E_TRAIN_LAYERS, "loss_dots": ld, "loss_full": lf,
           "loss_dots_plain": lp, "loss_rel_plain": abs(ld - lp) / abs(lp),
           "loss_tol": LOSS_TOL, "grad_rel_l2_plain": rel_plain,
           "grad_tol": E2E_TOL, "grad_rel_l2_full": rel_full,
           "loss_dots_minus_full": ld - lf, "grads_finite": finite,
           "launches_dots": counts["dots"], "launches_full": counts["full"],
           "expected_launches": want}
    del params, batch, out, gd, gf, gp
    torch.cuda.empty_cache()
    if not row["loss_rel_plain"] <= LOSS_TOL:
        failures.append(f"remat dots loss kernels {ld} vs plain {lp}")
    bad = {k: r for k, r in rel_plain.items() if not r <= E2E_TOL}
    if bad or not finite:
        failures.append(f"remat dots grads rel L2 > {E2E_TOL}: {bad}, "
                        f"finite={finite}")
    if not counts["dots"] == counts["full"] == want:
        failures.append(f"remat dots launches {counts['dots']}, full "
                        f"{counts['full']}, expected {want}")

    # step time and peak memory, one state for both
    cfg = get_config(ARCH).replace(num_layers=REMAT_LAYERS)
    run = train.default_run_config(cfg, REMAT_STEPS)
    state = tstep.init_state(
        torch.Generator(device=dev).manual_seed(run.seed), cfg, run)
    batch = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(15), cfg,
        ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), "train",
        device=dev)
    for remat in ("full", "dots"):
        step_fn = tstep.make_train_step(cfg, run.replace(remat=remat))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries = torch.cuda.memory_stats()["num_alloc_retries"]
        times, losses = [], []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            _, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        row[f"{remat}_step_s"] = times
        row[f"{remat}_losses"] = losses
        row[f"{remat}_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        row[f"{remat}_alloc_retries"] = torch.cuda.memory_stats()[
            "num_alloc_retries"] - retries
        # one more step under the profiler: wall against device time
        prof = _profile(lambda: step_fn(state, batch), top=4)
        row[f"{remat}_profiled"] = {k: prof[k] for k in (
            "wall_ms", "device_ms", "busy_share", "top")}
    row["timed_layers"] = REMAT_LAYERS
    log("remat_dots", json.dumps(row))
    del state, batch
    torch.cuda.empty_cache()
    return []  # its launches are comparisons, not the main path's


def _mesh_serve(params, cfg, prompt: dict, rules) -> tuple:
    """One prefill and MESH_GEN - 1 greedy decode steps, under ``rules``
    (the mesh path) or with none; (tokens, every step's logits)."""
    B, S = prompt["tokens"].shape
    run = RunConfig()
    ctx = use_rules(rules) if rules is not None else contextlib.nullcontext()
    with torch.inference_mode(), ctx, batch_split(B, ()):
        cache = engine.init_cache(cfg, B, S + MESH_GEN + 8, DEVICE)
        logits, cache = registry.prefill(params, cfg, run, prompt, cache)
        outs = [logits]
        toks = [logits[:, -1].argmax(-1, keepdim=True)]
        for i in range(MESH_GEN - 1):
            logits, cache = registry.decode(params, cfg, run, toks[-1],
                                            cache, S + i)
            outs.append(logits)
            toks.append(logits[:, -1].argmax(-1, keepdim=True))
    return torch.cat(toks, dim=1), outs


def _mesh_train(cfg, rules, steps: int) -> tuple:
    """``steps`` train steps from one seeded state on seeded batches,
    under ``rules`` or with none; (losses, state)."""
    run = train.default_run_config(cfg, TRAIN_STEPS)
    dev = torch.device(DEVICE)
    ctx = use_rules(rules) if rules is not None else contextlib.nullcontext()
    losses = []
    with ctx:
        state = tstep.init_state(torch.Generator(device=dev).manual_seed(3),
                                 cfg, run)
        fn = tstep.make_train_step(cfg, run)
        for i in range(steps):
            b = registry.synth_inputs(
                torch.Generator(device=dev).manual_seed(20 + i), cfg,
                ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                "train", device=dev)
            state, m = fn(state, b)
            losses.append(m["loss"])
    return losses, state


def _counted_calls(rules, cfg, shape, run=None, **kw) -> dict:
    with use_rules(rules):
        return dryrun.count_cell(cfg, shape, run, **kw)["calls"]


def phase_mesh(failures: list) -> list:
    """The mesh path at world size 1: a one-rank process group over NCCL
    (``launch/mesh.py::make_host_mesh``) and the sharding rules over it,
    as ``run_serving`` and ``run_training`` run.  (a) yi-6b served at full
    size (one prefill of BATCH x PROMPT, MESH_GEN - 1 decode steps) and
    trained (MESH_STEPS steps, MESH_TRAIN_LAYERS layers) under the rules
    and with none: tokens, logits, losses, params and moments bit for bit;
    the mesh runs' launches, counted, held against the formulas and
    against the cost model's calls counted under the same rules.  (b) For
    MESH_MOE, at batch > 1: under the rules the MoE block takes the
    shardmap path (one route of the B * S tokens, capacity over them): the
    prefill at the served depth and one ``grads_and_metrics`` at the
    trained depth through the kernels against the plain versions, the
    plain path routed by the kernel path's choices (ROADMAP C5), at §2's
    limits (logits and gradient leaves relative L2 5e-2, loss 1e-2).
    Returns the launches of (a)'s mesh runs."""
    dev = torch.device(DEVICE)
    rules = serve.host_rules(None, dev)
    counts_out = []
    cfg = get_config(ARCH)
    params = serve.init_params(cfg, 1, dev)
    prompt = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(7), cfg,
        ShapeConfig("serve", PROMPT, BATCH, "prefill"), "prefill",
        device=dev)
    reset_launches()
    tok_m, out_m = _mesh_serve(params, cfg, prompt, rules)
    counts = read_launches()
    tok_n, out_n = _mesh_serve(params, cfg, prompt, None)
    want = serving_launches(cfg, MESH_GEN)
    got = {k: counts[k] for k in want}
    max_len = PROMPT + MESH_GEN + 8
    pre = _counted_calls(rules, cfg, ShapeConfig("serve", PROMPT, BATCH,
                                                 "prefill"), max_len=max_len)
    dec = _counted_calls(rules, cfg, ShapeConfig("serve", max_len, BATCH,
                                                 "decode"))
    calls = {k: pre.get(k, 0) + (MESH_GEN - 1) * dec.get(k, 0)
             for k in want}
    same = torch.equal(tok_m, tok_n) and all(
        torch.equal(a, b) for a, b in zip(out_m, out_n))
    row = {"arch": ARCH, "layers": cfg.num_layers, "batch": BATCH,
           "prompt": PROMPT, "gen": MESH_GEN, "mesh": dict(
               rules.mesh.shape), "backend": str(dist.get_backend()),
           "tokens_and_logits_bit_equal": same, "launches": got,
           "expected_launches": want, "cost_model_calls": calls}
    log("mesh_serving", json.dumps(row))
    if not same:
        failures.append("mesh serving differs from the path without rules")
    if got != want or calls != want:
        failures.append(f"mesh serving launches {got}, cost model {calls},"
                        f" expected {want}")
    counts_out.append(got)
    del params, out_m, out_n
    torch.cuda.empty_cache()

    tcfg = cfg.replace(num_layers=MESH_TRAIN_LAYERS)
    reset_launches()
    loss_m, st_m = _mesh_train(tcfg, rules, MESH_STEPS)
    counts = read_launches()
    loss_n, st_n = _mesh_train(tcfg, None, MESH_STEPS)
    want = training_launches(MESH_TRAIN_LAYERS, MESH_STEPS, ARCH)
    run = train.default_run_config(tcfg, TRAIN_STEPS)
    st = _counted_calls(rules, tcfg, ShapeConfig(
        "train", TRAIN_SEQ, TRAIN_BATCH, "train"), run)
    calls = {k: MESH_STEPS * st.get(k, 0) for k in want}
    same = all(torch.equal(a, b) for a, b in zip(loss_m, loss_n)) and all(
        torch.equal(a, b) for a, b in zip(P.tree_leaves(
            {"p": st_m["params"], "m": st_m["opt"]["m"]}), P.tree_leaves(
            {"p": st_n["params"], "m": st_n["opt"]["m"]})))
    row = {"arch": ARCH, "layers": MESH_TRAIN_LAYERS, "steps": MESH_STEPS,
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "losses": [float(x) for x in loss_m],
           "losses_params_moments_bit_equal": same, "launches": counts,
           "expected_launches": want, "cost_model_calls": calls}
    log("mesh_training", json.dumps(row))
    if not same:
        failures.append("mesh training differs from the path without rules")
    if counts != want or calls != want:
        failures.append(f"mesh training launches {counts}, cost model "
                        f"{calls}, expected {want}")
    counts_out.append(counts)
    del st_m, st_n
    torch.cuda.empty_cache()

    for arch, tag, n_serve, n_train, batch, seq in MESH_MOE:
        _mesh_moe(failures, rules, arch, tag, n_serve, n_train, batch, seq)
    return counts_out


def _mesh_moe(failures, rules, arch, tag, n_serve, n_train, batch, seq):
    dev = torch.device(DEVICE)
    cfg = _config(arch, n_serve)
    params = serve.init_params(cfg, 1, dev)
    g = torch.Generator(device=dev).manual_seed(9)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=g, device=dev)}
    kern, plain = RunConfig(), RunConfig(use_kernels=False)
    routes_k, routes_p = [], []
    with torch.inference_mode(), use_rules(rules), batch_split(batch, ()):
        mk = lambda: engine.init_cache(cfg, batch, seq + 8, dev)
        with _recording_routes(routes_k):
            lk, _ = registry.prefill(params, cfg, kern, prompt, mk())
        with _recording_routes(routes_p, routes_k):
            lp, _ = registry.prefill(params, cfg, plain, prompt, mk())
    one_row = all(ek.shape[:2] == (1, batch * seq) for ek, _ in routes_k)
    kept = sum(int(k.sum()) for _, k in routes_k)
    pairs = sum(k.numel() for _, k in routes_k)
    a = _rel_l2(lk[:, -1], lp[:, -1])
    finite = bool(torch.isfinite(lk).all())
    del params, lk, lp
    torch.cuda.empty_cache()

    tcfg = _config(arch, n_train)
    tparams = serve.init_params(tcfg, 11, dev)
    inputs = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(12), tcfg,
        ShapeConfig("train", seq, batch, "train"), "train", device=dev)
    run = train.default_run_config(tcfg, TRAIN_STEPS)
    tk, tp = [], []
    with use_rules(rules):
        with _recording_routes(tk):
            gk, mk_ = tstep.grads_and_metrics(tparams, tcfg, run, inputs)
        with _recording_routes(tp, tk):
            gp, mp_ = tstep.grads_and_metrics(
                tparams, tcfg, run.replace(use_kernels=False), inputs)
    lk_, lp_ = float(mk_["loss"]), float(mp_["loss"])
    loss_rel = abs(lk_ - lp_) / abs(lp_)
    rel = {name: _rel_l2(x, y) for (name, x), (_, y) in
           zip(_tree_items(gk), _tree_items(gp))}
    gfinite = all(bool(torch.isfinite(t).all()) for t in P.tree_leaves(gk))
    row = {"arch": arch, "batch": batch, "seq_len": seq,
           "served_layers": n_serve, "trained_layers": n_train,
           "capacity_factor": cfg.moe_capacity_factor,
           "routed_as_one_row_of_B_times_S": one_row,
           "capacity": math.ceil(batch * seq * cfg.num_experts_per_tok
                                 / cfg.num_experts
                                 * cfg.moe_capacity_factor),
           "prefill_dropped_pair_share": 1 - kept / pairs,
           "kernel_vs_plain_prefill_rel_l2": a, "logits_finite": finite,
           "loss_kernels": lk_, "loss_plain": lp_, "loss_rel": loss_rel,
           "worst_leaf": max(rel.items(), key=lambda kv: kv[1]),
           "grads_finite": gfinite, "grad_tol": E2E_TOL,
           "loss_tol": LOSS_TOL, "plain_routed_by_kernel_choices": True}
    log(f"mesh_{tag}", json.dumps(row))
    bad = {k: r for k, r in rel.items() if not r <= E2E_TOL}
    if not (one_row and finite and gfinite and a <= E2E_TOL
            and loss_rel <= LOSS_TOL and not bad):
        failures.append(f"mesh_{tag}: one row {one_row}, prefill rel L2 "
                        f"{a}, loss rel {loss_rel}, leaves {bad}, finite "
                        f"{finite} / {gfinite}")
    del tparams, gk, gp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# tensor_parallel: the dense compute split over "model" on the one card
# ---------------------------------------------------------------------------


class _LocalSizes:
    """Records, in a rank of phase tensor_parallel, the local sizes its
    split calls see: flash attention's (query rows, query heads, kv heads),
    the MLP's ``ffn`` columns, the CE's vocab rows, the SSD scan's and
    decode step's (heads, head dim), the split gated norm's (columns,
    whole row) and, at decode (S = 1), the MoE expert grid's (experts,
    ffn columns)."""

    def __init__(self):
        self.flash, self.mlp, self.ce = set(), set(), set()
        self.ssd, self.norm, self.experts = set(), set(), set()

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved = (ops.flash_attention, layers.mlp,
                      kce.cross_entropy_stats_cuda, ops.ssd, ops.ssd_decode,
                      ops.rmsnorm_split, layers._experts_combine)
        flash, mlp, ce, ssd, ssd_decode, norm, experts = self.saved

        def rec_flash(q, k, v, **kw):
            self.flash.add((q.shape[1], q.shape[2], k.shape[2]))
            return flash(q, k, v, **kw)

        def rec_mlp(p, cfg, run, x):
            self.mlp.add(p["w_up"].shape[-1])
            return mlp(p, cfg, run, x)

        def rec_ce(hidden, w, targets):
            self.ce.add(w.shape[0])
            return ce(hidden, w, targets)

        def rec_ssd(x, *a, **kw):
            self.ssd.add(tuple(x.shape[2:]))
            return ssd(x, *a, **kw)

        def rec_ssd_decode(x, *a):
            self.ssd.add(tuple(x.shape[1:]))
            return ssd_decode(x, *a)

        def rec_norm(x, w, **kw):
            self.norm.add((x.shape[-1], kw["d_whole"]))
            return norm(x, w, **kw)

        def rec_experts(p, cfg, x, *a):
            if x.shape[1] == 1:
                self.experts.add((a[-2], p["w_gate"].shape[-1]))
            return experts(p, cfg, x, *a)
        ops.flash_attention, layers.mlp = rec_flash, rec_mlp
        kce.cross_entropy_stats_cuda = rec_ce
        ops.ssd, ops.ssd_decode = rec_ssd, rec_ssd_decode
        ops.rmsnorm_split, layers._experts_combine = rec_norm, rec_experts
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        (ops.flash_attention, layers.mlp, kce.cross_entropy_stats_cuda,
         ops.ssd, ops.ssd_decode, ops.rmsnorm_split,
         layers._experts_combine) = self.saved

    def as_dict(self) -> dict:
        return {k: sorted(getattr(self, k)) for k in (
            "flash", "mlp", "ce", "ssd", "norm", "experts")}


def _tp_want_sizes(cfg) -> dict:
    """The local sizes a rank of phase tensor_parallel must see (as
    ``_LocalSizes.as_dict``) for ``cfg`` split over TP_RANKS ranks."""
    n, ssm = TP_RANKS, cfg.family in ("ssm", "hybrid")
    attn = cfg.family != "ssm"
    return {"flash": sorted({(S_, cfg.num_heads // n, cfg.num_kv_heads // n)
                             for S_ in (PROMPT, TRAIN_SEQ)}) if attn else [],
            "mlp": [cfg.d_ff // n] if attn else [],
            "ce": [cfg.vocab_size // n],
            "ssd": [(cfg.ssm_heads // n, cfg.ssm_head_dim)] if ssm else [],
            "norm": [(cfg.ssm_inner // n, cfg.ssm_inner)] if ssm else [],
            "experts": []}


def _tp_inputs(cfg, dev, steps: int):
    """Phase tensor_parallel's prompt (TP_BATCH x PROMPT) and ``steps``
    training batches (TP_BATCH x TRAIN_SEQ), from seeds, the same in
    every process."""
    prompt = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(41), cfg,
        ShapeConfig("serve", PROMPT, TP_BATCH, "prefill"), "prefill",
        device=dev)
    batches = [registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(50 + i), cfg,
        ShapeConfig("train", TRAIN_SEQ, TP_BATCH, "train"), "train",
        device=dev) for i in range(steps)]
    return prompt, batches


def _tp_serve(cfg, dev, params, prompt, tokens=None, gen: int = TP_DECODE):
    """A prefill and ``gen`` decode steps (greedy, or fed ``tokens``) under
    the current rules; returns (f32 logits, tokens)."""
    run = RunConfig()
    B, S = prompt["tokens"].shape
    with torch.inference_mode(), batch_split(B, ()):
        cache = engine.init_cache(cfg, B, S + gen + 8, dev)
        logits, cache = registry.prefill(params, cfg, run, prompt, cache)
        outs = [logits.float()]
        toks = [logits[:, -1].argmax(-1, keepdim=True)]
        for i in range(gen):
            feed = toks[-1] if tokens is None else tokens[:, i:i + 1]
            logits, cache = registry.decode(params, cfg, run, feed, cache,
                                            S + i)
            outs.append(logits.float())
            toks.append(logits[:, -1].argmax(-1, keepdim=True))
    return torch.cat(outs, 1), torch.cat(toks, 1)


def _tp_path(cfg, dev, steps: int, dtype: torch.dtype, tokens=None
             ) -> dict:
    """The path phase tensor_parallel runs under the current rules, with
    weights in ``dtype`` (f32: the CE's products too): a prefill,
    TP_DECODE decode steps (greedy, or fed ``tokens``), the gradients of
    the first batch, then ``steps`` train steps from a fresh state.
    Launch counters are reset before and read after each half."""
    # the drawn weights are bf16 but for the f32 SSM vectors
    as_dtype = (lambda t: t) if dtype == torch.bfloat16 else \
        (lambda t: P.cast_tree(t, dtype))
    prompt, batches = _tp_inputs(cfg, dev, steps)
    params = as_dtype(serve.init_params(cfg, 5, dev))
    reset_launches()
    reset_collective_tally()
    logits, toks = _tp_serve(cfg, dev, params, prompt, tokens)
    _sync(dev)
    res = {"serve_launches": read_launches(), "logits": logits,
           "tokens": toks, "serve_collectives": collective_tally()}
    del params
    trun = _tp_train_run(cfg, dtype)
    reset_launches()
    reset_collective_tally()
    state = tstep.init_state(torch.Generator(device=dev).manual_seed(6),
                             cfg, trun)
    state["params"] = as_dtype(state["params"])
    grads, m0 = tstep.grads_and_metrics(state["params"], cfg, trun,
                                        batches[0])
    fn = tstep.make_train_step(cfg, trun)
    losses = [float(m0["loss"])]
    for b in batches:
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
    _sync(dev)
    res.update(train_launches=read_launches(), grads=grads, losses=losses,
               train_collectives=collective_tally())
    return res


def _tp_train_run(cfg, dtype: torch.dtype) -> RunConfig:
    trun = train.default_run_config(cfg, TRAIN_STEPS)
    return trun.replace(ce_dtype="float32") if dtype == torch.float32 \
        else trun


def _tp_counted(cfg, steps: int, dtype: torch.dtype, coord: int) -> dict:
    """``_tp_path`` of the rank at ``coord`` of (1, TP_RANKS), counted by
    the dry run's cost model on the meta device (``launch/cost.py``,
    kernel mode) under rules over an abstract mesh standing for that rank:
    the same config, weights' dtype, rows, lengths and steps, each half
    (the prefill and TP_DECODE decode steps; the first batch's gradients
    and the train steps) one count, its collectives charged by kind and
    not run.  Returns {"serve": count, "train": count}."""
    from repro_torch.launch import cost
    from repro_torch.optim import adamw_init
    as_dtype = (lambda t: t) if dtype == torch.bfloat16 else \
        (lambda t: P.cast_tree(t, dtype))
    run, trun = RunConfig(), _tp_train_run(cfg, dtype)
    defs = registry.param_defs(cfg)
    rules = _rank_rules(coord, TP_RANKS)

    def serve_half(params, prompt):
        B, S = prompt["tokens"].shape
        with torch.inference_mode(), batch_split(B, ()):
            cache = engine.abstract_cache(cfg, B, S + TP_DECODE + 8)
            logits, cache = registry.prefill(params, cfg, run, prompt, cache)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            for i in range(TP_DECODE):
                logits, cache = registry.decode(params, cfg, run, tok, cache,
                                                S + i)
                tok = logits[:, -1].argmax(-1, keepdim=True)

    def train_half(state, batches):
        grads, _ = tstep.grads_and_metrics(state["params"], cfg, trun,
                                           batches[0])
        fn = tstep.make_train_step(cfg, trun)
        for b in batches:
            fn(state, b)
        del grads

    with use_rules(rules):
        prompt = registry.input_specs(cfg, ShapeConfig(
            "serve", PROMPT, TP_BATCH, "prefill"))
        out = {"serve": cost.analyze(serve_half, as_dtype(P.abstract(defs)),
                                     prompt)}
        params = P.abstract(defs)
        state = {"params": as_dtype(params),
                 "opt": adamw_init(params, dtype=getattr(
                     torch, trun.opt_state_dtype))}
        batches = [registry.input_specs(cfg, ShapeConfig(
            "train", TRAIN_SEQ, TP_BATCH, "train")) for _ in range(steps)]
        out["train"] = cost.analyze(train_half, state, batches)
    return out


def _tp_moe(dev, tokens=None):
    """MoE decode split over the ranks: TP_MOE_ARCH's smoke config with f32
    weights, a prompt of TP_BATCH x TP_MOE_PROMPT and TP_DECODE decode
    steps under the current rules (decode, S = 1, takes the gspmd path);
    returns (logits, tokens)."""
    cfg = get_smoke_config(TP_MOE_ARCH)
    params = P.cast_tree(serve.init_params(cfg, 5, dev), torch.float32)
    prompt = registry.synth_inputs(
        torch.Generator(device=dev).manual_seed(43), cfg,
        ShapeConfig("serve", TP_MOE_PROMPT, TP_BATCH, "prefill"), "prefill",
        device=dev)
    return _tp_serve(cfg, dev, params, prompt, tokens)


def _tp_rank(rank: int, port: int, out: str) -> None:
    """One of TP_RANKS ranks of phase tensor_parallel: all on cuda:0 over
    gloo (NCCL refuses two ranks on one device), rules at (1, TP_RANKS).
    Writes its results, with its gradient blocks, under ``out``."""
    import os
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(TP_RANKS),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(TP_RANKS))
    mesh.init_distributed("gloo")
    dev = mesh.local_device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    tokens = torch.load(Path(out) / "tokens.pt")
    rules = serve.host_rules(TP_RANKS, dev)
    results = {}
    for arch, n_layers, steps, dtype in TP_MODELS:
        cfg = _config(arch, n_layers)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        kce.merge_launches = 0
        with use_rules(rules), _LocalSizes() as sizes:
            res = _tp_path(cfg, dev, steps, dtype, tokens[arch].to(dev))
        res["seconds"] = time.perf_counter() - t0
        res["merge_launches"] = kce.merge_launches
        res["sizes"] = sizes.as_dict()
        res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None)
        t0 = time.perf_counter()
        res["counted"] = _tp_counted(cfg, steps, dtype, rules.mesh.coord(
            "model"))
        res["count_seconds"] = time.perf_counter() - t0
        res["grads"] = {k: v.cpu() for k, v in _tree_items(res["grads"])}
        res["logits"] = res["logits"].cpu() if rank == 0 else None
        res["tokens"] = None
        results[arch] = res
    with use_rules(rules), _LocalSizes() as sizes:
        logits, _ = _tp_moe(dev, tokens[TP_MOE_ARCH].to(dev))
    results[TP_MOE_ARCH] = {"logits": logits.cpu(), "sizes": sizes.as_dict()}
    results["backend"] = str(dist.get_backend())
    results["device"] = str(dev)
    torch.save(results, Path(out) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_tensor_parallel(failures: list) -> list:
    """(a) TP_MODELS at full width, each split over "model" by TP_RANKS ranks
    on the one card (spawned processes over gloo, rules at (1, TP_RANKS)):
    yi-6b at TP_LAYERS layers (heads, ``ffn`` columns, vocab rows), zamba2-1.2b
    at 6 layers (its mamba blocks by SSM heads, 16 of 64 a rank, its shared
    block by heads) and mamba2-130m at full depth (6 of 24 SSM heads a rank; in
    f32, see TP_MODELS): one prefill of TP_BATCH x PROMPT, TP_DECODE decode
    steps fed the world-size-1 run's tokens over a cache of the rank's block
    (the KV cache's positions, the mamba states' heads), the first batch's
    gradients and the model's train steps, against the world-size-1 path run
    here under one-rank rules: logits relative L2 <= 5e-2, losses within 1e-2,
    each gathered gradient leaf within relative L2 5e-2; each rank's launches
    equal the formulas (the gated norm on the split-row kernels), and its calls
    see its heads, ``ffn`` columns and vocab rows, its SSD heads and its gated
    norm's columns (1024 of 4096 / 384 of 1536); each rank's collectives
    tallied by kind over each half equal the dry run's count of its path on
    meta at its coordinate (``_tp_counted``), and its counted calls its
    launches. Then MoE decode split (mixtral
    smoke, f32: each rank runs its one of 4 experts) against one rank, relative
    L2 TP_MOE_TOL. (b) The CE kernel on TP_RANKS vocab shards of yi-6b's and
    qwen3-moe's heads (T 2048, D 4096, V 64000 / 151936), bf16 and f32, the
    shards' triples merged by ``ce_merge_kernel``, against the whole-vocab
    kernel and the plain version; the bf16 shard call timed beside its bound,
    its plain version and ``matmul`` + ``logsumexp`` on the same shard, the
    merge beside its bound and ``ce_merge_ref``. Returns rank 0's launches of
    (a), with its merges as "ce_merge", and (b)'s merge row."""
    counts = _tp_split_path(failures)
    return counts, _tp_ce_shards(failures)


def _tp_split_path(failures: list) -> list:
    """Phase tensor_parallel (a): see ``phase_tensor_parallel``."""
    import tempfile
    import torch.multiprocessing as mp
    dev = torch.device(DEVICE)
    ones, tokens = {}, {}
    t0 = time.perf_counter()
    with use_rules(serve.host_rules(None, dev)):
        for arch, n_layers, steps, dtype in TP_MODELS:
            one = _tp_path(_config(arch, n_layers), dev, steps, dtype)
            one["grads"] = dict(_tree_items(one["grads"]))
            tokens[arch] = one.pop("tokens").cpu()
            ones[arch] = one
        moe_logits, tokens[TP_MOE_ARCH] = _tp_moe(dev)
    t_one = time.perf_counter() - t0
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as out:
        torch.save({k: v.cpu() for k, v in tokens.items()},
                   Path(out) / "tokens.pt")
        t0 = time.perf_counter()
        ctx = mp.start_processes(_tp_rank, args=(_free_port(), out),
                                 nprocs=TP_RANKS, start_method="spawn",
                                 join=False)
        while not ctx.join():
            pass
        t_ranks = time.perf_counter() - t0
        ranks = [torch.load(Path(out) / f"rank{r}.pt", weights_only=False)
                 for r in range(TP_RANKS)]
    counts = []
    for arch, n_layers, steps, dtype in TP_MODELS:
        cfg = _config(arch, n_layers)
        counts += _tp_check(failures, cfg, arch, steps, dtype,
                            ones.pop(arch), [r[arch] for r in ranks],
                            ranks[0])
    moe = [r[TP_MOE_ARCH] for r in ranks]
    moe_rel = [_rel_l2(moe[0]["logits"][:, i].to(dev), moe_logits[:, i])
               for i in range(1 + TP_DECODE)]
    scfg = get_smoke_config(TP_MOE_ARCH)  # 4 experts: one a rank
    moe_want = [(scfg.num_experts // TP_RANKS, scfg.d_ff)]
    moe_ok = max(moe_rel) <= TP_MOE_TOL and all(
        r["sizes"]["experts"] == moe_want for r in moe)
    log("tensor_parallel_moe_decode", json.dumps({
        "arch": TP_MOE_ARCH + " (smoke, f32)", "ranks": TP_RANKS,
        "prompt": TP_MOE_PROMPT, "decode_steps": TP_DECODE,
        "logits_rel_l2": moe_rel, "tol": TP_MOE_TOL,
        "decode_experts": moe[0]["sizes"]["experts"],
        "expected_experts": moe_want, "one_rank_s": t_one,
        "ranks_wall_s": t_ranks}))
    if not moe_ok:
        failures.append(f"tensor_parallel MoE decode: logits {moe_rel}, "
                        f"experts {[r['sizes']['experts'] for r in moe]}")
    del ranks
    torch.cuda.empty_cache()
    return counts


def _tp_check(failures: list, cfg, arch: str, steps: int,
              dtype: torch.dtype, one: dict, ranks: list,
              r0_all: dict) -> list:
    """Phase tensor_parallel (a) for one model: the ranks' results against
    the one-rank run's; returns rank 0's launch counts."""
    dev = torch.device(DEVICE)
    defs = dict(_tree_items(registry.param_defs(cfg)))
    rel = {}
    for name, ref_g in one["grads"].items():
        d = defs[name]
        num = den = 0.0
        split = _rank_rules(0, TP_RANKS).local_shape(
            d.logical, d.shape) != tuple(d.shape)
        for r, res in enumerate(ranks if split else ranks[:1]):
            want = _rank_rules(r, TP_RANKS).local_shard(
                ref_g, d.logical, d.shape).float()
            got = res["grads"][name].to(dev).float()
            num += float((got - want).pow(2).sum())
            den += float(want.pow(2).sum())
        rel[name] = math.sqrt(num / max(den, 1e-30))
    r0 = ranks[0]
    logit_rel = [_rel_l2(r0["logits"][:, i].to(dev), one["logits"][:, i])
                 for i in range(1 + TP_DECODE)]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                    one["losses"])]
    want_serve = split_launches(serving_launches(cfg, 1 + TP_DECODE), cfg,
                                1 + TP_DECODE)
    want_train = split_launches(
        training_launches(cfg.num_layers, 1 + steps, arch, cfg, steps),
        cfg,
        2 * (1 + steps), 1 + steps)
    want_sizes = _tp_want_sizes(cfg)
    launches_ok = all(
        {k: res["serve_launches"][k] for k in want_serve} == want_serve
        and res["train_launches"] == want_train
        and res["merge_launches"] == 1 + steps for res in ranks)
    sizes_ok = all(res["sizes"] == want_sizes for res in ranks)
    # each rank's collectives and launches against the meta count at its
    # coordinate, half by half
    moved, counted, calls_ok = [], [], True
    for res in ranks:
        for half in ("serve", "train"):
            c = res["counted"][half]
            moved.append(res[f"{half}_collectives"])
            counted.append({k[len("coll_"):]: v for k, v in c.items()
                            if k.startswith("coll_")})
            got = res[f"{half}_launches"]
            calls_ok &= all(c["calls"].get(k, 0) == got.get(k, 0)
                            for k in set(c["calls"]) | set(got))
    coll_ok = moved == counted and all(sum(m.values()) > 0 for m in moved)
    counted_peak = [max(r["counted"][h]["peak_bytes"]
                        for h in ("serve", "train")) for r in ranks]
    finite = bool(torch.isfinite(r0["logits"]).all()) and all(
        math.isfinite(x) for x in r0["losses"])
    worst = max(rel.items(), key=lambda kv: kv[1])
    row = {"arch": arch, "layers": cfg.num_layers, "ranks": TP_RANKS,
           "dtype": str(dtype)[6:], "mesh": {"data": 1, "model": TP_RANKS},
           "backend": r0_all["backend"], "device": r0_all["device"],
           "batch": TP_BATCH, "prompt": PROMPT, "decode_steps": TP_DECODE,
           "train_steps": steps, "seq_len": TRAIN_SEQ,
           "logits_rel_l2": logit_rel, "losses_split": r0["losses"],
           "losses_one_rank": one["losses"], "loss_rel": loss_rel,
           "worst_leaf": worst, "grad_tol": E2E_TOL, "loss_tol": LOSS_TOL,
           "serve_launches": r0["serve_launches"],
           "train_launches": r0["train_launches"],
           "expected_serve": want_serve, "expected_train": want_train,
           "merge_launches": r0["merge_launches"], "local_sizes":
           r0["sizes"], "expected_sizes": want_sizes,
           "rank_seconds": [r["seconds"] for r in ranks],
           "rank_peak_bytes": [r["peak_bytes"] for r in ranks],
           "rank_collective_bytes": [
               {"serve": r["serve_collectives"],
                "train": r["train_collectives"]} for r in ranks],
           "counted_collective_bytes": [
               {"serve": counted[2 * i], "train": counted[2 * i + 1]}
               for i in range(len(ranks))],
           "collectives_equal_count": coll_ok,
           "counted_calls_equal_launches": calls_ok,
           "rank_counted_peak_bytes": counted_peak,
           "rank_peak_ratio": [c / r["peak_bytes"] for c, r in
                               zip(counted_peak, ranks)],
           "rank_count_seconds": [r["count_seconds"] for r in ranks]}
    log("tensor_parallel", json.dumps(row))
    bad = {k: v for k, v in rel.items() if not v <= E2E_TOL}
    if not (finite and launches_ok and sizes_ok and not bad
            and max(logit_rel) <= E2E_TOL and max(loss_rel) <= LOSS_TOL
            and coll_ok and calls_ok):
        failures.append(f"tensor_parallel {arch}: logits {logit_rel}, "
                        f"losses {loss_rel}, leaves {bad}, launches "
                        f"{launches_ok}, sizes {sizes_ok}, finite {finite}, "
                        f"collectives vs count {coll_ok} ({moved} vs "
                        f"{counted}), counted calls {calls_ok}")
    return [r0["serve_launches"], r0["train_launches"],
            {"ce_merge": r0["merge_launches"]}]


def _rank_rules(r: int, n: int) -> ShardingRules:
    """The (1, n) rules of phase tensor_parallel as rank r sees them, over
    an abstract mesh standing for rank r: they cut a whole tensor into its
    block, and count its path on meta."""
    return ShardingRules(mesh.Mesh((1, n), ("data", "model"),
                                   coords=(0, r)))


def _tp_ce_shards(failures: list) -> dict:
    """Phase tensor_parallel (b): see ``phase_tensor_parallel``.  Returns
    the merge's row at yi-6b's head (bf16 shards), its error the largest
    of the merged results'."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = TP_RANKS
    merge, worst = None, 0.0
    for V in TP_CE_VOCABS:
        T, D = TRAIN_BATCH * TRAIN_SEQ, 4096
        for dtype in (torch.bfloat16, torch.float32):
            h = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((V, D), generator=gen, device="cuda")
                 * D ** -0.5).to(dtype)
            t = torch.randint(0, V, (T,), generator=gen, device="cuda")
            vs = V // n
            shards = [w[i * vs:(i + 1) * vs] for i in range(n)]
            parts = torch.stack([kce.cross_entropy_stats_cuda(
                h, shards[i], t - i * vs) for i in range(n)])
            got = kce.ce_merge_cuda(parts)
            whole = kce.cross_entropy_cuda(h, w, t)
            plain = ref.cross_entropy_stats_ref(h, w, t, block_v=8192)
            torch.cuda.synchronize()
            err_whole = max(_close(a, b, TOL[dtype])[1]
                            for a, b in zip(got, whole))
            ok, err = True, 0.0
            for a, b in zip(got, plain):
                ok_i, err_i = _close(a, b, TOL[dtype])
                ok, err = ok and ok_i, max(err, err_i)
            ok = ok and all(_close(a, b, TOL[dtype])[0]
                            for a, b in zip(got, whole))
            worst = max(worst, err)
            row = {"shape": [T, D, V], "shards": n, "shard_rows": vs,
                   "dtype": str(dtype)[6:], "max_abs_err_plain": err,
                   "max_abs_err_whole_kernel": err_whole, "ok": ok}
            if dtype == torch.bfloat16:
                s0, t0 = shards[0], t
                _time_row(row, {
                    "shard_ms": lambda: kce.cross_entropy_stats_cuda(
                        h, s0, t0),
                    "merge_ms": lambda: kce.ce_merge_cuda(parts),
                    "merge_plain_ms": lambda: ref.ce_merge_ref(parts),
                    "plain_ms": lambda: ref.cross_entropy_partial_ref(
                        h, s0, t0, block_v=8192),
                    "library_ms": lambda: torch.logsumexp(
                        torch.matmul(h, s0.t()).float(), dim=-1)},
                    [()], calls=3)
                flops, n_bytes = kce.work(h, s0, stats=True)
                row["bound_ms"], row["bound_by"] = _bound(n_bytes, flops,
                                                          dtype)
                flops, n_bytes = kce.merge_work(parts)
                row["merge_bound_ms"], row["merge_bound_by"] = _bound(
                    n_bytes, flops, torch.float32)
                if V == TP_CE_VOCABS[0]:
                    merge = {"ms": row["merge_ms"],
                             "plain_ms": row["merge_plain_ms"],
                             "bound_ms": row["merge_bound_ms"],
                             "bound_by": row["merge_bound_by"],
                             "library_ms": None}
            log("tensor_parallel_ce", json.dumps(row))
            if not ok:
                failures.append(f"tensor_parallel_ce V {V} {dtype}: max err "
                                f"{err} (plain), {err_whole} (whole kernel)")
            del h, w, shards, parts
    torch.cuda.empty_cache()
    return dict(merge, max_abs_err=worst)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()
    nvcc = subprocess.run([str(Path(CUDA_HOME) / "bin" / "nvcc"),
                           "--version"], capture_output=True, text=True,
                          check=True, timeout=60)
    log("device:", smi, "| torch", torch.__version__, "| cuda",
        torch.version.cuda, "|", nvcc.stdout.strip().splitlines()[-1])

    # the build's log, printed by ninja, holds ptxas' register counts
    t0 = time.perf_counter()
    ext = build.extension(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s")
    # registers, spills, shared memory and resident blocks a SM of the
    # redesigned kernels, as the CUDA runtime reports them
    kernel_info = [dict(zip(("name", "registers", "local_bytes",
                             "static_smem", "dynamic_smem", "threads",
                             "blocks_per_sm"), [name] + list(vals)))
                   for name, vals in ext.kernel_info()]

    failures: list = []
    spilling = [k["name"] for k in kernel_info if k["local_bytes"]]
    if spilling:
        failures.append(f"kernels use local memory: {spilling}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    mains = {}
    for name, phase in (("rmsnorm", phase_rmsnorm), ("flash", phase_flash),
                        ("rmsnorm_bwd", phase_rmsnorm_bwd),
                        ("rmsnorm_split", phase_rmsnorm_split),
                        ("flash_bwd", phase_flash_bwd),
                        ("cross_entropy", phase_cross_entropy),
                        ("ssd", phase_ssd), ("ssd_bwd", phase_ssd_bwd),
                        ("adamw", phase_adamw),
                        ("moe_experts", phase_moe_experts)):
        t1 = time.perf_counter()
        mains[name] = phase(gen, failures)
        log(f"{name} phase: {time.perf_counter() - t1:.2f} s")
    log(f"kernel phases: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    counts = [phase_serving(failures)]
    log(f"serving phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    params, prompt = phase_end_to_end(failures)
    log(f"end-to-end phase: {time.perf_counter() - t0:.2f} s")
    phase_breakdown(params, prompt)
    del params, prompt
    for arch in SSM_ARCHS:
        tag = arch.split("-")[0]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts.append(phase_serving(failures, arch, SSM_PROMPT,
                                    f"serving_{tag}"))
        params, prompt = phase_end_to_end(failures, arch, SSM_PROMPT,
                                          f"end_to_end_{tag}")
        phase_breakdown(params, prompt, arch, f"breakdown_{tag}")
        del params, prompt
        log(f"{arch} phases: {time.perf_counter() - t0:.2f} s")
    for arch, n_layers, batch, prompt_len in SERVE_ARCHS:
        tag = "_".join(arch.split("-")[:2]).replace(".", "_")
        kw = dict(layers=n_layers, batch=batch)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts.append(phase_serving(failures, arch, prompt_len,
                                    f"serving_{tag}", **kw))
        params, prompt = phase_end_to_end(failures, arch, prompt_len,
                                          f"end_to_end_{tag}", **kw)
        phase_breakdown(params, prompt, arch, f"breakdown_{tag}",
                        layers=n_layers, ops=True)
        phase_serving_parts(params, _config(arch, n_layers), batch,
                            prompt_len, f"parts_{tag}")
        del params, prompt
        log(f"{arch} phases: {time.perf_counter() - t0:.2f} s")
    for arch, tag, prompt_len in ((WHISPER, "whisper", WHISPER_PROMPT),
                                  (LLAVA, "llava", LLAVA_PROMPT)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts.append(phase_serving(failures, arch, prompt_len,
                                    f"serving_{tag}"))
        params, prompt = phase_end_to_end(failures, arch, prompt_len,
                                          f"end_to_end_{tag}")
        phase_breakdown(params, prompt, arch, f"breakdown_{tag}", ops=True)
        del params, prompt
        log(f"{arch} phases: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts.append(phase_serving_granite(failures))
    log(f"{GRANITE} serving phase: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_counts, train_steps_s = phase_training(failures)
    log(f"training phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_training_end_to_end(failures)
    log(f"end-to-end training phase: {time.perf_counter() - t0:.2f} s")
    for arch in ("mamba2-130m", "zamba2-1.2b"):
        tag = arch.split("-")[0]
        t0 = time.perf_counter()
        counts.append(phase_training_arch(failures, arch))
        phase_training_end_to_end(failures, arch, SSM_E2E_LAYERS[arch],
                                  SSM_TRAIN_SEQ,
                                  f"end_to_end_training_{tag}")
        log(f"{arch} training phases: {time.perf_counter() - t0:.2f} s")
    # whisper at full size (e2e too); llava at LLAVA_TRAIN_LAYERS (e2e at
    # LLAVA_E2E_LAYERS); the MoE archs at their training depth (e2e too)
    whisper_layers = get_config(WHISPER).num_layers
    for arch, tag, layers, e2e_layers, batch, seq in (
            (WHISPER, "whisper", None, whisper_layers, TRAIN_BATCH,
             WHISPER_PROMPT),
            (LLAVA, "llava", LLAVA_TRAIN_LAYERS, LLAVA_E2E_LAYERS,
             TRAIN_BATCH, LLAVA_PROMPT)) + tuple(
            (arch, tag, n, n, batch, seq)
            for arch, tag, n, batch, seq in MOE_TRAIN):
        t0 = time.perf_counter()
        counts.append(phase_training_arch(failures, arch, layers, seq, batch,
                                          f"training_{tag}"))
        phase_training_end_to_end(failures, arch, e2e_layers, seq,
                                  f"end_to_end_training_{tag}", batch)
        log(f"{arch} training phases: {time.perf_counter() - t0:.2f} s")
    for name, phase, args in (
            ("training_carousel", phase_training_carousel, (train_steps_s,)),
            ("carousel_fine_vs_coarse", phase_carousel_fine_vs_coarse, ()),
            ("checkpoint_resume", phase_checkpoint_resume, ()),
            ("remat_dots", phase_remat_dots, ())):
        t0 = time.perf_counter()
        counts += phase(failures, *args)
        log(f"{name} phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_cost_model(failures)
    log(f"cost_model phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    counts += phase_mesh(failures)
    log(f"mesh phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    tp_counts, mains["ce_merge"] = phase_tensor_parallel(failures)
    counts += tp_counts
    log(f"tensor_parallel phase: {time.perf_counter() - t0:.2f} s")
    mains["rmsnorm_split"], mains["rmsnorm_split_bwd"] = \
        mains.pop("rmsnorm_split")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(name=name, route="cuda", source=csrc + source,
             replaces=replaces,
             launches=sum(c.get(name, 0) for c in counts + [train_counts]),
             **{k: row[k] for k in keys})
        for name, source, replaces, row in (
            ("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25",
             mains["rmsnorm"]),
            ("rmsnorm_bwd", "rmsnorm.cu", "src/repro/kernels/ref.py:60",
             mains["rmsnorm_bwd"]),
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:80", mains["flash"]),
            ("flash_attention_bwd", "flash_attention.cu",
             "src/repro/kernels/ref.py:188", mains["flash_bwd"]),
            ("cross_entropy", "cross_entropy.cu",
             "src/repro/kernels/cross_entropy.py:56", mains["cross_entropy"]),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:71",
             mains["ssd"]),
            ("ssd_scan_bwd", "ssd_scan.cu", "src/repro/kernels/ref.py:322",
             mains["ssd_bwd"]),
            ("rmsnorm_split", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25",
             mains["rmsnorm_split"]),
            ("rmsnorm_split_bwd", "rmsnorm.cu", "src/repro/kernels/ref.py:60",
             mains["rmsnorm_split_bwd"]),
            ("ce_merge", "cross_entropy.cu",
             "src/repro/kernels/cross_entropy.py:56", mains["ce_merge"]),
            ("adamw", "adamw.cu", "none (jnp: src/repro/optim/adamw.py)",
             mains["adamw"]),
            ("moe_experts", "moe_experts.cu",
             "none (XLA: the capacity slot grid of "
             "src/repro/models/layers.py:370)", mains["moe_experts"]))]
    log(f"total: {time.perf_counter() - t_start:.2f} s")
    log(smi)
    log(json.dumps({"kernel_info": kernel_info}))
    log(json.dumps({"kernels": kernels}))
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        for f in failures:
            print("FAILED:", f, file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
