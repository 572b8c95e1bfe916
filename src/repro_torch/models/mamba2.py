"""Mamba2 (SSD — state-space duality) language model, ported from
``repro/models/mamba2.py``.

Per block (arXiv:2405.21060): in projections (z, x, B, C, dt) -> causal
depthwise conv on (x, B, C) -> SSD scan -> gated RMSNorm -> out
projection.  The projections stay split, as in the JAX tree, and plain
``@`` (cuBLAS).  Layers are stacked on a leading L axis; a Python loop
over layers on views of the stacked leaves takes the place of
``lax.scan``.  The decode state is O(1): conv tails (W - 1 tokens) and
the f32 SSM state (H, P, N) per layer, written in place into the stacked
cache.  Training checkpoints each block whole unless ``run.remat`` is
"none" (``run_layers``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import layer, pdef

Params = Dict[str, Any]
G = 1  # number of B/C groups (mamba2 default ngroups=1)


def block_defs(cfg: ModelConfig, n: int) -> Params:
    d, din = cfg.d_model, cfg.ssm_inner
    N, H, W = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    lead = (n,) if n else ()
    f32 = torch.float32
    return {
        "ln": L.norm_defs(n, d),
        "w_z": pdef(lead + (d, din), init="scaled"),
        "w_x": pdef(lead + (d, din), init="scaled"),
        "w_B": pdef(lead + (d, G * N), init="scaled"),
        "w_C": pdef(lead + (d, G * N), init="scaled"),
        "w_dt": pdef(lead + (d, H), init="scaled"),
        "conv_x": pdef(lead + (W, din), init="scaled"),
        "conv_B": pdef(lead + (W, G * N), init="scaled"),
        "conv_C": pdef(lead + (W, G * N), init="scaled"),
        "conv_x_b": pdef(lead + (din,), init="zeros"),
        "conv_B_b": pdef(lead + (G * N,), init="zeros"),
        "conv_C_b": pdef(lead + (G * N,), init="zeros"),
        "A_log": pdef(lead + (H,), init="ssm_a", dtype=f32),
        "D": pdef(lead + (H,), init="ones", dtype=f32),
        "dt_bias": pdef(lead + (H,), init="ssm_dt", dtype=f32),
        "norm": pdef(lead + (din,), init="ones"),
        "w_out": pdef(lead + (din, d), init="scaled"),
    }


def param_defs(cfg: ModelConfig) -> Params:
    return {
        "embed": L.embed_defs(cfg),
        "blocks": block_defs(cfg, cfg.num_layers),
        "ln_f": L.norm_defs(0, cfg.d_model),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, S, C); w: (W, C); returns
    (silu(conv + b) as a contiguous (B, S, C), new tail).

    tail: (B, W - 1, C), the previous context (decode), or None (zeros).
    The new tail is a view of the last W - 1 input rows."""
    W, C = w.shape
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, C))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = F.conv1d(xp.transpose(1, 2), w.t().unsqueeze(1), groups=C)
    y = y.transpose(1, 2).contiguous()
    new_tail = xp[:, -(W - 1):] if W > 1 else tail
    return F.silu(y + b), new_tail


def block_fwd(p: Params, cfg: ModelConfig, run: RunConfig, x: torch.Tensor,
              state: Optional[Params] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``state`` (serving): this layer's conv
    tails and SSM state, views into the stacked cache, updated in place;
    None for a plain forward."""
    Bb, S, _ = x.shape
    N, H, P = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = L.rmsnorm(p["ln"], x, cfg, run)

    z = h @ p["w_z"]
    xs = h @ p["w_x"]
    Bm = h @ p["w_B"]
    Cm = h @ p["w_C"]
    dt = h @ p["w_dt"]

    tails = (None, None, None) if state is None else (
        state["tail_x"], state["tail_B"], state["tail_C"])
    xs, tx = _causal_conv(xs, p["conv_x"], p["conv_x_b"], tails[0])
    Bm, tb = _causal_conv(Bm, p["conv_B"], p["conv_B_b"], tails[1])
    Cm, tc = _causal_conv(Cm, p["conv_C"], p["conv_C_b"], tails[2])

    xh = xs.reshape(Bb, S, H, P)  # a view: the kernel reads it in place
    Bg = Bm.reshape(Bb, S, G, N)
    Cg = Cm.reshape(Bb, S, G, N)
    dtp = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    init = None if state is None else state["ssm"]
    if S == 1 and state is not None:
        # decode: the single-token recurrence, no chunk
        y1, new_ssm = ops.ssd_decode(xh[:, 0], dtp[:, 0], A, Bg[:, 0],
                                     Cg[:, 0], init)
        y = y1[:, None]
    else:
        y, new_ssm = ops.ssd(xh, dtp, A, Bg, Cg, chunk=cfg.ssm_chunk,
                             init_state=init, return_state=True,
                             use_kernels=run.use_kernels)
    y = y + (xh.float() * p["D"][None, None, :, None]).to(y.dtype)
    y = y.reshape(Bb, S, H * P)

    y = ops.rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm"],
                    eps=cfg.norm_eps, use_kernels=run.use_kernels)
    out = y @ p["w_out"]
    if state is not None:
        state["tail_x"].copy_(tx)
        state["tail_B"].copy_(tb)
        state["tail_C"].copy_(tc)
        state["ssm"].copy_(new_ssm)
    return x + out


def state_defs(cfg: ModelConfig, n: int, batch: int) -> Params:
    """Decode-state ParamDefs for n stacked mamba blocks."""
    N, H, P, W = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv
    din = cfg.ssm_inner
    lead = (n,) if n else ()
    return {
        "tail_x": pdef(lead + (batch, W - 1, din), init="zeros"),
        "tail_B": pdef(lead + (batch, W - 1, G * N), init="zeros"),
        "tail_C": pdef(lead + (batch, W - 1, G * N), init="zeros"),
        "ssm": pdef(lead + (batch, H, P, N), init="zeros",
                    dtype=torch.float32),
    }


def run_layers(params: Params, cfg: ModelConfig, run: RunConfig,
               x: torch.Tensor, lo: int, hi: int,
               state: Optional[Params] = None) -> torch.Tensor:
    """Blocks ``lo .. hi - 1`` of ``params["blocks"]``; a given stacked
    ``state`` is updated in place.  With grad mode on, no state and
    ``run.remat`` other than "none", each block is checkpointed whole
    (its input kept, the block run again in the backward): the JAX blocks
    call ``jax.checkpoint`` with no policy for "full" and "dots" alike."""
    remat = run.remat != "none" and torch.is_grad_enabled() and \
        state is None
    for i in range(lo, hi):
        p_l = layer(params["blocks"], i)
        if remat:
            x = checkpoint(block_fwd, p_l, cfg, run, x, use_reentrant=False)
        else:
            s_l = None if state is None else layer(state, i)
            x = block_fwd(p_l, cfg, run, x, s_l)
    return x


def _run_blocks(params: Params, cfg: ModelConfig, run: RunConfig,
                x: torch.Tensor, state: Optional[Params] = None
                ) -> torch.Tensor:
    x = run_layers(params, cfg, run, x, 0, cfg.num_layers, state)
    return L.rmsnorm(params["ln_f"], x, cfg, run)


def forward(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any]) -> torch.Tensor:
    """Forward over a (B, S) batch -> final hidden states (B, S, d)."""
    x = L.embed(params["embed"], batch["tokens"])
    return _run_blocks(params, cfg, run, x)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return state_defs(cfg, cfg.num_layers, batch)


def prefill(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any], cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    """Runs a (B, S) prompt from the given state; returns last-position
    logits (B, 1, V) and the state (the same object, filled in place)."""
    x = L.embed(params["embed"], batch["tokens"])
    x = _run_blocks(params, cfg, run, x, state=cache)
    return L.logits_out(params["embed"], cfg, run, x[:, -1:]), cache


def decode(params: Params, cfg: ModelConfig, run: RunConfig,
           tokens: torch.Tensor, cache: Params, pos: int
           ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); ``pos`` is not read (the state
    carries the position)."""
    x = L.embed(params["embed"], tokens)
    x = _run_blocks(params, cfg, run, x, state=cache)
    return L.logits_out(params["embed"], cfg, run, x), cache
