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

Under sharding rules a block gathers its layer's weights from this
rank's blocks when it starts (ZeRO-3, over the batch axes).  Over
``model`` it follows the JAX block's tags, ``xh`` and ``y`` being
``("batch", None, "heads_ssm", "ssm_p")``: the first of the two that
divides ``model`` takes it (:func:`ssm_split`), and the rank computes
its block between ``enter_model`` and ``leave_model``, as attention and
the MLP do (``layers.py``):

heads (H % n == 0): the rank's H / n SSM heads.  They are its ``ffn``
  block of the stored weights (``din = H P`` is head-major), so ``w_z``,
  ``w_x``, ``conv_x``, ``conv_x_b``, ``norm`` and ``w_out`` stay as the
  rank holds them;
head dim (H % n != 0, P % n == 0): the rank's P / n channels of every
  head, columns ``h P + r P / n + j``, which are not its contiguous
  ``ffn`` block.  Those six weights are made whole (``model_whole``: the
  gradient summed over ``model``) and the rank's columns taken from
  them, as attention takes the kv heads it reads where they do not
  divide.  Chosen over resharding the activations (an all-to-all of z
  and x a block, each way) because the weights are small where this case
  arises (mamba2-130m at 16 ranks: 3 x 768 x 1536 bf16, 7 MB a block)
  and the block then runs with no collective but the two below;
whole (neither divides): every rank runs the block whole on weights
  gathered whole, the rules' own replication.

In both split cases every rank uses all of B and C and its heads' (or
all heads') dt, A, D and dt_bias: ``w_B``, ``w_C``, ``w_dt``, the B and
C convolutions and those vectors are replicated over ``model`` and come
from ``model_whole``, whose backward sums each rank's part of their
gradient, so it is the same on every model rank.  The SSD scan runs on
the rank's (B, S, H / n, P) or (B, S, H, P / n) block; the gated RMSNorm
runs over a row whose columns lie on the ranks (``ops.rmsnorm_split``:
its mean of squares, and its backward's mean of ``g w xhat``, summed
over ``model``, divided by the whole ``din``); ``leave_model`` sums the
ranks' ``y @ w_out`` rows.  A decode state holds the rank's block:
``tail_x`` the channels it convolves (its ``ffn`` block, or its
channels of every head), ``ssm`` its heads or head-dim channels
(``serve/engine.py::init_cache``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import obs
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import layer, pdef, unstack
from repro_torch.sharding import rules as SR

Params = Dict[str, Any]
G = 1  # number of B/C groups (mamba2 default ngroups=1)


def block_defs(cfg: ModelConfig, n: int) -> Params:
    """A block: its pre-norm ``ln`` and the mixer's weights."""
    return {"ln": L.norm_defs(n, cfg.d_model), **mixer_defs(cfg, n)}


def mixer_defs(cfg: ModelConfig, n: int) -> Params:
    """The mixer's weights (:func:`mixer`), ``n`` stacked (0: one)."""
    d, din = cfg.d_model, cfg.ssm_inner
    N, H, W = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    lead, ll = ((n,), ("layers",)) if n else ((), ())
    f32 = torch.float32
    return {
        "w_z": pdef(lead + (d, din), ll + ("embed", "ffn"), init="scaled"),
        "w_x": pdef(lead + (d, din), ll + ("embed", "ffn"), init="scaled"),
        "w_B": pdef(lead + (d, G * N), ll + ("embed", None), init="scaled"),
        "w_C": pdef(lead + (d, G * N), ll + ("embed", None), init="scaled"),
        "w_dt": pdef(lead + (d, H), ll + ("embed", None), init="scaled"),
        "conv_x": pdef(lead + (W, din), ll + (None, "ffn"), init="scaled"),
        "conv_B": pdef(lead + (W, G * N), ll + (None, None), init="scaled"),
        "conv_C": pdef(lead + (W, G * N), ll + (None, None), init="scaled"),
        "conv_x_b": pdef(lead + (din,), ll + ("ffn",), init="zeros"),
        "conv_B_b": pdef(lead + (G * N,), ll + (None,), init="zeros"),
        "conv_C_b": pdef(lead + (G * N,), ll + (None,), init="zeros"),
        "A_log": pdef(lead + (H,), ll + (None,), init="ssm_a", dtype=f32),
        "D": pdef(lead + (H,), ll + (None,), init="ones", dtype=f32),
        "dt_bias": pdef(lead + (H,), ll + (None,), init="ssm_dt",
                        dtype=f32),
        "norm": pdef(lead + (din,), ll + ("ffn",), init="ones"),
        "w_out": pdef(lead + (din, d), ll + ("ffn", "embed"),
                      init="scaled"),
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


def ssm_split(cfg: ModelConfig) -> str:
    """How the current rules split a mamba block over ``model``: "none"
    (one model rank), "heads", "p" (the SSD head dim) or "whole" (neither
    divides: every rank runs it whole)."""
    if SR.model_ranks() == 1:
        return "none"
    hp = (cfg.ssm_heads, cfg.ssm_head_dim)
    local = SR.current_rules().local_shape(("heads_ssm", "ssm_p"), hp,
                                           keep=("model",))
    return "heads" if local[0] < hp[0] else "p" if local[1] < hp[1] \
        else "whole"


# the weights a rank holds (or takes) by its din columns: w_out by rows
_DIN_LEAVES = ("w_z", "w_x", "conv_x", "conv_x_b", "norm", "w_out")


def block_fwd(p: Params, cfg: ModelConfig, run: RunConfig, x: torch.Tensor,
              state: Optional[Params] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``state`` (serving): this layer's conv
    tails and SSM state (under a ``model`` split, the rank's block of
    each), views into the stacked cache, updated in place; None for a
    plain forward.  Under a split (``ssm_split``: "heads" or "p") the rank
    computes its heads or head-dim channels (the module doc); else the
    block whole."""
    with obs.span("block.mamba2"):
        out = _mamba_block(p, cfg, run, x, state)
    obs.grad_span("block.mamba2.bwd", x, out)
    return out


def _mamba_block(p: Params, cfg: ModelConfig, run: RunConfig,
                 x: torch.Tensor, state: Optional[Params]) -> torch.Tensor:
    if SR.sharded():
        split = ssm_split(cfg) in ("heads", "p")
        p = SR.gather_params(p, unstack(block_defs(cfg, 1)),
                             keep=("model",) if split else ())
    return x + mixer(p, cfg, run, L.rmsnorm(p["ln"], x, cfg, run), state)


def mixer(p: Params, cfg: ModelConfig, run: RunConfig, h: torch.Tensor,
          state: Optional[Params] = None) -> torch.Tensor:
    """The Mamba2 mixer of a block, without its norm and residual: the
    normed input h (B, S, d) -> (B, S, d).  ``p`` holds the layer's mixer
    weights as ``_mamba_block`` gathers them (this rank's ``model`` block
    of each under a split); ``state`` as for :func:`block_fwd`."""
    Bb, S, _ = h.shape
    N, H, P = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    mode = ssm_split(cfg)
    split = mode in ("heads", "p")
    defs = unstack(mixer_defs(cfg, 1)) if split else None
    rules = SR.current_rules()

    def whole(k: str) -> torch.Tensor:
        """A weight every rank uses whole (replicated over ``model``, or
        made whole), its gradient summed over the ranks' parts."""
        return SR.model_whole(p[k], defs[k]) if split else p[k]

    heads, hl, pl = slice(None), H, P  # the heads and head dim computed
    loc = {k: p[k] for k in _DIN_LEAVES}
    if mode == "heads":
        n, r = SR.model_ranks(), rules.mesh.coord("model")
        heads, hl = slice(r * (H // n), (r + 1) * (H // n)), H // n
    elif mode == "p":
        n, r = SR.model_ranks(), rules.mesh.coord("model")
        pl = P // n
        cols = (torch.arange(H)[:, None] * P + r * pl
                + torch.arange(pl)).reshape(-1).to(h.device)
        loc = {k: whole(k).index_select(0 if k == "w_out" else -1, cols)
               for k in _DIN_LEAVES}
    if split:
        h = SR.enter_model(h)

    z = h @ loc["w_z"]
    xs = h @ loc["w_x"]
    Bm = h @ whole("w_B")
    Cm = h @ whole("w_C")
    dt = h @ whole("w_dt")[:, heads]

    tails = (None, None, None) if state is None else (
        state["tail_x"], state["tail_B"], state["tail_C"])
    xs, tx = _causal_conv(xs, loc["conv_x"], loc["conv_x_b"], tails[0])
    Bm, tb = _causal_conv(Bm, whole("conv_B"), whole("conv_B_b"), tails[1])
    Cm, tc = _causal_conv(Cm, whole("conv_C"), whole("conv_C_b"), tails[2])

    xh = xs.reshape(Bb, S, hl, pl)  # a view: the kernel reads it in place
    Bg = Bm.reshape(Bb, S, G, N)
    Cg = Cm.reshape(Bb, S, G, N)
    dtp = F.softplus(dt.float() + whole("dt_bias")[heads])
    A = -torch.exp(whole("A_log")[heads])

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
    y = y + (xh.float() * whole("D")[heads][None, None, :, None]).to(y.dtype)
    y = y.reshape(Bb, S, hl * pl) * F.silu(z.float()).to(y.dtype)

    if split:  # a row of din columns over the ranks; w_out's rows summed
        y = ops.rmsnorm_split(
            y, loc["norm"], d_whole=H * P,
            reduce=lambda t: rules.all_reduce(t, ("model",)),
            eps=cfg.norm_eps, use_kernels=run.use_kernels)
        out = SR.leave_model(y @ loc["w_out"])
    else:
        y = ops.rmsnorm(y, loc["norm"], eps=cfg.norm_eps,
                        use_kernels=run.use_kernels)
        out = y @ loc["w_out"]
    out = SR.constrain(out, "batch", None, None)
    if state is not None:
        state["tail_x"].copy_(tx)
        state["tail_B"].copy_(tb)
        state["tail_C"].copy_(tc)
        state["ssm"].copy_(new_ssm)
    return out


def state_defs(cfg: ModelConfig, n: int, batch: int) -> Params:
    """Decode-state ParamDefs for n stacked mamba blocks."""
    N, H, P, W = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv
    din = cfg.ssm_inner
    lead, ll = ((n,), ("layers",)) if n else ((), ())
    return {
        "tail_x": pdef(lead + (batch, W - 1, din),
                       ll + ("batch", None, "ffn"), init="zeros"),
        "tail_B": pdef(lead + (batch, W - 1, G * N),
                       ll + ("batch", None, None), init="zeros"),
        "tail_C": pdef(lead + (batch, W - 1, G * N),
                       ll + ("batch", None, None), init="zeros"),
        "ssm": pdef(lead + (batch, H, P, N),
                    ll + ("batch", "heads_ssm", "ssm_p", None), init="zeros",
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
            x = SR.checkpoint(block_fwd, p_l, cfg, run, x)
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
    x = L.embed(params["embed"], cfg, batch["tokens"])
    return _run_blocks(params, cfg, run, x)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return state_defs(cfg, cfg.num_layers, batch)


def prefill(params: Params, cfg: ModelConfig, run: RunConfig,
            batch: Dict[str, Any], cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    """Runs a (B, S) prompt from the given state; returns last-position
    logits (B, 1, V) and the state (the same object, filled in place)."""
    x = L.embed(params["embed"], cfg, batch["tokens"])
    x = _run_blocks(params, cfg, run, x, state=cache)
    return L.logits_out(params["embed"], cfg, run, x[:, -1:]), cache


def decode(params: Params, cfg: ModelConfig, run: RunConfig,
           tokens: torch.Tensor, cache: Params, pos: int
           ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1); ``pos`` is not read (the state
    carries the position)."""
    x = L.embed(params["embed"], cfg, tokens)
    x = _run_blocks(params, cfg, run, x, state=cache)
    return L.logits_out(params["embed"], cfg, run, x), cache
