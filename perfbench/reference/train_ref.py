"""The reference's training steps, for any family module of this folder.

The model runs a unit at a time in f32, so that a full-size model fits
beside its optimizer state: the forward keeps each unit's input, and the
backward runs each unit again with autograd from its input.  Global-norm
clipping needs every gradient before the first update, so a step sweeps
the backward twice: once for the loss and the norm, once more to update
each slice as its gradient comes (a unit's update cannot reach a unit
the sweep has yet to run: those use their own, untouched weights, and the
leaves units share are updated at the end).  The weights stay in their
stored types (bfloat16, f32 for the SSM's vectors) and every update is
worked out in f32 and rounded once, as the configurations state; AdamW's
moments are f32; a leaf of two or more stored dimensions decays.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from perfbench.reference.common import (adamw_slice, cosine_lr, get, nll,
                                        unit_weights)

Path = Tuple[str, ...]


def masked_mean(per_tok: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (per_tok * mask).sum() / mask.sum().clamp(min=1.0)


def halve(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A fault: the loss taken over half of the batch, the first half of
    its rows (of its positions, where it has one row)."""
    m = batch["loss_mask"].clone()
    if m.shape[0] > 1:
        m[m.shape[0] // 2:] = 0
    else:
        m[:, m.shape[1] // 2:] = 0
    return dict(batch, loss_mask=m)


def _sweep(fam, c, params, batch, mode: str, upd: Optional[dict]):
    """One forward (unless ``upd`` carries the unit inputs) and one
    backward.  Without ``upd``: (unit inputs, loss, sum of squares of
    each leaf's gradient).  With it, each gradient updates its slice."""
    units = fam.units(c)
    if upd is None:
        with torch.no_grad():
            x = fam.embed(c, params, batch["tokens"])
            xs = [x]
            for u in units:
                x = fam.unit_forward(
                    c, u, unit_weights(params, fam.unit_leaves(c, u)), x,
                    mode)
                xs.append(x)
    else:
        xs = upd["xs"]
    sq: Dict[Path, torch.Tensor] = {}
    whole: Dict[Path, torch.Tensor] = {}

    def take(path, layer, g):
        if layer is None:
            whole[path] = g if path not in whole else whole[path] + g
        elif upd is not None:
            _update(params, path, layer, g, upd)
        else:
            s = (g * g).sum()
            sq[path] = s if path not in sq else sq[path] + s

    xn = xs[-1].detach().requires_grad_()
    wh = unit_weights(params, fam.HEAD_LEAVES, True)
    h = fam.head_hidden(c, wh, xn)
    per_tok = nll(h.reshape(-1, h.shape[-1]), wh[("embed", "lm_head")],
                  batch["labels"].reshape(-1), mode)
    loss = masked_mean(per_tok, batch["loss_mask"].reshape(-1).float())
    loss.backward()
    g = xn.grad
    for (path, layer), t in zip(fam.HEAD_LEAVES, wh.values()):
        take(path, layer, t.grad)
    del wh, h, per_tok, xn
    for i in reversed(range(len(units))):
        leaves = fam.unit_leaves(c, units[i])
        w = unit_weights(params, leaves, True)
        xi = xs[i].detach().requires_grad_()
        fam.unit_forward(c, units[i], w, xi, mode).backward(g)
        g = xi.grad
        for (path, layer), t in zip(leaves, w.values()):
            take(path, layer, t.grad)
        del w, xi
    tok = get(params, ("embed", "tok"))
    gt = torch.zeros(tok.shape, dtype=torch.float32, device=tok.device)
    gt.index_add_(0, batch["tokens"].reshape(-1).long(),
                  g.reshape(-1, g.shape[-1]))
    take(("embed", "tok"), None, gt)
    for path, gw in whole.items():
        if upd is not None:
            _update(params, path, None, gw, upd)
        else:
            sq[path] = (gw * gw).sum()
    return xs, float(loss.detach()), {p: float(s) for p, s in sq.items()}


def _update(params, path: Path, layer: Optional[int], g: torch.Tensor,
            upd: dict) -> None:
    p = get(params, path)
    if path not in upd["m"]:
        for k in ("m", "v"):
            upd[k][path] = torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
    m, v = upd["m"][path], upd["v"][path]
    sl = (lambda t: t) if layer is None else (lambda t: t[layer])
    adamw_slice(sl(p), g * upd["scale"], sl(m), sl(v), step=upd["step"],
                lr=upd["lr"], decay=p.dim() >= 2, wd=upd["wd"])


def leaf_change(p: torch.Tensor, p0: torch.Tensor,
                chunk: int = 1 << 26) -> float:
    """‖p - p0‖ in f32, ``chunk`` elements at a time."""
    a, b = p.reshape(-1), p0.reshape(-1)
    return float(torch.stack([
        ((x.float() - y.float()) ** 2).sum()
        for x, y in zip(a.split(chunk), b.split(chunk))]).sum().sqrt())


def train(fam, c: Dict, params: Dict, batches: List[Dict], opt: Dict, *,
          steps: int, p0: Callable[[Path], torch.Tensor], mode: str = "f32",
          fault: Optional[str] = None) -> Dict:
    """``steps`` AdamW steps of ``params`` (trained IN PLACE) on
    ``batches``.  Returns each step's loss, each leaf's norm of the first
    step's clipped gradient (what the optimizer gets), with its unclipped
    norm, and each leaf's distance from its initial value ``p0(path)``
    after the last step.  ``fault`` plants one of the faults the limits
    are held against: ``"half_batch"`` (:func:`halve`) or ``"frozen"``
    (a step that leaves the state as it was: no update, no moments)."""
    out: Dict = {"loss": [], "grad1": {}, "grad1_raw": {}, "change": {}}
    m: Dict[Path, torch.Tensor] = {}
    v: Dict[Path, torch.Tensor] = {}
    for k in range(1, steps + 1):
        batch = batches[k - 1] if fault != "half_batch" else halve(
            batches[k - 1])
        xs, loss, sq = _sweep(fam, c, params, batch, mode, None)
        norm = math.sqrt(sum(sq.values()))
        scale = min(1.0, opt["max_grad_norm"] / max(norm, 1e-9))
        out["loss"].append(loss)
        if k == 1:
            out["grad1_raw"] = {p: math.sqrt(s) for p, s in sq.items()}
            out["grad1"] = {p: math.sqrt(s) * scale for p, s in sq.items()}
        if fault == "frozen":
            out["grad1"] = {p: 0.0 for p in sq}
            continue
        lr = cosine_lr(k, base_lr=opt["learning_rate"],
                       warmup_steps=opt["warmup_steps"],
                       total_steps=opt["total_steps"])
        _sweep(fam, c, params, batch, mode,
               dict(xs=xs, scale=scale, lr=lr, step=k, m=m, v=v,
                    wd=opt["weight_decay"]))
        del xs
    m.clear()
    v.clear()
    for path in fam.leaf_specs(c):
        p0_t = p0(path)
        out["change"][path] = leaf_change(get(params, path), p0_t)
        del p0_t
    return out
