"""A serving cell: the port's greedy serving path as ``serve/engine.py``
runs it (``init_cache``, then ``registry.prefill`` and
``registry.decode``, the token taken from the last position's logits by
``argmax``), as ``launch/serve.py`` runs it at one rank, under the host
mesh's sharding rules and in inference mode.  The harness takes the
argmax itself and keeps the logits that chose each token, so that the
timed path's logits are what ``correct`` judges.

The mix is a closed loop of ``clients`` served as one batch: each client
sends its next prompt the moment its last answer is on the host, so a
batch starts as the one before it ends.  A batch's prompt length comes
from the mix's lengths in their order, round after round, its prompts
from the seed, and each request gets ``gen_tokens`` greedy tokens.  A
request's time to first token runs from its sending to its first token
on the host.  Set-up warms one batch at the longest prompt.
The window closes at the end of the batch in flight once ``--seconds``
have passed.  After it, the reference runs over a seeded sample of the
finished requests, the longest among them, at each position that chose
a served token: the widest relative gap of the program's logits from the
reference's, and the widest gap by which a served token's reference
logit lies below the reference's best, decide.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from perfbench import corpus, weights
from perfbench.devtrace import DeviceTrace
from perfbench.program import model_config
from perfbench.reference import serve_ref
from perfbench.reference.common import strict_f32
from perfbench.train_cell import check_layout


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next ids (B, 1) from (B, 1, V) logits, as the engine takes
    them."""
    return logits[:, -1].argmax(dim=-1, keepdim=True)


def _batch(prog, cfg, run_cfg, params, rules, prompts, max_len, gen, dev,
           probe=False):
    """One batch through the program's prefill and decode: the times its
    first tokens and all its tokens are on the host, the tokens (B, gen),
    the logits that chose them (``gen`` tensors (B, 1, V), left on the
    device), and with ``probe`` a copy of the first layer's KV cache as
    the batch left it (else None)."""
    split = rules.local_batch({"tokens": prompts})
    rows, axes = (split[1], split[2]) if split else (prompts.shape[0], ())
    L = prompts.shape[1]
    with prog.batch_split(rows, axes):
        cache = prog.engine.init_cache(cfg, rows, max_len, device=dev)
        logits, cache = prog.registry.prefill(
            params, cfg, run_cfg, {"tokens": prompts}, cache)
        tok = _greedy(logits)
        outs, seen = [tok], [logits]
        tok.cpu()
        t_first = time.perf_counter()
        for j in range(gen - 1):
            logits, cache = prog.registry.decode(params, cfg, run_cfg, tok,
                                                 cache, L + j)
            tok = _greedy(logits)
            outs.append(tok)
            seen.append(logits)
        seq = torch.cat(outs, dim=1).cpu()
        kv0 = {n: x[0].clone() for n, x in cache.items()} if probe else None
        del cache
    return t_first, time.perf_counter(), seq, (seen, kv0)


def run(cell, prog, rec, *, seed: int, seconds: float, trace: bool,
        dev: torch.device, control: Optional[str] = None,
        kv_cache_dtype: Optional[str] = None) -> None:
    """``control`` (a reference precision) adds the control's gap at the
    same positions; ``kv_cache_dtype`` switches the program's own cache
    type (its int8 path), for the control's readings."""
    t, c, fam = cell.traffic, cell.config["model"], cell.family
    cfg = model_config(prog, cell.config)
    if kv_cache_dtype:
        cfg = cfg.replace(kv_cache_dtype=kv_cache_dtype)
    specs = fam.leaf_specs(c)
    check_layout(prog, cfg, specs)
    run_cfg = prog.RunConfig()
    B, gen, lens = t["clients"], t["gen_tokens"], t["prompt_lens"]
    max_len = max(lens) + gen
    V = c["vocab_size"]
    tracer = DeviceTrace(dev) if trace else None
    probe = hasattr(fam, "cache_v")
    batches: List[Dict] = []
    rules = prog.host_rules(None, dev)
    with prog.use_rules(rules), torch.inference_mode():
        rec.log("program loaded")
        params = weights.draw_tree(specs, seed, dev)
        warm = corpus.prompt_tokens(seed, -1, B, max(lens), V, dev)
        _batch(prog, cfg, run_cfg, params, rules, warm, max_len, gen, dev)
        rec.log("warm-up batch done")
        if tracer:
            tracer.warm()
        order = corpus.prompt_order(lens, 100_000)
        _sync(dev)
        t0 = time.perf_counter()
        rec.setup_s = t0 - rec.t_start
        t_send = t0
        while True:
            L = order[len(batches)]
            prompts = corpus.prompt_tokens(seed, len(batches), B, L, V, dev)
            t_first, t_done, seq, (seen, kv0) = _batch(
                prog, cfg, run_cfg, params, rules, prompts, max_len, gen, dev,
                probe=probe)
            batches.append(dict(len=L, rows=B, t_send=t_send,
                                t_first=t_first, t_done=t_done, tokens=seq,
                                logits=seen, kv0=kv0))
            t_send = t_done
            if t_done - t0 >= seconds:
                break
        rec.window_s = batches[-1]["t_done"] - t0
        rec.log(f"window: {len(batches)} batches in {rec.window_s!r} s: "
                + " ".join(f"{b['len']}:{b['t_first'] - b['t_send']:.4f}"
                           f"+{b['t_done'] - b['t_first']:.4f}"
                           for b in batches))
        rec.batches = batches
        rec.shape = dict(clients=B, gen_tokens=gen)
        if tracer:
            # the mix's first lengths, whatever the window held, so that
            # every traced run reads the same work
            lens_traced = order[:t["trace_batches"]]
            tracer.start()
            for i, L in enumerate(lens_traced):
                prompts = corpus.prompt_tokens(seed, len(batches) + i, B, L,
                                               V, dev)
                _batch(prog, cfg, run_cfg, params, rules, prompts, max_len,
                       gen, dev)
            tracer.stop()
            rec.trace = tracer.summary()
            rec.traced_calls = [call for L in lens_traced
                                for call in fam.kernel_calls(
                                    c, "prefill", B, L, max_len)]
        rec.read_memory(dev)
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rec.check = check(cell, seed, dev, batches, control=control,
                      cache_read=prog.cache_read)
    rec.log("reference done")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check(cell, seed: int, dev, batches: List[Dict],
          control: Optional[str] = None,
          cache_read=None) -> Dict[str, float]:
    """At each position of a seeded sample of the served requests that
    chose a served token: ``logit_err``, the widest relative L2 gap of the
    program's logits from the reference's; ``logit_gap``, the widest gap
    by which a served token's reference logit lies below the reference's
    best.  With ``control`` (a precision of the reference), the same two
    of the reference in that precision at the same positions, the gap for
    the token it puts first.  Where the family's reference gives the
    first layer's V (``cache_v``): ``cache_err``, the widest relative L2
    gap of that V, as the program's cache holds it (read back by
    ``cache_read``), from the reference's, a request at a time over every
    position written."""
    t, c, fam = cell.traffic, cell.config["model"], cell.family
    reqs = [(i, r) for i, b in enumerate(batches) for r in range(b["rows"])]
    top = max(b["len"] for b in batches)
    longest = [q for q in reqs if batches[q[0]]["len"] == top]
    keep = [longest[i] for i in corpus.sample(
        seed, list(range(len(longest))), t["check_longest"], [])]
    picked = corpus.sample(seed, reqs, t["check_requests"], keep)
    by_batch: Dict[int, List[int]] = {}
    for i, r in picked:
        by_batch.setdefault(i, []).append(r)
    seqs, first, served, got, held = [], [], [], [], []
    for i, rows in sorted(by_batch.items()):
        b = batches[i]
        p = corpus.prompt_tokens(seed, i, b["rows"], b["len"],
                                 c["vocab_size"], dev)[rows]
        s = b["tokens"][rows].to(dev)
        seqs.append(torch.cat([p, s[:, :-1]], dim=1))
        first.append(b["len"] - 1)
        served.append(s)
        got.append(torch.cat(b["logits"], dim=1)[rows].float())
        if b.get("kv0") is not None:
            T = seqs[-1].shape[1]
            held.append(cache_read(b["kv0"])[1][rows, :T].float())
    for b in batches:
        b.pop("logits", None)
        b.pop("kv0", None)
    strict_f32()
    specs = fam.leaf_specs(c)
    params = weights.draw_tree(specs, seed, dev)
    ref = serve_ref.logits_at(fam, c, params, seqs, first)
    err = torch.cat([serve_ref.rel_err(g, r) for g, r in zip(got, ref)])
    out = {"logit_err": float(err.max()),
           "logit_gap": max(float(serve_ref.gaps(r, s).max())
                            for r, s in zip(ref, served))}
    if held:
        out["cache_err"] = max(
            float(serve_ref.rel_err(v.flatten(1), fam.cache_v(
                c, params, s).flatten(1)).max())
            for v, s in zip(held, seqs))
    if control:
        ctl = serve_ref.logits_at(fam, c, params, seqs, first, mode=control)
        out["control_err"] = float(torch.cat(
            [serve_ref.rel_err(x, r) for x, r in zip(ctl, ref)]).max())
        out["control_gap"] = max(
            float(serve_ref.gaps(r, x.argmax(dim=-1)).max())
            for r, x in zip(ref, ctl))
    return out
