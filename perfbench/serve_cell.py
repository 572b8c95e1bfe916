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

Over N > 1 ranks (a cell of N cards) the mesh is (1, N): one model
group, each rank holding its blocks of the weights (drawn whole and cut
by the port's ``local_shard``, or a layer at a time where the
configuration says ``draw_by_layer``) and of the cache.  Rank 0's clock
closes the window, and every rank stops after the same batch.  Rank r
runs the reference over every N-th sampled request, and over all of
them compares the first layer's V in its own block of the cache.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from perfbench import corpus, ranks, weights
from perfbench.devtrace import DeviceTrace
from perfbench.program import Shards, model_config
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
        fault: Optional[str] = None,
        kv_cache_dtype: Optional[str] = None) -> None:
    """``control`` (a reference precision) adds the control's gap at the
    same positions, and ``fault`` (a fault the family's reference can
    plant, e.g. ``"top1"``) that of the reference with the fault;
    ``kv_cache_dtype`` switches the program's own cache type (its int8
    path), for the control's readings."""
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
    tracer = DeviceTrace(dev) if trace and _rank() == 0 else None
    probe = hasattr(fam, "cache_v")
    batches: List[Dict] = []
    rules = prog.host_rules(cell.chips if cell.chips > 1 else None, dev)
    by_layer = bool(cell.config.get("draw_by_layer"))
    shards = Shards(prog, cfg, rules) if cell.chips > 1 or by_layer \
        else None
    with prog.use_rules(rules), torch.inference_mode():
        rec.log("program loaded")
        params = weights.draw_tree(specs, seed, dev) if shards is None \
            else weights.draw_blocks(specs, seed, dev, shards, by_layer)
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
            if ranks.agree(t_done - t0 >= seconds):
                break
        rec.window_s = batches[-1]["t_done"] - t0
        rec.log(f"window: {len(batches)} batches in {rec.window_s!r} s: "
                + " ".join(f"{b['len']}:{b['t_first'] - b['t_send']:.4f}"
                           f"+{b['t_done'] - b['t_first']:.4f}"
                           for b in batches))
        rec.batches = batches
        rec.shape = dict(clients=B, gen_tokens=gen)
        if trace:
            # the mix's first lengths, whatever the window held, so that
            # every traced run reads the same work; rank 0 traces them,
            # the other ranks run them untraced
            lens_traced = order[:t["trace_batches"]]
            if tracer:
                tracer.start()
            for i, L in enumerate(lens_traced):
                prompts = corpus.prompt_tokens(seed, len(batches) + i, B, L,
                                               V, dev)
                _batch(prog, cfg, run_cfg, params, rules, prompts, max_len,
                       gen, dev)
            if tracer:
                tracer.stop()
                rec.trace = tracer.summary()
            rec.traced_calls = [call for L in lens_traced
                                for call in fam.kernel_calls(
                                    c, "prefill", B, L, max_len,
                                    ranks=cell.chips)]
        rec.read_memory(dev)
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rec.check = check(cell, seed, dev, batches, control=control,
                      fault=fault, cache_read=prog.cache_read, shards=shards)
    rec.log("reference done")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def check(cell, seed: int, dev, batches: List[Dict],
          control: Optional[str] = None, fault: Optional[str] = None,
          cache_read=None, shards: Optional[Shards] = None
          ) -> Dict[str, float]:
    """At each position of a seeded sample of the served requests that
    chose a served token (this rank's share: every N-th of N ranks):
    ``logit_err``, the widest relative L2 gap of the program's logits from
    the reference's; ``logit_gap``, the widest gap by which a served
    token's reference logit lies below the reference's best.  With
    ``control`` (a precision of the reference), the same two of the
    reference in that precision at the same positions, the gap for the
    token it puts first (``control_err``, ``control_gap``), and the first
    layer's V in it (``control_cache_err``); with ``fault``, the two of
    the reference with that fault (``<fault>_err``, ``<fault>_gap``).
    Beside each pair, its median relative gap and mean gap over the
    positions of every rank (``_spread``: ``logit_err_p50``,
    ``logit_gap_mean``, ...).  Where the family's reference gives the
    first layer's V (``cache_v``): ``cache_err``, the widest relative L2 gap of that V, as
    the program's cache holds it (read back by ``cache_read``; this rank's
    block of it, cut by ``shards``), from the reference's, a request at a
    time over every position written, over the whole sample."""
    t, c, fam = cell.traffic, cell.config["model"], cell.family
    reqs = [(i, r) for i, b in enumerate(batches) for r in range(b["rows"])]
    top = max(b["len"] for b in batches)
    longest = [q for q in reqs if batches[q[0]]["len"] == top]
    keep = [longest[i] for i in corpus.sample(
        seed, list(range(len(longest))), t["check_longest"], [])]
    picked = corpus.sample(seed, reqs, t["check_requests"], keep)
    mine = set(picked[_rank()::cell.chips])
    by_batch: Dict[int, List[int]] = {}
    for i, r in picked:
        by_batch.setdefault(i, []).append(r)
    seqs, first, served, got, held = [], [], [], [], []
    for i, rows in sorted(by_batch.items()):
        b = batches[i]
        p = corpus.prompt_tokens(seed, i, b["rows"], b["len"],
                                 c["vocab_size"], dev)[rows]
        s = b["tokens"][rows].to(dev)
        seq = torch.cat([p, s[:, :-1]], dim=1)
        if b.get("kv0") is not None:
            held.append((cache_read(b["kv0"])[1][rows].float(), seq))
        own = [j for j, r in enumerate(rows) if (i, r) in mine]
        if own:
            seqs.append(seq[own])
            first.append(b["len"] - 1)
            served.append(s[own])
            got.append(torch.cat(b["logits"], dim=1)[rows][own].float())
    for b in batches:
        b.pop("logits", None)
        b.pop("kv0", None)
    strict_f32()
    specs = fam.leaf_specs(c)
    params = weights.reference_tree(
        specs, seed, dev, bool(cell.config.get("draw_by_layer")))
    out: Dict[str, float] = {}
    ref = serve_ref.logits_at(fam, c, params, seqs, first) if seqs else []
    if seqs:
        out.update(_numbers("logit", got, ref, served))
    out.update(_spread("logit", got, ref, served))
    size = (t["clients"], max(t["prompt_lens"]) + t["gen_tokens"])
    for key, mode in (("cache_err", "f32"), ("control_cache_err", control)):
        errs = [_cache_err(fam, c, params, v if key == "cache_err" else None,
                           s, *size, shards, mode=mode)
                for v, s in held if mode]
        if any(e is not None for e in errs):
            out[key] = max(e for e in errs if e is not None)
    for mode, key in ((control, "control"), (fault, fault)):
        if not mode:
            continue
        alt = serve_ref.logits_at(fam, c, params, seqs, first, mode=mode) \
            if seqs else []
        chosen = [x.argmax(dim=-1) for x in alt]
        if seqs:
            out.update(_numbers(key, alt, ref, chosen))
        out.update(_spread(key, alt, ref, chosen))
    return out


def _numbers(key: str, got, ref, tokens) -> Dict[str, float]:
    """The widest relative L2 gap of logits ``got`` from ``ref``
    (``<key>_err``) and the widest gap of ``tokens``' reference logit below
    the reference's best (``<key>_gap``), over this rank's positions."""
    return {key + "_err": float(torch.cat(
                [serve_ref.rel_err(g, r) for g, r in zip(got, ref)]).max()),
            key + "_gap": max(float(serve_ref.gaps(r, x).max())
                              for r, x in zip(ref, tokens))}


def _spread(key: str, got, ref, tokens) -> Dict[str, float]:
    """Over every compared position of every rank (this rank's gathered
    with the others'): the median relative L2 gap of the logits ``got``
    from ``ref`` (``<key>_err_p50``) and the mean gap of ``tokens``'
    reference logit below the reference's best (``<key>_gap_mean``).
    Where routing is discrete (an MoE), the few positions whose route a
    rounding flips at some layer set the widest gaps, and these two read
    the rest."""
    e = torch.cat([serve_ref.rel_err(g, r).flatten().cpu()
                   for g, r in zip(got, ref)] or [torch.zeros(0)])
    g = torch.cat([serve_ref.gaps(r, x).flatten().cpu()
                   for r, x in zip(ref, tokens)] or [torch.zeros(0)])
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        parts: List = [None] * dist.get_world_size()
        dist.all_gather_object(parts, (e, g))
        e = torch.cat([p[0] for p in parts])
        g = torch.cat([p[1] for p in parts])
    if e.numel() == 0:
        return {}
    return {key + "_err_p50": float(e.median()),
            key + "_gap_mean": float(g.mean())}


def _cache_err(fam, c, params, held, seq, rows: int, max_len: int,
               shards: Optional[Shards], mode: str = "f32"
               ) -> Optional[float]:
    """The widest relative L2 gap of the first layer's V of the requests
    ``seq`` (n, T) in ``held`` (n, positions, heads, head dim: this rank's
    block of their cache) from the reference's V in the same block, over
    the positions written (T); with ``held`` None, of the reference's V
    computed in ``mode`` instead.  None where the block holds no position
    written."""
    n, T = seq.shape
    ref = fam.cache_v(c, params, seq)
    full = ref.new_zeros((n, max_len) + ref.shape[2:])
    full[:, :T] = ref
    pos = torch.arange(max_len, device=ref.device).view(1, -1, 1, 1)
    pos = pos.expand(full.shape)
    if shards is not None:
        full = shards.cache("v", full, rows, max_len)
        pos = shards.cache("v", pos, rows, max_len)
    written = pos[0, :, 0, 0] < T
    if not bool(written.any()):
        return None
    if held is None:
        alt = ref.new_zeros((n, max_len) + ref.shape[2:])
        alt[:, :T] = fam.cache_v(c, params, seq, mode=mode)
        held = shards.cache("v", alt, rows, max_len) if shards else alt
    return float(serve_ref.rel_err(held[:, written].flatten(1),
                                   full[:, written].flatten(1)).max())
