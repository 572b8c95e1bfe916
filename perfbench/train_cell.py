"""A training cell: the port's train step (``train/step.py``), fed by its
carousel (``ColdStore`` -> ``Stager`` with the packing transform ->
``DiskCache`` -> ``DeliveryIterator`` -> ``device_put``), as
``launch/train.py`` runs them at one rank, without checkpoints, under
the host mesh's sharding rules.

Set-up draws the weights, builds the optimizer state and the carousel,
and drives that one state through the mix's first ``check_steps`` steps
by the window's own call and feed: they warm every shape, and the
readings that ``correct`` compares come from them (each step's loss; the
first gradient, as AdamW got it, from the first moment after step one;
how far each leaf moved in the steps).  The window then runs steps until
``--seconds`` have passed and closes at the end of the step in flight.
Every batch a step got, set-up's, the window's and the trace's, is kept
as the step got it.  After the window, with the program's state freed,
the reference re-derives the delivered rows from the corpus, checks
each row that a step got against its own at that place, and trains the
same weights from the first ``check_steps`` batches.
"""
from __future__ import annotations

import functools
import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import corpus, weights
from perfbench.devtrace import DeviceTrace
from perfbench.program import model_config, param_layout
from perfbench.reference import packing, train_ref
from perfbench.reference.common import flatten, get, strict_f32

B1 = 0.9  # AdamW's first-moment decay, the port's default


def check_layout(prog, cfg, specs) -> None:
    want = {p: (tuple(l.shape), l.dtype) for p, l in specs.items()}
    have = param_layout(prog, cfg)
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()), key=str)[:6]
        raise RuntimeError("the program's parameter tree is not the one the "
                           f"reference draws: {diff}")


def _carousel(prog, cell, seed: int):
    """(stager, delivery, the shards the delivery took, in order).  The
    mix's ``cold``, ``cache``, ``stager`` and ``delivery`` settings go to
    ``ColdStore``, ``DiskCache``, ``Stager`` and ``DeliveryIterator`` as
    they stand."""
    t, c = cell.traffic, cell.config["model"]
    cp = t["corpus"]
    cold = prog.ColdStore(**t["cold"], seed=corpus.mix(seed, "tape"))
    names = []
    for s in range(cp["shards"]):
        names.append(f"shard-{s:05d}")
        cold.add(prog.TapeFile(
            name=names[-1], size=cp["docs_per_shard"] * cp["mean_doc_len"] * 4,
            generator=functools.partial(
                corpus.shard_docs, seed, s, cp["docs_per_shard"],
                c["vocab_size"], cp["mean_doc_len"])))
    taken: List[str] = []

    class Watched(prog.DiskCache):
        """The staging cache, noting each shard the delivery takes."""

        def get(self, name):
            taken.append(name)
            return super().get(name)

    cache = Watched(**t["cache"])
    stager = prog.Stager(cold, cache, **t["stager"],
                         transform=prog.make_packing_transform(t["seq_len"]))
    stager.submit_all(names)
    delivery = prog.DeliveryIterator(stager, cache, names,
                                     batch_rows=t["rows"], **t["delivery"])
    return stager, delivery, taken


def _next(feed):
    batch = next(feed, None)
    if batch is None:
        raise RuntimeError("the corpus ran out: the mix's shards are too few "
                           "for this window")
    return batch


def run(cell, prog, rec, *, seed: int, seconds: float, trace: bool,
        dev: torch.device) -> None:
    t, c, fam = cell.traffic, cell.config["model"], cell.family
    cfg = model_config(prog, cell.config)
    specs = fam.leaf_specs(c)
    check_layout(prog, cfg, specs)
    opt = t["optim"]
    run_cfg = prog.RunConfig(
        remat=opt["remat"], learning_rate=opt["learning_rate"],
        weight_decay=opt["weight_decay"], warmup_steps=opt["warmup_steps"],
        total_steps=opt["total_steps"], max_grad_norm=opt["max_grad_norm"],
        ce_block_v=max(64, c["vocab_size"] // 8))
    tracer = DeviceTrace(dev) if trace else None
    fed: List[Dict[str, torch.Tensor]] = []  # every batch, as a step got it
    got: Dict = {"loss": [], "grad1": {}, "change": {}}
    steps: List[Dict] = []
    with prog.use_rules(prog.host_rules(None, dev)):
        rec.log("program loaded")
        params = weights.draw_tree(specs, seed, dev)
        state = {"params": params,
                 "opt": prog.adamw_init(params, dtype=torch.float32)}
        step_fn = prog.make_train_step(cfg, run_cfg)
        stager, delivery, taken = _carousel(prog, cell, seed)

        def delivered():
            for b in delivery:
                fed.append(prog.device_put(b, dev))
                yield fed[-1]
        feed = delivered()
        _sync(dev)
        rec.log("weights, optimizer state and carousel ready")
        try:
            for k in range(1, t["check_steps"] + 1):
                state, met = step_fn(state, _next(feed))
                got["loss"].append(float(met["loss"]))
                rec.log(f"set-up step {k}: loss {got['loss'][-1]!r}")
                if k == 1:
                    got["grad1"] = {
                        p: float(m.float().norm()) / (1.0 - B1)
                        for p, m in flatten(state["opt"]["m"]).items()}
            for p, leaf in specs.items():
                got["change"][p] = train_ref.leaf_change(
                    get(state["params"], p),
                    weights.draw_leaf(leaf, seed, p, dev))
            if tracer:
                tracer.warm()
            _sync(dev)
            rec.log("readings of the set-up steps taken")
            t0 = time.perf_counter()
            rec.setup_s = t0 - rec.t_start
            while True:
                steps.append(_step(step_fn, state, feed))
                if steps[-1]["t1"] - t0 >= seconds:
                    break
            rec.window_s = steps[-1]["t1"] - t0
            rec.log(f"window: {len(steps)} steps in {rec.window_s!r} s")
            if tracer:
                tracer.start()
                for _ in range(t["trace_steps"]):
                    _step(step_fn, state, feed)
                tracer.stop()
        finally:
            stager.shutdown()
        rec.steps = steps
        rec.shape = dict(rows=t["rows"], seq_len=t["seq_len"])
        if tracer:
            rec.trace = tracer.summary()
            rec.traced_calls = t["trace_steps"] * fam.kernel_calls(
                c, "train", t["rows"], t["seq_len"])
        rec.read_memory(dev)
        fed_np = [{n: v.cpu().numpy() for n, v in b.items()} for b in fed]
        del state, params, feed, delivery, step_fn, met, fed
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rec.check = _check(cell, seed, dev, fed_np, taken, got, rec)
        rec.log("reference done")


def _step(step_fn, state, feed) -> Dict:
    """One step as the trainer takes it: the batch from the delivery,
    the step, its loss on the host."""
    tn = time.perf_counter()
    batch = _next(feed)
    tw = time.perf_counter()
    _, met = step_fn(state, batch)
    float(met["loss"])
    return dict(t0=tn, t1=time.perf_counter(), wait_s=tw - tn,
                tokens=int(batch["tokens"].numel()))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rederive(cell, seed: int, fed: List[Dict[str, np.ndarray]],
             taken: List[str]):
    """The reference's own rows for the fed batches: the shards the
    delivery took, each packed again from the corpus, laid end to end in
    the order it took them and cut into batches of the fed sizes, as the
    delivery's contract hands them out.  Returns (those batches, the
    count of fed rows that are not the reference's row at their place:
    a row dropped, repeated, moved or altered, every row after it too)."""
    t, c = cell.traffic, cell.config["model"]
    cp = t["corpus"]
    want = sum(b["tokens"].shape[0] for b in fed)
    rows: List[Dict[str, np.ndarray]] = []
    for name in taken:
        if len(rows) >= want:
            break
        p = packing.pack(corpus.shard_docs(
            seed, int(name.split("-")[1]), cp["docs_per_shard"],
            c["vocab_size"], cp["mean_doc_len"]), t["seq_len"])
        rows += [{k: v[r] for k, v in p.items()}
                 for r in range(p["tokens"].shape[0])]
    bad, at, out = 0, 0, []
    for b in fed:
        n = b["tokens"].shape[0]
        mine, at = rows[at:at + n], at + n
        bad += n - len(mine) + sum(
            any(k not in b or not np.array_equal(m[k], b[k][r]) for k in m)
            for r, m in enumerate(mine))
        out.append({k: np.stack([m[k] for m in mine]) for k in mine[0]}
                   if len(mine) == n else dict(b))
    return out, bad


def reference_readings(cell, seed: int, dev, batches, mode: str = "f32",
                       fault=None) -> Dict:
    """The reference trained from the seed's weights on ``batches``."""
    specs = cell.family.leaf_specs(cell.config["model"])
    strict_f32()
    params = weights.draw_tree(specs, seed, dev)
    on_dev = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
              for b in batches]
    out = train_ref.train(
        cell.family, cell.config["model"], params, on_dev,
        cell.traffic["optim"], steps=len(batches), mode=mode, fault=fault,
        p0=lambda p: weights.draw_leaf(specs[p], seed, p, dev))
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _counted(ref: Dict) -> List:
    raw = ref["grad1_raw"]
    med_raw = statistics.median(raw.values())
    return [p for p, v in raw.items() if v >= 1e-3 * med_raw]


def leaf_gaps(a: Dict, b: Dict, counted: List) -> Dict:
    """Each counted leaf's gap of ``a`` from ``b``, against the larger of
    its reference norm and the median leaf's."""
    med = statistics.median(b[p] for p in counted)
    return {p: abs(a.get(p, 0.0) - b[p]) / max(b[p], med, 1e-30)
            for p in counted}


def explain(got: Dict, ref: Dict) -> Dict:
    """Where the compared numbers come from: each step's loss gap, and
    the three worst leaves and the median leaf of each norm's gaps."""
    counted = _counted(ref)
    out = {"loss_gaps": [abs(x - y) / abs(y)
                         for x, y in zip(got["loss"], ref["loss"])]}
    for k in ("grad1", "change"):
        g = leaf_gaps(got[k], ref[k], counted)
        worst = sorted(g.items(), key=lambda kv: -kv[1])[:3]
        out[k] = {"worst": [["/".join(p), v] for p, v in worst],
                  "median": statistics.median(g.values())}
    return out


def compare(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers ``correct`` can hold to limits: the widest relative
    gap of a step's loss (and of the first step's alone); of a leaf's
    first clipped gradient norm and of its change over the steps, each
    against the larger of that leaf's reference norm and the median
    leaf's, by the worst leaf (and the median leaf).  Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are not counted.  The cell's limits file names
    the numbers compared."""
    counted = _counted(ref)
    losses = [abs(x - y) / abs(y) for x, y in zip(got["loss"], ref["loss"])]
    out = {"loss_gap": max(losses), "loss1_gap": losses[0]}
    for k in ("grad1", "change"):
        g = leaf_gaps(got[k], ref[k], counted)
        out[k + "_gap"] = max(g.values())
        out[k + "_median_gap"] = statistics.median(g.values())
    return out


def _check(cell, seed, dev, fed, taken, got, rec) -> Dict[str, float]:
    batches, bad = rederive(cell, seed, fed, taken)
    rec.log(f"{sum(b['tokens'].shape[0] for b in fed)} delivered rows "
            f"re-derived, {bad} not the reference's")
    ref = reference_readings(cell, seed, dev,
                             batches[:cell.traffic["check_steps"]])
    rec.detail = {"loss": got["loss"], "ref_loss": ref["loss"],
                  **explain(got, ref)}
    out = compare(got, ref)
    out["rows_unmatched"] = float(bad)
    return out
