"""The span recorder (``repro_torch.core.obs``) on the port's compute path.

Off, ``span()`` is one shared null context and a step registers no hook;
on, a train step, a prefill and a decode of a dense and a hybrid smoke
model record the tree of spans the benchmark reads beside the device
trace, every child inside its parent, with the same numbers as off; the
spans' clock is the profiler's (kineto's epoch ns).  The ``cuda`` cases
run on a card: a span encloses its kernel's launch and precedes the
kernel on the device, and the spans of the backward, which autograd runs
on its device thread there, lie under ``train.backward``.
"""
import threading

import pytest
import torch

from repro_torch.configs.base import RunConfig, ShapeConfig, get_smoke_config
from repro_torch.core import obs
from repro_torch.models import params as P
from repro_torch.models import registry
from repro_torch.serve import engine
from repro_torch.train import step as tstep

ARCHS = {"yi-6b": "block.decoder", "zamba2-1.2b": "block.mamba2"}
B, S = 2, 64


@pytest.fixture(autouse=True)
def _recorder_off():
    obs.stop()
    yield
    obs.stop()


def _state_and_batch(arch, device="cpu"):
    cfg = get_smoke_config(arch)
    run = RunConfig(ce_block_v=64)
    g = torch.Generator(device=device).manual_seed(3)
    state = tstep.init_state(g, cfg, run)
    batch = registry.synth_inputs(g, cfg, ShapeConfig("t", S, B, "train"),
                                  device=device)
    return cfg, run, state, batch


def _clone(state):
    return {"params": P.tree_map(torch.clone, state["params"]),
            "opt": {"m": P.tree_map(torch.clone, state["opt"]["m"]),
                    "v": P.tree_map(torch.clone, state["opt"]["v"]),
                    "step": state["opt"]["step"]}}


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _ancestors(s, ids):
    out = []
    while s["parent"] is not None:
        s = ids[s["parent"]]
        out.append(s["name"])
    return out


def _check_nesting(spans):
    ids = _by_id(spans)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"], s
        if s["parent"] is None:
            assert s["root"] == s["id"]
            continue
        p = ids[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"], \
            (s, p)
        assert s["root"] == p["root"]


def test_off_is_one_shared_null_and_records_nothing(monkeypatch):
    assert obs.span("train.step") is obs.NULL
    assert obs.span("block.decoder") is obs.span("serve.decode")
    hooks = []
    real = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda t, h: hooks.append(h) or real(t, h))
    cfg, run, state, batch = _state_and_batch("yi-6b")
    tstep.train_step(state, batch, cfg=cfg, run=run)
    assert hooks == [] and obs.stop() == []
    obs.start()
    tstep.train_step(state, batch, cfg=cfg, run=run)
    assert hooks and obs.stop()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_span_tree(arch):
    block = ARCHS[arch]
    cfg, run, state, batch = _state_and_batch(arch)
    obs.start()
    tstep.train_step(state, batch, cfg=cfg, run=run)
    spans = obs.stop()
    _check_nesting(spans)
    ids = _by_id(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["train.step"]
    step = roots[0]
    kids = [s["name"] for s in spans if s["parent"] == step["id"]]
    assert kids == ["train.forward", "train.backward", "train.optimizer"]
    names = [s["name"] for s in spans]
    n = cfg.num_layers
    fwd = [s for s in spans if s["name"] == block
           and "train.forward" in _ancestors(s, ids)]
    bwd = [s for s in spans if s["name"] == block + ".bwd"]
    assert len(fwd) == n and len(bwd) == n
    for s in bwd:
        assert _ancestors(s, ids)[0] == "train.backward"
    # remat "full": each block runs again inside its backward
    rec = [s for s in spans if s["name"] == block
           and ids[s["parent"]]["name"] == block + ".bwd"]
    assert len(rec) == n
    ce = [s for s in spans if s["name"] == "loss.ce_bwd"]
    assert len(ce) == 1 and ids[ce[0]["parent"]]["name"] == "train.backward"
    assert ce[0]["end_ns"] <= min(s["start_ns"] for s in bwd)
    clip = [s for s in spans if s["name"] == "train.clip"]
    assert len(clip) == 1
    assert ids[clip[0]["parent"]]["name"] == "train.optimizer"
    # the shared block is not checkpointed: its attention runs once
    assert names.count("attention") == (
        2 * n if arch == "yi-6b" else n // cfg.attn_every)
    if arch == "zamba2-1.2b":
        apps = n // cfg.attn_every
        assert names.count("block.shared") == apps
        assert names.count("block.shared.bwd") == apps
    main = threading.get_native_id()
    assert {s["tid"] for s in spans} == {main}  # CPU: one thread


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_spans(arch):
    block = ARCHS[arch]
    cfg, run, state, batch = _state_and_batch(arch)
    params = state["params"]
    cache = engine.init_cache(cfg, B, S + 4, device="cpu")
    obs.start()
    with torch.inference_mode():
        logits, cache = registry.prefill(params, cfg, run,
                                         {"tokens": batch["tokens"]}, cache)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        registry.decode(params, cfg, run, tok, cache, S)
    spans = obs.stop()
    _check_nesting(spans)
    ids = _by_id(spans)
    roots = [s["name"] for s in spans if s["parent"] is None]
    assert roots == ["serve.prefill", "serve.decode"]
    for root in roots:
        blocks = [s for s in spans if s["name"] == block
                  and ids[s["parent"]]["name"] == root]
        assert len(blocks) == cfg.num_layers
    assert not any(s["name"].endswith(".bwd") for s in spans)
    attn = [s for s in spans if s["name"] == "attention"]
    assert attn and all(
        ids[s["parent"]]["name"] in ("block.decoder", "block.shared")
        for s in attn)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_params_bit_equal_on_and_off(arch):
    cfg, run, state, batch = _state_and_batch(arch)
    other = _clone(state)
    _, m_off = tstep.train_step(state, batch, cfg=cfg, run=run)
    obs.start()
    _, m_on = tstep.train_step(other, batch, cfg=cfg, run=run)
    assert obs.stop()
    assert torch.equal(m_off["loss"], m_on["loss"])
    assert torch.equal(m_off["grad_norm"], m_on["grad_norm"])
    for a, b in zip(P.tree_leaves(state), P.tree_leaves(other)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_delivery_next_and_device_put_spans():
    from repro_torch.carousel.delivery import device_put

    class Landed:
        """A stager and cache whose shards have all landed."""
        shards = {f"s{i}": {"tokens": torch.arange(12).reshape(3, 4).numpy()}
                  for i in range(2)}

        def __contains__(self, n):
            return n in self.shards

        def get(self, n):
            return self.shards[n]

        def pin(self, n):
            pass

        def release(self, n, drop=False):
            pass

        def hedge_check(self):
            pass

    from repro_torch.carousel.delivery import DeliveryIterator
    feed = DeliveryIterator(Landed(), Landed(), ["s0", "s1"], batch_rows=2,
                            prefetch=1)
    obs.start()
    got = [device_put(b, torch.device("cpu")) for b in feed]
    spans = obs.stop()
    assert sum(g["tokens"].shape[0] for g in got) == 6
    names = [s["name"] for s in spans]
    assert names.count("delivery.device_put") == len(got)
    # one span a resumption: every batch, and the one that ends the run
    assert names.count("delivery.next") == len(got) + 1
    assert all(s["parent"] is None for s in spans)


def test_span_encloses_the_profilers_host_event():
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        obs.start()
        with obs.span("mm"):
            torch.mm(x, x)
        spans = obs.stop()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1 and len(spans) == 1
    s, e = spans[0], mm[0]
    assert s["start_ns"] <= e.start_ns()
    assert e.start_ns() + e.duration_ns() <= s["end_ns"]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _launches(prof):
    """The kineto runtime / driver events that launched a device op."""
    evs = list(prof.profiler.kineto_results.events())
    dev = {e.correlation_id() for e in evs
           if str(e.device_type()).endswith("CUDA")}
    return evs, [e for e in evs if not str(e.device_type()).endswith("CUDA")
                 and e.name().startswith(("cuda", "cu"))
                 and e.correlation_id() in dev]


@pytest.mark.cuda
def test_cuda_span_encloses_launch_and_precedes_kernel():
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(1024, 1024, device="cuda")
    torch.mm(x, x)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        obs.start()
        with obs.span("mm"):
            torch.mm(x, x)
            torch.cuda.synchronize()
        spans = obs.stop()
    evs, launches = _launches(prof)
    kernels = {e.correlation_id(): e for e in evs
               if str(e.device_type()).endswith("CUDA")}
    assert launches
    s = spans[0]
    for ln in launches:
        k = kernels[ln.correlation_id()]
        assert s["start_ns"] <= ln.start_ns()
        assert ln.start_ns() + ln.duration_ns() <= s["end_ns"]
        assert s["start_ns"] <= ln.start_ns() <= k.start_ns()
        assert k.start_ns() + k.duration_ns() <= s["end_ns"]


@pytest.mark.cuda
def test_cuda_backward_thread_spans_lie_under_train_backward():
    """On CUDA, autograd runs the backward on its device thread: its spans
    take ``train.backward`` as their parent, and its launches come from
    another profiler thread than the forward's (the trace numbers threads
    its own way: the benchmark's join maps them by the spans that hold
    their launches)."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile
    cfg, run, state, batch = _state_and_batch("yi-6b", device="cuda")
    tstep.train_step(state, batch, cfg=cfg, run=run)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        obs.start()
        tstep.train_step(state, batch, cfg=cfg, run=run)
        torch.cuda.synchronize()
        spans = obs.stop()
    _check_nesting(spans)
    main = threading.get_native_id()
    back = next(s for s in spans if s["name"] == "train.backward")
    ce = next(s for s in spans if s["name"] == "loss.ce_bwd")
    assert ce["tid"] != main and ce["parent"] == back["id"]
    bwd = [s for s in spans if s["name"] == "block.decoder.bwd"]
    assert len(bwd) == cfg.num_layers
    assert all(s["parent"] == back["id"] and s["tid"] == ce["tid"]
               for s in bwd)
    _, launches = _launches(prof)

    def threads_in(s):
        return {e.start_thread_id() for e in launches
                if s["start_ns"] <= e.start_ns() < s["end_ns"]}
    fwd = next(s for s in spans if s["name"] == "train.forward")
    assert threads_in(ce) and threads_in(fwd)
    assert threads_in(ce).isdisjoint(threads_in(fwd))
