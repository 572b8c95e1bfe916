"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have (one chip: no exchange to leave
out), at smoke size on the CPU past the harness's look for a chip,
against the cells' own limits; each fault reads above the sound run on
a number compared.  The fp8 control, at the same size, reads above the
sound run on every number compared (and, in training, fails a limit)."""
import pytest
import torch

from perfbench import bench, harness
from perfbench.reference import train_ref
from perfbench.tests import smoke

TRAIN = ["yi-6b.train.carousel", "zamba2-1.2b.train.carousel"]


def _state_unchanged(monkeypatch):
    import repro_torch.train.step as step

    def frozen(params, grads, state, **kw):
        return params, state, {"grad_norm": torch.zeros(()), "lr": 0.0}
    monkeypatch.setattr(step, "adamw_update", frozen)


def _half_batch(monkeypatch):
    import repro_torch.train.step as step
    real = step.lm_loss
    monkeypatch.setattr(step, "lm_loss", lambda params, cfg, run, batch:
                        real(params, cfg, run, train_ref.halve(batch)))


def _delivery_changed(monkeypatch, change):
    """The delivery's batches from the third on (the window's first)
    changed by ``change(batches)``."""
    import repro_torch.carousel.delivery as delivery
    real = delivery.DeliveryIterator.__iter__

    def changed(self):
        it = real(self)
        head = [next(it), next(it)]
        yield from head
        yield from change(head, it)
    monkeypatch.setattr(delivery.DeliveryIterator, "__iter__", changed)


def _batch_repeated(monkeypatch):
    def repeat(head, it):
        yield head[-1]
        yield from it
    _delivery_changed(monkeypatch, repeat)


def _batch_dropped(monkeypatch):
    def drop(head, it):
        next(it)
        yield from it
    _delivery_changed(monkeypatch, drop)


def _token_altered(monkeypatch):
    """Each decode's logits shifted one id up, so the token it chooses
    is the next id."""
    import repro_torch.models.registry as registry
    real = registry.decode

    def altered(*args):
        logits, cache = real(*args)
        return torch.roll(logits, 1, dims=-1), cache
    monkeypatch.setattr(registry, "decode", altered)


def _first_token_altered(monkeypatch):
    import repro_torch.models.registry as registry
    real = registry.prefill

    def altered(*args):
        logits, cache = real(*args)
        return torch.roll(logits, 3, dims=-1), cache
    monkeypatch.setattr(registry, "prefill", altered)


FAULTS = [(n, f) for n in TRAIN for f in (
    _state_unchanged, _half_batch, _batch_repeated, _batch_dropped)] \
    + [("yi-6b.serve.longprompt", f)
       for f in (_token_altered, _first_token_altered)]


_SOUND = {}


def sound(name):
    if name not in _SOUND:
        _SOUND[name] = smoke.run(smoke.smoke_cell(name))
    return _SOUND[name]


@pytest.mark.parametrize("name", TRAIN + ["yi-6b.serve.longprompt"])
def test_sound_run_names_every_number_last(name):
    res = sound(name)
    assert list(res)[-1] == "check"
    assert set(res["check"]) == set(smoke.smoke_cell(name).limits["limits"])
    assert all(c["value"] is not None for c in res["check"].values())


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    ok = sound(name)["check"]
    fault(monkeypatch)
    res = smoke.run(smoke.smoke_cell(name))
    assert not res["correct"], res["check"]
    assert any(c["value"] > ok[k]["value"] and c["value"] > c["limit"]
               for k, c in res["check"].items()), (res["check"], ok)


@pytest.mark.parametrize("name", TRAIN)
def test_fp8_control_fails_a_limit(name):
    from perfbench import control
    cell = smoke.smoke_cell(name)
    ok = sound(name)["check"]
    got = control.train_control(cell, 7, torch.device("cpu"))["fp8"]
    limits = cell.limits["limits"]
    compared = [k for k in limits if k != "rows_unmatched"]
    assert any(got[k] > limits[k] for k in compared), got
    assert all(got[k] > ok[k]["value"] for k in compared), (got, ok)


def _serve_check(**kw):
    from perfbench import program
    cell = smoke.smoke_cell("yi-6b.serve.longprompt")
    rec = harness.run_cell(cell, program.load(), torch.device("cpu"),
                           seed=7, seconds=0.5, trace=False, t_start=0.0,
                           **kw)
    return cell, rec.check


def test_serve_control_reads_above_the_sound_run():
    """At smoke width the fp8 reference's logits lie well farther from
    the f32 reference's than the bf16 program's (at full width they fail
    both logit limits: the readings in the cell's limits file)."""
    cell, got = _serve_check(control="fp8")
    assert got["control_err"] > 3 * got["logit_err"]
    assert got["control_gap"] > 3 * got["logit_gap"]
    limits, readings = cell.limits["limits"], cell.limits["readings"]
    for k in ("logit_err", "logit_gap"):
        assert min(readings[k]["fp8"]) > limits[k]


def test_int8_cache_control_reads_above_the_sound_run():
    """The program's own int8 KV cache, the control, holds the first
    layer's V farther from the reference than its bf16 cache does (at
    full width it fails ``cache_err``'s limit)."""
    _, ok = _serve_check()
    cell, got = _serve_check(kv_cache_dtype="int8")
    assert got["cache_err"] > 2 * ok["cache_err"]
    r = cell.limits["readings"]["cache_err"]
    assert min(r["program_int8_kv_cache"]) > cell.limits["limits"][
        "cache_err"] > max(r["program_values"])


def test_four_card_cell_control_and_fault_readings_fail_a_limit():
    """The four-card MoE cell's limits lie above every sound reading and
    below the fp8 control's and the top-1 routing fault's smallest reading
    on at least one number each (the readings on the cards: its limits
    file)."""
    cell = bench.cell("mixtral-8x7b.serve.tp4")
    limits, readings = cell.limits["limits"], cell.limits["readings"]
    for k, lim in limits.items():
        assert max(readings[k]["program_values"]) < lim
    for source in ("fp8", "top1"):
        assert any(min(r[source]) > limits[k]
                   for k, r in readings.items() if r.get(source)), source
