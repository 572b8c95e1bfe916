"""Each reference against the port's plain path (``use_kernels=False``,
on the CPU) at smoke sizes, on the same weights in float32: the forward's
logits, two AdamW steps, and served logits through the port's cache.
The test imports the port; the references do not."""
import math

import pytest
import torch

from perfbench import program, weights
from perfbench.reference import common, serve_ref, train_ref
from perfbench.tests import smoke

CELLS = ["yi-6b.train.carousel", "zamba2-1.2b.train.carousel"]
# the MoE reference against the port's mixtral at the smoke widths
# (capacity factor E / K, where the port drops nothing, as the reference)
FORWARD = CELLS + ["mixtral-8x7b.serve.tp4"]


def _setup(name, seed=3):
    cell = smoke.smoke_cell(name)
    prog = program.load()
    cfg = program.model_config(prog, cell.config)
    specs = {p: common.Leaf(l.shape, torch.float32, l.init, l.scale)
             for p, l in cell.family.leaf_specs(cell.config["model"]).items()}
    return cell, prog, cfg, specs


def _tokens(seed, B, S, V):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(2, V, (B, S), generator=g)


@pytest.mark.parametrize("name", FORWARD)
def test_forward_logits(name):
    cell, prog, cfg, specs = _setup(name)
    c, fam = cell.config["model"], cell.family
    params = weights.draw_tree(specs, 3, "cpu")
    tok = _tokens(1, 2, 40, c["vocab_size"])
    run = prog.RunConfig(use_kernels=False, remat="none")
    with torch.no_grad():
        h = prog.registry.forward(params, cfg, run, {"tokens": tok})
        want = h @ params["embed"]["lm_head"].t()
        got = serve_ref.logits_at(fam, c, params, [tok], [0])[0]
    err = (got - want).norm() / want.norm()
    assert err < 1e-5, err


@pytest.mark.parametrize("name", CELLS)
def test_two_adamw_steps(name):
    cell, prog, cfg, specs = _setup(name)
    c, fam, t = cell.config["model"], cell.family, cell.traffic
    opt = t["optim"]
    run = prog.RunConfig(use_kernels=False, remat="none", ce_dtype="float32",
                         learning_rate=opt["learning_rate"],
                         warmup_steps=opt["warmup_steps"],
                         total_steps=opt["total_steps"],
                         weight_decay=opt["weight_decay"],
                         max_grad_norm=opt["max_grad_norm"], ce_block_v=64)
    batches = []
    for i in range(2):
        tok = _tokens(10 + i, 2, 48, c["vocab_size"])
        mask = torch.ones(2, 48)
        mask[1, 30:] = 0
        batches.append({"tokens": tok, "labels": torch.roll(tok, -1, 1),
                        "loss_mask": mask})
    params = weights.draw_tree(specs, 3, "cpu")
    state = {"params": params, "opt": prog.adamw_init(params)}
    step = prog.make_train_step(cfg, run)
    losses, grad1 = [], {}
    for i, b in enumerate(batches):
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        if i == 0:
            grad1 = {p: float(m.norm()) / 0.1 for p, m in
                     common.flatten(state["opt"]["m"]).items()}
    ref_params = weights.draw_tree(specs, 3, "cpu")
    ref = train_ref.train(fam, c, ref_params, batches, opt, steps=2,
                          p0=lambda p: weights.draw_leaf(specs[p], 3, p,
                                                         "cpu"))
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for p, n in ref["grad1"].items():
        assert grad1[p] == pytest.approx(n, rel=1e-3, abs=1e-7), p
    for p in specs:
        a = common.get(state["params"], p)
        b = common.get(ref_params, p)
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6), p


@pytest.mark.parametrize("name", FORWARD)
def test_served_logits(name):
    cell, prog, cfg, specs = _setup(name)
    c, fam = cell.config["model"], cell.family
    params = weights.draw_tree(specs, 4, "cpu")
    run = prog.RunConfig(use_kernels=False)
    tok = _tokens(2, 2, 24, c["vocab_size"])
    cache = prog.engine.init_cache(cfg, 2, 32, device="cpu")
    with torch.no_grad():
        lg, cache = prog.registry.prefill(params, cfg, run, {"tokens": tok},
                                          cache)
        nxt = lg[:, -1].argmax(-1, keepdim=True)
        lg2, _ = prog.registry.decode(params, cfg, run, nxt, cache, 24)
        want = torch.cat([lg, lg2], dim=1)
        got = serve_ref.logits_at(fam, c, params,
                                  [torch.cat([tok, nxt], 1)], [23])[0]
    err = (got - want).norm() / want.norm()
    assert err < 2e-2, err  # the port's cache holds K / V in bf16
    gap = serve_ref.gaps(got[:, :1], nxt)
    assert math.isfinite(float(gap.max()))


def test_first_layer_v_as_the_cache_holds_it():
    cell, prog, cfg, specs = _setup("yi-6b.serve.longprompt")
    c, fam = cell.config["model"], cell.family
    params = weights.draw_tree(specs, 5, "cpu")
    run = prog.RunConfig(use_kernels=False)
    tok = _tokens(3, 2, 24, c["vocab_size"])
    cache = prog.engine.init_cache(cfg, 2, 32, device="cpu")
    with torch.no_grad():
        prog.registry.prefill(params, cfg, run, {"tokens": tok}, cache)
    held = prog.cache_read({n: x[0] for n, x in cache.items()})[1]
    want = fam.cache_v(c, params, tok)
    err = (held[:, :24].float() - want).norm() / want.norm()
    assert err < 4e-3, err  # one rounding to the cache's bf16
    assert not held[:, 24:].any()


def test_moe_top1_fault_moves_the_logits():
    """The reference's ``top1`` fault (each token's second expert
    dropped) lies far from its sound forward; its fp8 control nearer."""
    cell, prog, cfg, specs = _setup("mixtral-8x7b.serve.tp4")
    c, fam = cell.config["model"], cell.family
    params = weights.draw_tree(specs, 3, "cpu")
    tok = _tokens(1, 2, 40, c["vocab_size"])
    ref = serve_ref.logits_at(fam, c, params, [tok], [0])[0]
    top1 = serve_ref.logits_at(fam, c, params, [tok], [0], mode="top1")[0]
    assert float(serve_ref.rel_err(top1, ref).max()) > 0.2


def test_moe_route_is_the_ports():
    """The reference's router (softmax over the E logits, the top K
    renormalised) picks the port's experts with the port's weights."""
    from perfbench.reference import moe
    cell, prog, cfg, specs = _setup("mixtral-8x7b.serve.tp4")
    c = cell.config["model"]
    params = weights.draw_tree(specs, 6, "cpu")
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    h = torch.randn(3, 50, c["d_model"], generator=torch.Generator()
                    .manual_seed(2))
    r = prog.moe_route(p, cfg, h)
    e, w = moe.route(c, h.reshape(-1, c["d_model"]), p["router"], "f32")
    got = torch.sort(e, dim=-1)
    assert torch.equal(got.values, r.experts.reshape(-1, 2))
    assert torch.allclose(w.gather(-1, got.indices),
                          r.weights.reshape(-1, 2), atol=1e-6)
