"""The port's encoder-decoder (whisper-tiny) and VLM (llava-next-mistral-7b)
families against the JAX reference, on the CPU, at their smoke configs.

The same numpy inputs (tokens, whisper's frames, llava's patch
embeddings) and the same weights, carried over with ``from_jax_params``,
go through ``repro.models.registry`` and through the port's plain paths,
which are what the port runs on CPU tensors:

- the param trees (keys, shapes, dtypes) and ``synth_inputs``' modality
  inputs;
- ``forward``'s final hidden states, ``prefill``'s logits and three
  ``decode`` steps' logits, in f32 and bf16 (whisper's decode reads the
  cross cache that prefill filled; llava's positions count its patches);
- ``lm_loss`` and its gradients against the JAX ``grads_and_metrics``,
  then one ``train_step`` against ``jax.jit(make_train_step)`` (called
  outside ``use_rules``: the JAX launch code fails on jax 0.9, ROADMAP C1),
  in f32;
- whisper's remat ("full", "dots": both checkpoint each block whole, as
  the JAX package's ``jax.checkpoint`` does) against "none";
- ``run_serving`` and ``run_training`` on the CPU, synthetic and
  carousel-fed;
- a checkpoint of whisper's state, two stacks of blocks, through the
  port's save and load and the JAX package's load.

Tolerances, with their reasons:

- forward, prefill and decode: those of tests/test_torch_serving_archs.py,
  2e-3 in f32 (sums in another order over a few layers) and 3e-2 in bf16
  (bf16 matmul outputs round at other places in the two frameworks);
- gradients and the train step: those of tests/test_torch_training.py's
  f32 step test: the loss at rtol 1e-4, gradients at relative L2 1e-4,
  params after AdamW at rtol 1e-5 plus 2 lr (AdamW's first step turns a
  gradient near zero whose sign differs into about +-lr).  whisper's key
  biases (``bk``) add the same q . b to every key a query sees, which the
  softmax drops: their gradients are zero but for rounding in both
  packages, so they are held below 1e-6 in absolute terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import load_checkpoint as j_load
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_smoke_config as j_smoke
from repro.models import params as JP
from repro.models import registry as jreg
from repro.optim import adamw_init as j_adamw_init
from repro.serve import engine as jengine
from repro.train.step import grads_and_metrics as j_grads
from repro.train.step import init_state as j_init_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs.base import RunConfig, ShapeConfig, get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import params as TP
from repro_torch.models import registry as treg
from repro_torch.optim import adamw_init
from repro_torch.serve import engine as tengine
from repro_torch.train import step as tstep

ARCHS = ["whisper-tiny", "llava-next-mistral-7b"]
B, S, N_DECODE = 2, 12, 3
TOL = {"float32": 2e-3, "bfloat16": 3e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_params():
    return {arch: JP.materialize(jax.random.PRNGKey(0),
                                 jreg.param_defs(j_smoke(arch)))
            for arch in ARCHS}


def _both_params(jax_params, arch, dtype):
    jp = JP.cast_tree(jax_params[arch], getattr(jnp, dtype))
    return jp, TP.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _modality(cfg, rng, dtype):
    """Whisper's frames or llava's patches, normal times 0.02 rounded to
    bf16 (as ``synth_inputs`` makes them), in ``dtype`` for both
    packages."""
    name, n = treg.modality_input(cfg)
    x = (rng.standard_normal((B, n, cfg.d_model)) * 0.02).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16).to(getattr(torch, dtype))
    return {name: (jnp.asarray(_np(t), getattr(jnp, dtype)), t)}


def _inputs(cfg, seed, dtype, train=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    both = {"tokens": (jnp.asarray(toks), torch.from_numpy(toks).long())}
    if train:
        labels = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        mask = (rng.random((B, S)) > 0.2).astype(np.float32)
        both["labels"] = (jnp.asarray(labels),
                          torch.from_numpy(labels).long())
        both["loss_mask"] = (jnp.asarray(mask), torch.from_numpy(mask))
    both.update(_modality(cfg, rng, dtype))
    return ({k: v[0] for k, v in both.items()},
            {k: v[1] for k, v in both.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(jax_params, arch):
    jl = jax.tree_util.tree_leaves_with_path(jax_params[arch])
    tl = treg.param_defs(get_smoke_config(arch))
    for path, a in jl:
        d = tl
        for k in path:
            d = d[k.key]
        assert d.shape == a.shape, path
        assert str(d.dtype)[6:] == jnp.dtype(a.dtype).name, path
    assert len(list(TP.tree_leaves(tl))) == len(jl)
    stacks = treg.layer_stacks(get_smoke_config(arch))
    for name, n in stacks.items():
        assert all(d.shape[0] == n for d in TP.tree_leaves(tl[name]))


@pytest.mark.parametrize("arch", ARCHS)
def test_synth_inputs_carry_the_modality_inputs(arch):
    cfg = get_smoke_config(arch)
    jcfg = j_smoke(arch)
    for kind in ("prefill", "train"):
        shape = ShapeConfig("t", S, B, kind)
        got = treg.synth_inputs(torch.Generator().manual_seed(0), cfg, shape,
                                device="cpu")
        want = jreg.synth_inputs(jax.random.PRNGKey(0), jcfg,
                                 JShapeConfig("t", S, B, kind))
        assert set(got) == set(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, k
        x = got[treg.modality_input(cfg)[0]]
        assert x.dtype == torch.bfloat16
        assert 0.01 < float(x.float().std()) < 0.03


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(jax_params, arch, dtype):
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    jrun, run = JRunConfig(), RunConfig()
    jp, tp = _both_params(jax_params, arch, dtype)
    jb, tb = _inputs(cfg, 5, dtype)
    tol = TOL[dtype]
    with torch.no_grad():
        th = treg.forward(tp, cfg, run, tb)
    jh = jreg.forward(jp, jcfg, jrun, jb)
    assert tuple(th.shape) == jh.shape
    np.testing.assert_allclose(_np(th), _np(jh), rtol=tol, atol=tol,
                               err_msg="forward")

    extra = cfg.num_img_patches if cfg.family == "vlm" else 0
    max_len = S + extra + N_DECODE + 4
    rng = np.random.default_rng(6)
    steps = rng.integers(0, cfg.vocab_size, (N_DECODE, B, 1), dtype=np.int32)
    jcache = jengine.init_cache(jcfg, B, max_len)
    jlog, jcache = jreg.prefill(jp, jcfg, jrun, jb, jcache)
    tcache = tengine.init_cache(cfg, B, max_len, device="cpu")
    with torch.no_grad():
        tlog, tcache = treg.prefill(tp, cfg, run, tb, tcache)
    assert tuple(tlog.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=tol, atol=tol,
                               err_msg="prefill")
    for i in range(N_DECODE):
        pos = S + extra + i
        jlog, jcache = jreg.decode(jp, jcfg, jrun, jnp.asarray(steps[i]),
                                   jcache, jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            tlog, tcache = treg.decode(tp, cfg, run,
                                       torch.from_numpy(steps[i]).long(),
                                       tcache, pos)
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
    if cfg.family == "encdec":  # the cross cache: filled once, then read
        for k in ("k", "v"):
            np.testing.assert_allclose(
                _np(tcache["cross"][k]), _np(jcache["cross"][k]),
                rtol=max(tol, 2.0 ** -7), atol=max(tol, 2.0 ** -7))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_train_step_match_jax(jax_params, arch):
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    run = ttrain.default_run_config(cfg, 3)
    jrun = JRunConfig(total_steps=run.total_steps,
                      warmup_steps=run.warmup_steps,
                      ce_block_v=run.ce_block_v)
    jp, tp = _both_params(jax_params, arch, "float32")
    jb, tb = _inputs(cfg, 7, "float32", train=True)
    jg, jm = jax.jit(lambda p, b: j_grads(p, jcfg, jrun, b))(jp, jb)
    tg, tm = tstep.grads_and_metrics(tp, cfg, run, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    n = 0
    for path, a in jax.tree_util.tree_leaves_with_path(jg):
        t = tg
        for k in path:
            t = t[k.key]
        name = jax.tree_util.keystr(path)
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, name
        if name.endswith("['bk']"):
            # zero but for rounding in both: see the module notes
            assert max(np.abs(_np(t)).max(), np.abs(_np(a)).max()) < 1e-6
        else:
            assert _rel_l2(t, a) <= 1e-4, (name, _rel_l2(t, a))
        n += 1
    assert n == len(list(TP.tree_leaves(tg)))

    jstate, jmet = jax.jit(j_make_train_step(jcfg, jrun))(
        {"params": jp, "opt": j_adamw_init(jp)}, jb)
    tstate, tmet = tstep.make_train_step(cfg, run)(
        {"params": tp, "opt": adamw_init(tp)}, tb)
    assert tstate["params"] is tp  # updated in place
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    for path, a in jax.tree_util.tree_leaves_with_path(jstate["params"]):
        t = tstate["params"]
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(_np(t), _np(a), rtol=1e-5,
                                   atol=2 * tmet["lr"],
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_whisper_remat_gives_the_grads_of_none(jax_params, remat):
    cfg = get_smoke_config("whisper-tiny")
    _, tp = _both_params(jax_params, "whisper-tiny", "float32")
    _, tb = _inputs(cfg, 8, "float32", train=True)
    run = ttrain.default_run_config(cfg, 3)
    gn, mn = tstep.grads_and_metrics(tp, cfg, run.replace(remat="none"), tb)
    gr, mr = tstep.grads_and_metrics(tp, cfg, run.replace(remat=remat), tb)
    assert float(mr["loss"]) == float(mn["loss"])
    for a, b in zip(TP.tree_leaves(gr), TP.tree_leaves(gn)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serving_and_training_on_cpu(arch):
    res = tserve.run_serving(arch, smoke=True, prompt_len=8, gen=3, batch=2,
                             device="cpu")
    assert res["generated"] == (2, 3)
    tok = res["tokens"]
    assert bool(((tok >= 0) & (tok < 256)).all())
    for carousel in (False, True):
        res = ttrain.run_training(arch, smoke=True, steps=2, seq_len=16,
                                  global_batch=2, carousel=carousel,
                                  device="cpu")
        assert res["steps"] == 2 and all(np.isfinite(res["losses"]))


def test_carousel_batches_carry_zero_modality_inputs():
    for arch, name in (("whisper-tiny", "frames"),
                       ("llava-next-mistral-7b", "img_embeds")):
        cfg = get_smoke_config(arch)
        extra = ttrain._modality_extras(cfg, 3, torch.device("cpu"))
        n = cfg.encoder_frames if name == "frames" else cfg.num_img_patches
        assert set(extra) == {name}
        x = extra[name]
        assert tuple(x.shape) == (3, n, cfg.d_model)
        assert x.dtype == torch.bfloat16 and not bool(x.any())
    assert ttrain._modality_extras(get_smoke_config("yi-6b"), 3,
                                   torch.device("cpu")) == {}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def test_whisper_checkpoint_round_trip(tmp_path):
    """whisper's state (two stacks of blocks) saved by the port loads bit
    for bit in the port and in the JAX package, with the JAX tree's
    paths."""
    cfg = get_smoke_config("whisper-tiny")
    run = ttrain.default_run_config(cfg, 3)
    state = tstep.init_state(torch.Generator().manual_seed(0), cfg, run)
    tb = treg.synth_inputs(torch.Generator().manual_seed(1), cfg,
                           ShapeConfig("t", S, B, "train"), device="cpu")
    state, _ = tstep.make_train_step(cfg, run)(state, tb)
    save_checkpoint(str(tmp_path), state, 1, meta={"arch": "whisper-tiny"})
    got, meta = load_checkpoint(str(tmp_path))
    assert meta == {"arch": "whisper-tiny", "step": 1}
    for a, b in zip(TP.tree_leaves(got["params"]),
                    TP.tree_leaves(state["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jgot, _ = j_load(str(tmp_path))
    jwant = j_init_state(jax.random.PRNGKey(0), j_smoke("whisper-tiny"),
                         JRunConfig())
    assert ([p for p, _ in jax.tree_util.tree_leaves_with_path(jgot)]
            == [p for p, _ in jax.tree_util.tree_leaves_with_path(jwant)])
    for path, a in jax.tree_util.tree_leaves_with_path(jgot["params"]):
        t = state["params"]
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(_bits(a), _bits(t))
