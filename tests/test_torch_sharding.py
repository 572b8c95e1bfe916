"""The port's sharding rules (``repro_torch/sharding/rules.py``) against
the JAX package's, on the CPU, with no process group:

- every arch's logical tags (params and caches) equal the JAX defs';
- every leaf's spec equals ``repro.sharding.ShardingRules.spec`` at the
  abstract meshes (16, 16), (2, 16, 16), (4, 1), (1, 4), (2, 2), (1, 1)
  (the JAX side through ``tests/test_sharding.py``'s stub-mesh idiom);
- the nine cases of ``tests/test_sharding.py``, as parametrised cases;
- DTensor placements, this rank's blocks and rows, and the production
  meshes.
"""
import jax
import pytest

from repro.configs.base import get_config as j_get_config
from repro.models import params as JP
from repro.models import registry as jreg
from repro.sharding import ShardingRules as JRules
from repro_torch.configs.base import get_config, list_archs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import params as TP
from repro_torch.models import registry as treg
from repro_torch.models.params import pdef
from repro_torch.sharding import (ShardingRules, constrain, param_placements,
                                  param_specs, use_rules)

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
CACHE = (8, 4096)  # batch, max_len of the cache defs compared


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _jrules(jmesh, shape, axes):
    r = JRules(jmesh)
    r.mesh = type("M", (), {"shape": dict(zip(axes, shape))})()
    return r


def _trules(shape, axes):
    return ShardingRules(Mesh(shape, axes))


def _pairs(jdefs, tdefs):
    """(path, JAX def, port def) of every leaf of two def trees."""
    leaves = jax.tree_util.tree_leaves_with_path(jdefs, is_leaf=JP.is_def)
    assert len(leaves) == len(list(TP.tree_leaves(tdefs)))
    for path, jd in leaves:
        td = tdefs
        for k in path:
            td = td[k.key]
        yield jax.tree_util.keystr(path), jd, td


def _all_defs(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    yield jreg.param_defs(jcfg), treg.param_defs(tcfg)
    yield jreg.cache_defs(jcfg, *CACHE), treg.cache_defs(tcfg, *CACHE)


@pytest.mark.parametrize("arch", list_archs())
def test_logical_specs_match_jax(arch):
    for jdefs, tdefs in _all_defs(arch):
        for name, jd, td in _pairs(jdefs, tdefs):
            assert td.logical == tuple(jd.logical), (arch, name)
            assert td.shape == tuple(jd.shape), (arch, name)
        assert TP.logical_specs(tdefs) == jax.tree.map(
            tuple, JP.logical_specs(jdefs),
            is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_jax_at_each_mesh(jmesh, arch, mesh):
    jr, tr = _jrules(jmesh, *MESHES[mesh]), _trules(*MESHES[mesh])
    n = 0
    for jdefs, tdefs in _all_defs(arch):
        for name, jd, td in _pairs(jdefs, tdefs):
            want = tuple(jr.spec(jd.logical, jd.shape))
            assert tr.spec(td.logical, td.shape) == want, (arch, mesh, name)
            n += 1
        tspecs = param_specs(tdefs, tr)
        assert all(isinstance(s, tuple) for s in TP.tree_leaves(tspecs))
    assert n > 0


# tests/test_sharding.py's nine cases: (mesh shape, logical, shape, spec)
_DM = {"data": 16, "model": 16}
_PDM = {"pod": 2, "data": 16, "model": 16}
JAX_CASES = {
    "divisible_dims_shard":
        (_DM, ("embed", "ffn"), (4096, 11008), ("data", "model")),
    "non_divisible_heads_40": (_DM, ("heads",), (40,), (None,)),
    "non_divisible_heads_6": (_DM, ("heads",), (6,), (None,)),
    "batch_uses_pod_and_data":
        (_PDM, ("batch", None), (256, 128), (("pod", "data"), None)),
    "batch_prefix_fallback_1": (_PDM, ("batch",), (1,), (None,)),
    "batch_prefix_fallback_2": (_PDM, ("batch",), (2,), ("pod",)),
    "dedup_qwen3_expert_wins":
        (_DM, ("layers", "expert", "embed", "ffn"), (94, 128, 4096, 1536),
         (None, "model", "data", None)),
    "dedup_mixtral_ffn_gets_model":
        (_DM, ("layers", "expert", "embed", "ffn"), (32, 8, 4096, 14336),
         (None, None, "data", "model")),
    "kv_cache_kvseq_over_heads":
        (_DM, ("layers", "batch", "kv_seq", "heads", None),
         (38, 128, 32768, 32, 64), (None, "data", "model", None, None)),
    "vocab_fallback_odd_vocab":
        (_DM, ("vocab", "embed"), (50280, 768), (None, "data")),
    "vocab_divisible": (_DM, ("vocab", "embed"), (152064, 5120),
                        ("model", "data")),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_rules_cases_of_the_jax_suite(jmesh, case):
    shape, logical, dims, want = JAX_CASES[case]
    tr = _trules(tuple(shape.values()), tuple(shape))
    assert tr.spec(logical, dims) == want
    jr = _jrules(jmesh, tuple(shape.values()), tuple(shape))
    assert tuple(jr.spec(logical, dims)) == want


def test_param_specs_tree():
    r = _trules((16, 16), ("data", "model"))
    defs = {"w": pdef((4096, 1024), ("embed", "qkv")),
            "b": pdef((1024,), ("qkv",))}
    specs = param_specs(defs, r)
    assert specs["w"] == ("data", "model")
    assert specs["b"] == ("model",)


def test_constrain_noop_without_context():
    import torch
    x = torch.ones((4, 4))
    assert constrain(x, "batch", None) is x


def test_constrain_checks_local_rows():
    """Under rules and a batch split, an activation must hold the split's
    rows; other leading dims pass untouched."""
    import torch

    from repro_torch.sharding import batch_split
    x = torch.ones((2, 3))
    with use_rules(_trules((1, 1), ("data", "model"))):
        assert constrain(x, "batch", None) is x
        with batch_split(2, ("data",)):
            assert constrain(x, "batch", None) is x
            assert constrain(x, None, "batch") is x
        with batch_split(4, ("data",)), pytest.raises(ValueError):
            constrain(x, "batch", None)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    r = _trules((2, 16, 16), ("pod", "data", "model"))
    assert r.placements(("embed", "ffn"), (4096, 11008)) == \
        (Replicate(), Shard(0), Shard(1))
    # two axes on one dim: both mesh dims shard it, pod first
    assert r.placements(("batch", None), (256, 8)) == \
        (Shard(0), Shard(0), Replicate())
    assert r.placements(("heads",), (40,)) == (Replicate(),) * 3
    pl = param_placements({"w": pdef((64, 32), ("embed", "qkv"))},
                          _trules((2, 2), ("data", "model")))
    assert pl["w"] == (Shard(0), Shard(1))


class _Coords:
    """A mesh stub with this rank's coordinates (no process group)."""

    def __init__(self, shape, coords):
        self.shape = dict(shape)
        self._c = coords

    def coord(self, a):
        return self._c[a]


@pytest.mark.parametrize("data,model", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_local_shard_and_rows(data, model):
    import torch
    r = ShardingRules(_Coords({"data": 2, "model": 2},
                              {"data": data, "model": model}))
    full = torch.arange(8 * 6).reshape(8, 6)
    part = r.local_shard(full, ("embed", "ffn"), (8, 6))
    assert torch.equal(part, full[4 * data:4 * data + 4,
                                  3 * model:3 * model + 3])
    keep = r.local_shard(full, ("embed", "ffn"), (8, 6), keep=("model",))
    assert torch.equal(keep, full[:, 3 * model:3 * model + 3])
    # rows: a block of the batch; with microbatches a block of each
    assert r.rows(8).tolist() == list(range(4 * data, 4 * data + 4))
    assert r.rows(8, accum=2).tolist() == \
        [2 * data, 2 * data + 1, 4 + 2 * data, 4 + 2 * data + 1]
    # 3 rows do not split over data 2: every rank holds all of them
    assert r.rows(3).tolist() == [0, 1, 2]
    assert r.local_batch({"tokens": torch.arange(3)}) is None
    local, rows, axes = r.local_batch({"tokens": torch.arange(8) * 10},
                                      accum=2)
    assert (rows, axes) == (2, ("data",))
    assert local["tokens"].tolist() == [10 * i for i in r.rows(8, 2)]


def test_production_meshes_are_abstract():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.device_mesh is None
    mp = make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    # an abstract mesh stands for the rank at its coordinates (0 on every
    # axis by default) and has no process group
    assert [mp.coord(a) for a in mp.axis_names] == [0, 0, 0]
    with pytest.raises(RuntimeError, match="abstract"):
        mp.group("data")
    r = ShardingRules(mp)
    assert r.spec(("batch", "seq", "embed"), (256, 4096, 4096)) == \
        (("pod", "data"), None, None)
