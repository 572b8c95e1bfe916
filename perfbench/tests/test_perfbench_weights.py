"""The weights: trees drawn whole draw bit for bit as they always have
(digests pinned at smoke size), and a tree drawn a layer at a time
(``draw_by_layer``) cut into the blocks of 4 model ranks by the port's
own ``local_shard`` (an abstract (1, 4) mesh at each coordinate, no
process group) puts back together into the one-rank draw, which is the
reference's layer by layer."""
import hashlib

import pytest
import torch

from perfbench import program, weights
from perfbench.reference import common
from perfbench.tests import smoke

SEED = 2147483659
DIGESTS = {  # sha256 of every leaf's bytes in path order, drawn on the CPU
    "yi-6b.serve.longprompt":
        "6bf855572bbd94e9f83be05302c723891cddb6d4d361b4e8771327199e07545e",
    "zamba2-1.2b.train.carousel":
        "842fe3a616b6b8c32ce425322564c63c636f2ea80129c61e5d4336ea21180913",
}


def _digest(tree) -> str:
    h = hashlib.sha256()
    for p, t in sorted(common.flatten(tree).items()):
        h.update(repr(p).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_whole_trees_draw_as_before(name):
    cell = smoke.smoke_cell(name)
    assert not cell.config.get("draw_by_layer")
    specs = cell.family.leaf_specs(cell.config["model"])
    assert _digest(weights.draw_tree(specs, SEED, "cpu")) == DIGESTS[name]


def _rules(prog, n, m):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import ShardingRules
    return ShardingRules(Mesh((1, n), ("data", "model"), coords=(0, m)))


def test_four_ranks_blocks_make_the_one_rank_draw():
    cell = smoke.smoke_cell("mixtral-8x7b.serve.tp4")
    assert cell.config["draw_by_layer"]
    c = cell.config["model"]
    specs = cell.family.leaf_specs(c)
    prog = program.load()
    cfg = program.model_config(prog, cell.config)
    one = program.Shards(prog, cfg, _rules(prog, 1, 0))
    whole = common.flatten(weights.draw_blocks(specs, SEED, "cpu", one,
                                               by_layer=True))
    ref = weights.reference_tree(specs, SEED, "cpu", True)
    parts = [common.flatten(weights.draw_blocks(
        specs, SEED, "cpu", program.Shards(prog, cfg, _rules(prog, 4, m)),
        by_layer=True)) for m in range(4)]
    cut = 0
    for p, t in whole.items():
        # the leaves drawn a layer at a time are those the port stacks
        assert weights.stacked(p) == (one.defs[p].logical[0] == "layers")
        # the one-rank draw is the reference's, layer by layer
        r = common.get(ref, p)
        if isinstance(r, weights.ByLayer):
            assert all(torch.equal(t[i], r[i]) for i in range(t.shape[0]))
        else:
            assert torch.equal(t, r)
        dims = [d for d in range(t.dim())
                if parts[0][p].shape[d] != t.shape[d]]
        if not dims:
            assert all(torch.equal(q[p], t) for q in parts), p
            continue
        cut += 1
        assert torch.equal(torch.cat([q[p] for q in parts], dims[0]), t), p
    # heads, experts and the vocab are split: wq wk wv wo, the three
    # expert leaves, the embedding and the head
    assert cut == 9
    # layer draws are not the whole leaf's draw
    leaf = specs[("blocks", "attn", "wq")]
    assert not torch.equal(weights.draw_leaf(leaf, SEED, ("blocks", "attn",
                                                          "wq"), "cpu"),
                           whole[("blocks", "attn", "wq")])
