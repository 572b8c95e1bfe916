"""The benchmark's inputs, made from ``--seed``: the training corpus
(shards of documents whose lengths are geometric and whose tokens follow
a Zipf law over the vocabulary, ids 0 and 1 kept for padding and end of
document; the generator the program's ``data/synthetic.py`` uses, copied
here so that the benchmark owns it) and the serving prompts (ids uniform
over the vocabulary but the two reserved, lengths in the mix's order)."""
from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np


def mix(seed: int, *parts) -> int:
    """A 63-bit seed for one named draw of run ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tuple(parts)).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def shard_docs(seed: int, shard: int, n_docs: int, vocab: int,
               mean_len: int) -> List[np.ndarray]:
    """The documents of one corpus shard (int32 arrays)."""
    rng = np.random.default_rng(mix(seed, "shard", shard))
    lens = np.maximum(8, rng.geometric(1.0 / mean_len, n_docs))
    ranks = np.arange(2, vocab)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return [rng.choice(ranks, size=int(n), p=probs).astype(np.int32)
            for n in lens]


def prompt_order(lens: List[int], n: int) -> List[int]:
    """The prompt length of each of ``n`` batches: the mix's lengths in
    its own order, round after round.  The order is the same for every
    seed, so that every window of a given length serves the same work
    (the seed draws the prompts' ids)."""
    return [lens[i % len(lens)] for i in range(n)]


def prompt_tokens(seed: int, batch: int, rows: int, length: int,
                  vocab: int, device) -> "torch.Tensor":  # noqa: F821
    """The (rows, length) prompt ids of batch ``batch``, drawn on
    ``device``."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, "prompt", batch))
    return torch.randint(2, vocab, (rows, length), generator=g,
                         device=device)


def sample(seed: int, items: List, k: int, keep: List) -> Tuple[List, ...]:
    """``keep`` (up to ``k``) plus a seeded draw from the other ``items``,
    ``k`` in all."""
    rng = np.random.default_rng(mix(seed, "sample"))
    rest = [x for x in items if x not in keep]
    take = max(0, min(k - len(keep), len(rest)))
    idx = rng.choice(len(rest), size=take, replace=False) if take else []
    return list(keep[:k]) + [rest[i] for i in sorted(idx)]
