"""Synthetic tokenized corpus, the twin of ``repro/data/synthetic.py``:
shards of variable-length documents with a Zipf-ish token distribution,
registered as ColdStore TapeFiles with *lazy* generators, so a corpus
costs nothing until staged.  numpy, seeded: one seed gives the JAX
package's documents bit for bit.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.carousel.storage import ColdStore, TapeFile


def synth_docs(seed: int, n_docs: int, vocab_size: int,
               mean_len: int = 512) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    lens = np.maximum(8, rng.geometric(1.0 / mean_len, n_docs))
    # Zipf-ish unigram distribution over the vocab (reserve 0=pad, 1=eod)
    ranks = np.arange(2, vocab_size)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return [rng.choice(ranks, size=int(l), p=probs).astype(np.int32)
            for l in lens]


def build_cold_store(
    *,
    n_shards: int,
    docs_per_shard: int = 32,
    vocab_size: int = 256,
    mean_doc_len: int = 256,
    shard_bytes: Optional[int] = None,
    drives: int = 2,
    mount_latency: float = 0.0,
    bandwidth: float = float("inf"),
    fault_rate: float = 0.0,
    seed: int = 0,
) -> ColdStore:
    cold = ColdStore(drives=drives, mount_latency=mount_latency,
                     bandwidth=bandwidth, fault_rate=fault_rate, seed=seed)
    approx = docs_per_shard * mean_doc_len * 4
    for s in range(n_shards):
        cold.add(TapeFile(
            name=f"shard-{s:05d}",
            size=shard_bytes if shard_bytes is not None else approx,
            generator=(lambda s=s: synth_docs(
                seed * 100_003 + s, docs_per_shard, vocab_size,
                mean_doc_len)),
        ))
    return cold
