"""Counting helpers of the frozen work formulas in ``perfbench/ops``:
plain Python over shapes, copied from the program's kernel wrappers so
that the benchmark owns what it charges each kernel."""
from __future__ import annotations

import functools
from typing import Optional, Tuple


@functools.lru_cache(maxsize=None)
def visible(Sq: int, Sk: int, causal: bool = True, q_offset: int = 0,
            kv_len: Optional[int] = None,
            sliding_window: int = 0) -> Tuple[int, int]:
    """(pairs, keys): the (query, key) pairs the masks leave visible, and
    the key rows at least one query sees.  Query i sits at position
    ``q_offset + i``; key j is visible when j < kv_len, j <= that position
    (causal) and j > that position - window (sliding window)."""
    kv_len = Sk if kv_len is None else int(kv_len)
    pairs = keys = 0
    top = -1
    for pos in range(int(q_offset), int(q_offset) + Sq):
        lo = max(pos - sliding_window + 1, 0) if sliding_window else 0
        hi = min(pos, kv_len - 1) if causal else kv_len - 1
        if hi < lo:
            continue
        pairs += hi - lo + 1
        keys += max(hi - max(lo, top + 1) + 1, 0)
        top = max(top, hi)
    return pairs, keys


def causal_pairs(S: int, chunk: int) -> int:
    """The causal (i, j) pairs inside the chunks of a sequence of S."""
    return sum(q * (q + 1) // 2 for q in
               [chunk] * (S // chunk) + ([S % chunk] if S % chunk else []))


def bound_s(flops: float, n_bytes: float, peaks: dict) -> float:
    """The least time the chip could take: the larger of the operations
    over the bf16 dense peak and the bytes over the HBM rate."""
    return max(flops / peaks["bf16_dense_flops_per_s"],
               n_bytes / peaks["hbm_bytes_per_s"])
