"""The flash-attention forward (training's, which writes the f32 row
statistic ``lse``, and prefill's over a KV cache)."""
from __future__ import annotations

from typing import Optional, Tuple

from perfbench.workmath import visible


class FlashFwd:
    name = "flash_fwd"
    patterns = ("flash_fwd",)

    @staticmethod
    def work(*, B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
             causal: bool = True, q_offset: int = 0,
             kv_len: Optional[int] = None, sliding_window: int = 0,
             lse: bool = False, elem: int = 2) -> Tuple[float, int]:
        """(FLOPs, bytes): 4 FLOPs a visible (query, key) pair and head
        dimension (Q Kᵀ and P V); q read and o written once, K and V read
        once over the key rows some query sees, and with ``lse`` the f32
        statistic written."""
        pairs, keys = visible(Sq, Sk, causal, q_offset, kv_len,
                              sliding_window)
        n_bytes = (2 * B * Sq * Hq * D + 2 * B * keys * Hkv * D) * elem \
            + (4 * B * Sq * Hq if lse else 0)
        return 4.0 * B * Hq * pairs * D, n_bytes


OP = FlashFwd
