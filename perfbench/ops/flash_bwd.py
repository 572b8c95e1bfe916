"""The flash-attention backward (delta, dK / dV and dQ launches)."""
from __future__ import annotations

from typing import Optional, Tuple

from perfbench.workmath import visible


class FlashBwd:
    name = "flash_bwd"
    patterns = ("flash_bwd",)

    @staticmethod
    def work(*, B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
             causal: bool = True, q_offset: int = 0,
             kv_len: Optional[int] = None, sliding_window: int = 0,
             elem: int = 2) -> Tuple[float, int]:
        """(FLOPs, bytes): 10 FLOPs a visible pair and head dimension (Q
        Kᵀ again, dP, dV, dQ, dK); q, o, dout read and dq written, K, V
        read and dk, dv written over the key rows some query sees, and the
        f32 ``lse`` read once."""
        pairs, keys = visible(Sq, Sk, causal, q_offset, kv_len,
                              sliding_window)
        n_bytes = (4 * B * Sq * Hq * D + 4 * B * keys * Hkv * D) * elem \
            + 4 * B * Sq * Hq
        return 10.0 * B * Hq * pairs * D, n_bytes


OP = FlashBwd
