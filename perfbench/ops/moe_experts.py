"""The dropless MoE's grouped expert products at prefill (the gate and up
launch and the down launch of one call over a layer's routed rows)."""
from __future__ import annotations

from typing import Tuple


class MoEExperts:
    name = "moe_experts"
    # the prefill kernels only: decode runs the same code under the
    # names moe_up_decode and moe_down_decode, which a serving cell's
    # traced batches hold but whose work no prefill call lists
    patterns = ("moe_up_prefill", "moe_down_prefill")

    @staticmethod
    def work(*, T: int, K: int, E: int, d: int, f: int,
             elem: int = 2) -> Tuple[float, int]:
        """(FLOPs, bytes) of T tokens routed to K of E SwiGLU experts of
        width f over d: 2 T K d 3f FLOPs (the gate, up and down products
        of each routed row); each expert that has rows (all E, or as many
        as there are rows) reads its 3 d f weights once, the routed rows
        of X are read once, the (T K, f) activations written and read
        once and the (T K, d) outputs written once."""
        pairs = T * K
        hit = min(E, pairs)
        flops = 2.0 * pairs * d * 3 * f
        n_bytes = elem * (3 * hit * d * f + pairs * d + 2 * pairs * f
                          + pairs * d)
        return flops, n_bytes


OP = MoEExperts
