"""The Mamba2 SSD backward (the bf16 path's state, row, column and
reduce launches, or the f32 path's chunk and state-pass launches)."""
from __future__ import annotations

from typing import Tuple

from perfbench.workmath import causal_pairs


class SSDBwd:
    name = "ssd_bwd"
    patterns = ("ssd_bwd", "ssd_state_pass")

    @staticmethod
    def work(*, B: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
             elem: int = 2) -> Tuple[float, int]:
        """(FLOPs, bytes): x, dy, dt, B and C read once, dx, ddt, dB and dC
        written once (no initial state); C Bᵀ once a group and dy xᵀ a head
        over the causal pairs, the three products of the pairs with dy, B
        and C, and five of S x N x P a head (the states recomputed forward
        and backward, the inter-chunk terms of dx, dC and dB)."""
        pairs = causal_pairs(S, chunk)
        n_bytes = (3 * B * S * H * P * elem + 2 * 4 * B * S * H
                   + 4 * B * S * G * N * elem)
        flops = (2.0 * B * G * pairs * N
                 + 2.0 * B * H * pairs * (2 * P + 2 * N)
                 + 10.0 * B * H * S * N * P)
        return flops, n_bytes


OP = SSDBwd
