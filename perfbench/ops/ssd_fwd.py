"""The Mamba2 SSD chunked scan, forward (the tensor-core scan, or the f32
path's C Bᵀ and scan launches)."""
from __future__ import annotations

from typing import Tuple

from perfbench.workmath import causal_pairs


class SSDFwd:
    name = "ssd_fwd"
    patterns = ("ssd_scan", "ssd_cb")

    @staticmethod
    def work(*, B: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
             init_state: bool = False, elem: int = 2) -> Tuple[float, int]:
        """(FLOPs, bytes): x, dt, B and C read once, y and the final state
        written once (with ``init_state`` the initial state read); C Bᵀ
        once a group over the causal pairs of each chunk, the intra-chunk
        product over those pairs, the inter-chunk output and the state
        update."""
        pairs = causal_pairs(S, chunk)
        n_bytes = (2 * B * S * H * P * elem + 4 * B * S * H
                   + 2 * B * S * G * N * elem
                   + 4 * B * H * P * N * (2 if init_state else 1))
        flops = (2.0 * B * G * pairs * N + 2.0 * B * H * pairs * P
                 + 4.0 * B * H * S * N * P)
        return flops, n_bytes


OP = SSDFwd
