"""Plain reference of the carousel's packing: documents, each followed
by an end-of-document id, laid end to end and cut into rows of
``seq_len + 1`` (the tail padded); a row gives ``seq_len`` tokens, their
next-token labels, and a loss mask that is 0 on padding and where a
label would cross into the next document.  The same semantics as the
program's packing transform, written apart from it, so that the rows
the program delivered can be checked one by one."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def pack(docs: Sequence[np.ndarray], seq_len: int, pad_id: int = 0,
         eod_id: int = 1) -> Dict[str, np.ndarray]:
    stream, is_eod = [], []
    for d in docs:
        stream += [int(t) for t in d] + [eod_id]
        is_eod += [False] * len(d) + [True]
    n = len(stream)
    rows = max(1, (n + seq_len) // (seq_len + 1))
    width = seq_len + 1
    toks = np.full(rows * width, pad_id, np.int32)
    toks[:n] = stream
    valid = np.zeros(rows * width, np.float32)
    valid[:n] = 1.0
    eod = np.zeros(rows * width, bool)
    eod[:n] = is_eod
    toks, valid, eod = (a.reshape(rows, width) for a in (toks, valid, eod))
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
            "loss_mask": valid[:, 1:] * (~eod[:, :-1]).astype(np.float32)}
