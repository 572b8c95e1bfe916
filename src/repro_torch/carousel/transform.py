"""On-demand transformation, the twin of ``repro/carousel/transform.py``.

Raw corpus shards (variable-length tokenized documents) are transformed
at stage time into what the trainer consumes: fixed-length packed
sequences with next-token labels and a loss mask that zeroes the
positions predicting across a document boundary.  numpy only: it runs in
the stager's threads, which never touch torch or CUDA.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def pack_documents(docs: Sequence[np.ndarray], seq_len: int, *,
                   pad_id: int = 0, eod_id: int = 1) -> Dict[str, np.ndarray]:
    """Greedy sequential packing of documents into (N, seq_len) rows.

    Returns tokens (N, S) int32, labels (N, S) int32 (next token), and
    loss_mask (N, S) float32: 0 on pad positions and on the position that
    would predict across a document boundary.
    """
    # the stream: each document followed by an eod token
    parts = [np.append(np.asarray(d, np.int64), eod_id) for d in docs]
    stream = (np.concatenate(parts) if parts
              else np.zeros((0,), np.int64)).astype(np.int32)
    bounds = np.cumsum([p.shape[0] for p in parts], dtype=np.int64) - 1

    total = stream.shape[0]
    n_rows = max(1, (total + seq_len) // (seq_len + 1))
    need = n_rows * (seq_len + 1)  # >= total
    arr = np.full((need,), pad_id, np.int32)
    arr[:total] = stream
    rows = arr.reshape(n_rows, seq_len + 1)

    tokens = rows[:, :-1].copy()
    labels = rows[:, 1:].copy()
    valid = np.zeros((need,), np.float32)
    valid[:total] = 1.0
    # a position t is masked if token t + 1 starts a new doc (t is an eod)
    eod = np.zeros((need,), bool)
    eod[bounds] = True
    vm = valid.reshape(n_rows, seq_len + 1)
    em = eod.reshape(n_rows, seq_len + 1)
    loss_mask = vm[:, 1:] * (1.0 - em[:, :-1].astype(np.float32))
    return {"tokens": tokens, "labels": labels, "loss_mask": loss_mask}


def make_packing_transform(seq_len: int, *, pad_id: int = 0, eod_id: int = 1):
    """Stager ``transform`` hook: raw shard (list / object array of docs,
    or one 1-D doc) -> packed batch dict; a dict passes through."""
    def _tf(name: str, raw) -> Dict[str, np.ndarray]:
        if isinstance(raw, dict):   # already packed
            return raw
        docs = list(raw) if not isinstance(raw, np.ndarray) else (
            [raw] if raw.ndim == 1 else list(raw))
        return pack_documents(docs, seq_len, pad_id=pad_id, eod_id=eod_id)
    return _tf
