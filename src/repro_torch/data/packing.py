"""Sequence packing (paper §A.4): append EOS to every document, concatenate
everything, and split into fixed-length chunks — no padding tokens."""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

EOS = 0


def pack_documents(docs: Iterable[np.ndarray], seq_len: int) -> np.ndarray:
    """-> (n_chunks, seq_len) int32; the ragged tail is dropped."""
    flat: List[np.ndarray] = []
    for d in docs:
        flat.append(np.asarray(d, np.int32))
        flat.append(np.array([EOS], np.int32))
    stream = np.concatenate(flat) if flat else np.zeros((0,), np.int32)
    n = len(stream) // seq_len
    return stream[: n * seq_len].reshape(n, seq_len)


def shift_labels(chunks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Next-token-prediction pairs: inputs (N, S), labels (N, S) with the
    final position masked (-1)."""
    inputs = chunks
    labels = np.full_like(chunks, -1)
    labels[:, :-1] = chunks[:, 1:]
    return inputs, labels
