"""Host-side (numpy) row-set utilities — counterpart of
`parmmg_tpu/utils/rows.py`."""

from __future__ import annotations

import numpy as np


def row_member(query: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """[Q] bool: does each query row appear among `keys` rows?
    Row-wise set membership via one np.unique over the concatenation —
    used by the level-set orphan-tria filter."""
    query = np.asarray(query)
    keys = np.asarray(keys)
    if len(query) == 0:
        return np.zeros(0, bool)
    if len(keys) == 0:
        return np.zeros(len(query), bool)
    allr = np.concatenate([keys, query])
    _, inv = np.unique(allr, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    seen = np.zeros(inv.max() + 1, bool)
    seen[inv[: len(keys)]] = True
    return seen[inv[len(keys):]]
