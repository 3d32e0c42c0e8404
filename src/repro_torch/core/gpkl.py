"""Numpy copy of :mod:`repro.core.gpkl`.

GPKL — the paper's hardness metric for string data sets (Sec. 3.4, Def. 3.1-3.3).

    pkl(L, S_i) = max(cpl(S_{i-1}, S_i), cpl(S_i, S_{i+1})) + 1 - cpl(L)   (Eq. 4)
    gpkl(L)     = mean_i pkl(L, S_i)

Boundary strings use their single neighbour.  ``local_gpkl`` partitions the
sorted list into disjoint sublists of ``g`` strings (paper: g=32) and averages
the sublist GPKLs.
"""
from __future__ import annotations

import numpy as np

from .strings import StringSet, group_cpl, pairwise_cpl


def _adjacent_cpls(ss: StringSet) -> np.ndarray:
    """cpl of each adjacent sorted pair: shape (n-1,)."""
    if len(ss) < 2:
        return np.zeros((0,), np.int32)
    return pairwise_cpl(ss.bytes[:-1], ss.bytes[1:])


def pkl(ss_sorted: StringSet) -> np.ndarray:
    """Partial key length of every string of a *sorted* list (Eq. 4)."""
    n = len(ss_sorted)
    if n == 0:
        return np.zeros((0,), np.float64)
    if n == 1:
        return np.ones((1,), np.float64)
    adj = _adjacent_cpls(ss_sorted)  # (n-1,)
    left = np.concatenate([[np.int32(-1)], adj])   # cpl(S_{i-1}, S_i); -1 pads S_0
    right = np.concatenate([adj, [np.int32(-1)]])  # cpl(S_i, S_{i+1})
    shortest = np.maximum(left, right) + 1
    base = group_cpl(ss_sorted)
    return np.maximum(shortest - base, 1).astype(np.float64)


def gpkl(ss_sorted: StringSet) -> float:
    p = pkl(ss_sorted)
    return float(p.mean()) if p.size else 0.0


def local_gpkl(ss_sorted: StringSet, g: int = 32) -> float:
    n = len(ss_sorted)
    if n == 0:
        return 0.0
    vals = []
    for i in range(0, n, g):
        sub = StringSet(ss_sorted.bytes[i : i + g], ss_sorted.lens[i : i + g])
        vals.append(gpkl(sub))
    return float(np.mean(vals))

