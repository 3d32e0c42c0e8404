"""The yardstick for kernel rooflines: the H100's published peaks and the
bytes each kernel's work must move, counted from a batch's inputs and
answers only, never from a kernel's internals, so that a kernel that
replaces K4 or K6 is read against the same work.

The counts follow ``chip_smoke.py``'s (its ``bound_ms`` and K4 byte
count), cut to what the answers show: every input byte read once, every
output byte written once, and of the reads that depend on the data only
those the answers prove.  So they are lower bounds, and a share over 100%
means the time leaves out part of the work.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float) -> float:
    """Least time for the work of a kernel bound by memory (K4 and K6
    compute next to nothing): its bytes over the memory rate."""
    return nbytes / HBM_BYTES_PER_S


def k4_bytes(width: int, rows: int, hit_lens: np.ndarray) -> int:
    """K4 (``fused_search``, the base walk) over ``rows`` queries of an
    index of ``width``: each query row and its length in; found, entry id
    and levels out (4 B each); the root item word at least (one item word a
    level walked, and every walk reads the root); and, for each query the
    answers show found, its key bytes and its entry record (offset and
    length, 8 B) read to confirm it."""
    hit_lens = np.asarray(hit_lens, np.int64)
    return int(rows * (width + 4) + 12 * rows + 4 * rows + (hit_lens + 8).sum())


def k6_bytes(width: int, window: int, rows: int, first_lens: np.ndarray) -> int:
    """K6 (``fused_scan``) over one group of scans of one ``window``: each
    start row and its length in; each window slot out (entry id 4 B, valid
    and delta flags 1 B each); and, for each scan the answers show
    non-empty, the bytes of its first key, which the rank must compare in
    full to place the start (``first_lens``, one a non-empty window)."""
    first = np.asarray(first_lens, np.int64)
    return int(rows * (width + 4) + rows * window * 6 + first.sum())
