"""Hash-enhanced Prefix Table (HPT) — the paper's learned model (Sec. 3.2).

The HPT approximates ``prob(c | prefix)`` with a hashed prefix table and
computes a string CDF via the recursion of Eq. (1)/(2) (paper Alg. 1):

    cdf  += prob * HPT[hash(P_k)][c].cdf
    prob *= HPT[hash(P_k)][c].prob

``build_hpt``, ``uniform_hpt`` and the float64 analysis oracle
(``get_cdf_np64``, ``conditional_prob_error``) are numpy copies of
:mod:`repro.core.hpt`.  ``get_cdf`` and ``positions`` take tensors and
dispatch on their device: K2 and K1 (``csrc/hpt_cdf.cu``,
``csrc/hpt_locate.cu``) for CUDA tensors, the plain versions for CPU ones.
Both reproduce the reference's float32 arithmetic bit for bit, so the slot
a key is placed in at build time is the slot the walk finds it in.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.hpt_cdf import MAX_CDF_STEPS, hpt_cdf
from repro_torch.kernels.hpt_locate import hpt_locate

from .strings import StringSet

FNV_PRIME = np.uint32(0x01000193)

__all__ = ["HPT", "MAX_CDF_STEPS", "build_hpt", "uniform_hpt", "get_cdf", "positions",
           "rolling_hash_np", "get_cdf_np64", "conditional_prob_error"]


@dataclasses.dataclass
class HPT:
    """The trained table.  ``cdf_tab[r, c] = cdf(c | row r)``, ``prob_tab`` its increments."""

    cdf_tab: np.ndarray  # (rows, cols) float32
    prob_tab: np.ndarray  # (rows, cols) float32

    @property
    def rows(self) -> int:
        return self.cdf_tab.shape[0]

    @property
    def cols(self) -> int:
        return self.cdf_tab.shape[1]

    def nbytes(self) -> int:
        return self.cdf_tab.nbytes + self.prob_tab.nbytes


def _check_pow2(x: int, name: str) -> None:
    if x & (x - 1) or x <= 0:
        raise ValueError(f"{name} must be a power of two, got {x}")


def rolling_hash_np(h: np.ndarray, c: np.ndarray) -> np.ndarray:
    """One rolling-hash step (uint32 wraparound)."""
    return ((h ^ c.astype(np.uint32)) * FNV_PRIME).astype(np.uint32)


def build_hpt(
    sample: StringSet,
    rows: int = 1024,
    cols: int = 128,
    smoothing: float = 0.5,
) -> HPT:
    """Construct the HPT from a key sample (paper: ~1% of the data set),
    with add-``smoothing`` on the per-row counts."""
    _check_pow2(rows, "rows")
    if np.any(sample.bytes >= cols):
        raise ValueError(f"keys contain characters >= cols ({cols}); use cols=256")
    counts = np.zeros((rows, cols), dtype=np.float64)
    n, L = sample.bytes.shape
    h = np.zeros(n, dtype=np.uint32)
    mask = np.uint32(rows - 1)
    for k in range(min(L, MAX_CDF_STEPS)):
        active = sample.lens > k
        if not active.any():
            break
        c = sample.bytes[:, k]
        r = (h & mask).astype(np.int64)
        np.add.at(counts, (r[active], c[active].astype(np.int64)), 1.0)
        h = np.where(active, rolling_hash_np(h, c), h)
    counts += smoothing
    totals = counts.sum(axis=1, keepdims=True)
    empty = totals[:, 0] == 0
    if empty.any():  # only possible with smoothing == 0
        counts[empty] = 1.0
        totals = counts.sum(axis=1, keepdims=True)
    prob = counts / totals
    cdf = np.cumsum(prob, axis=1) - prob  # exclusive cumsum: cdf(c) = sum_{i<c} prob(i)
    return HPT(cdf.astype(np.float32), prob.astype(np.float32))


def uniform_hpt(rows: int = 1, cols: int = 128) -> HPT:
    """The uniform-next-character model — the paper's SM baseline."""
    prob = np.full((rows, cols), 1.0 / cols, dtype=np.float64)
    cdf = np.cumsum(prob, axis=1) - prob
    return HPT(cdf.astype(np.float32), prob.astype(np.float32))


def get_cdf(cdf_tab, prob_tab, qbytes, qlens, start=0, max_steps: int = MAX_CDF_STEPS):
    """Batched GetCDF over zero-padded (B, L) uint8 rows, from character ``start``
    with a fresh hash state (paper Alg. 2, line 35).  float32 (B,)."""
    return hpt_cdf(qbytes, qlens, start, cdf_tab=cdf_tab, prob_tab=prob_tab,
                   max_steps=max_steps)


def positions(cdf_tab, prob_tab, qbytes, qlens, start, alpha, beta, nslots,
              max_steps: int = MAX_CDF_STEPS):
    """Slot position = clamp(floor(alpha*cdf + beta), 1, nslots-2) (paper Alg. 2 l.35-37)."""
    return hpt_locate(qbytes, qlens, start, alpha, beta, nslots,
                      cdf_tab=cdf_tab, prob_tab=prob_tab, max_steps=max_steps)


# ---------------------------------------------------------------------------
# Numpy float64 oracle (analysis only, not used for the index structure)
# ---------------------------------------------------------------------------

def get_cdf_np64(hpt: HPT, ss: StringSet, start: int = 0,
                 max_steps: int = MAX_CDF_STEPS) -> np.ndarray:
    """GetCDF in float64 on the host (the baselines' and the shard
    boundaries' model values)."""
    cdf_tab = hpt.cdf_tab.astype(np.float64)
    prob_tab = hpt.prob_tab.astype(np.float64)
    R, C = cdf_tab.shape
    n, L = ss.bytes.shape
    cdf = np.zeros(n, np.float64)
    prob = np.ones(n, np.float64)
    h = np.zeros(n, np.uint32)
    mask = np.uint32(R - 1)
    for k in range(start, min(L, start + max_steps)):
        active = ss.lens > k
        if not active.any():
            break
        c = np.minimum(ss.bytes[:, k], C - 1).astype(np.int64)
        r = (h & mask).astype(np.int64)
        cdf = cdf + np.where(active, prob * cdf_tab[r, c], 0.0)
        prob = prob * np.where(active, prob_tab[r, c], 1.0)
        h = np.where(active, rolling_hash_np(h, ss.bytes[:, k]), h)
    return cdf


def conditional_prob_error(hpt: HPT, full: StringSet, prefix: bytes, min_count: int = 1) -> float:
    """Mean |HPT[hash(P)][c].prob − prob(c|P)| for a given prefix (Thm 3.1 check)."""
    pl = len(prefix)
    pb = np.frombuffer(prefix, np.uint8)
    m = (full.lens > pl) & np.all(full.bytes[:, :pl] == pb[None, :], axis=1)
    nxt = full.bytes[m, pl]
    if nxt.size < min_count:
        return float("nan")
    emp = np.bincount(nxt, minlength=hpt.cols).astype(np.float64)
    emp = emp / emp.sum()
    h = np.zeros(1, np.uint32)
    for c in pb:
        h = rolling_hash_np(h, np.array([c], np.uint8))
    r = int(h[0] & np.uint32(hpt.rows - 1))
    approx = hpt.prob_tab[r].astype(np.float64)
    support = emp > 0
    return float(np.abs(approx[support] - emp[support]).mean())
