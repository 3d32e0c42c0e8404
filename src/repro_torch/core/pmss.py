"""PMSS — Performance Model for Structure Selection (paper Sec. 3.4, Eq. 5).

Numpy copy of :mod:`repro.core.pmss` with its analytic seed tables.

    latency = f_r * readlat(gpkl, n) + f_w * writelat(gpkl, n)

per candidate structure; pick the argmin.  The port always uses the seed
tables: the reference reads ``pmss_tables.json`` when a benchmark has written
one, and with no such file both packages make the same decisions.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Paper grid: gpkl = 3,5,...,21 ; n = 2^4 .. 2^25
GPKL_GRID = np.arange(3.0, 22.0, 2.0)
LOGN_GRID = np.arange(4.0, 26.0, 1.0)


def _seed_tables() -> dict:
    """Analytic seed: rough ns-scale latencies.

    LIT read  ≈ per-level node cost × small height + CDF walk ∝ gpkl.
    Trie read ≈ per-bit-step cost × depth; critbit depth grows with log n and
    with the number of distinguishing bits (∝ gpkl).
    """
    g = GPKL_GRID[:, None]
    ln = LOGN_GRID[None, :]
    lit_read = 40.0 + 14.0 * g + 12.0 * np.maximum(ln - 12.0, 0.0)
    lit_write = 70.0 + 16.0 * g + 18.0 * np.maximum(ln - 12.0, 0.0)
    trie_read = 30.0 + 3.5 * g + 11.0 * ln
    trie_write = 45.0 + 4.0 * g + 13.0 * ln
    return {
        "gpkl_grid": GPKL_GRID.tolist(),
        "logn_grid": LOGN_GRID.tolist(),
        "lit": {"read": lit_read.tolist(), "write": lit_write.tolist()},
        "trie": {"read": trie_read.tolist(), "write": trie_write.tolist()},
        "source": "analytic-seed",
    }


def _interp2(tab: np.ndarray, gg: np.ndarray, nn: np.ndarray, gpkl: float, logn: float) -> float:
    """Bilinear interpolation with clamping at the grid edges."""
    gi = np.clip(np.searchsorted(gg, gpkl) - 1, 0, len(gg) - 2)
    ni = np.clip(np.searchsorted(nn, logn) - 1, 0, len(nn) - 2)
    tg = np.clip((gpkl - gg[gi]) / (gg[gi + 1] - gg[gi]), 0.0, 1.0)
    tn = np.clip((logn - nn[ni]) / (nn[ni + 1] - nn[ni]), 0.0, 1.0)
    a = tab[gi, ni] * (1 - tg) * (1 - tn)
    b = tab[gi + 1, ni] * tg * (1 - tn)
    c = tab[gi, ni + 1] * (1 - tg) * tn
    d = tab[gi + 1, ni + 1] * tg * tn
    return float(a + b + c + d)


@dataclasses.dataclass
class PMSS:
    tables: dict = dataclasses.field(default_factory=_seed_tables)
    f_read: float = 0.5
    f_write: float = 0.5

    def latency(self, structure: str, gpkl: float, n: int) -> float:
        gg = np.asarray(self.tables["gpkl_grid"])
        nn = np.asarray(self.tables["logn_grid"])
        logn = float(np.log2(max(n, 2)))
        r = _interp2(np.asarray(self.tables[structure]["read"]), gg, nn, gpkl, logn)
        w = _interp2(np.asarray(self.tables[structure]["write"]), gg, nn, gpkl, logn)
        return self.f_read * r + self.f_write * w

    def decide(self, gpkl: float, n: int) -> str:
        """'lit' (model-based node) or 'trie' (critbit subtrie)."""
        lit = self.latency("lit", gpkl, n)
        trie = self.latency("trie", gpkl, n)
        return "lit" if lit <= trie else "trie"
