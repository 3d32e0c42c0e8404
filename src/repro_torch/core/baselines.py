"""Baseline learned string models from the paper's comparisons (Sec. 4.3).

A numpy copy of :mod:`repro.core.baselines` (the port imports nothing of
``repro``):

* **SM**  — simple model, ``x = sum_i c_i / 256^i`` (used by SLIPP).
* **RS**  — Radix Spline over the first-8-byte integer (used by RSS), greedy
  spline corridor with a given error bound.
* **SRMI** — two-layer RMI over the SM value (learned-sort paper).

All are host-side float64 models exposing ``values(ss, start=0) -> float64``
monotone-in-key scores, so they can be plugged into the LIT builder
(``LITSBuilder(host_model=...)``) to reproduce Fig. 13 (unique rate) and
Fig. 14 (LIT(model) index performance).  SM is exactly the HPT with a
uniform table, which is how the paper frames the limitation of prior
linear models (Eq. 3).  Being host float64 arithmetic, every array equals
the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .strings import StringSet, pack_prefix_u64


class SMModel:
    """x = sum_i c_i / 256^i, computed over at most 16 leading characters."""

    name = "sm"

    def values(self, ss: StringSet, start: int = 0) -> np.ndarray:
        n, L = ss.bytes.shape
        x = np.zeros(n, np.float64)
        scale = 1.0
        for k in range(start, min(L, start + 16)):
            scale /= 256.0
            active = ss.lens > k
            x += np.where(active, ss.bytes[:, k].astype(np.float64) * scale, 0.0)
        return x


@dataclasses.dataclass
class RSModel:
    """Greedy radix-spline corridor over the 8-byte packed prefix (RSS default)."""

    error_bound: int = 127
    knots_x: np.ndarray | None = None
    knots_y: np.ndarray | None = None
    name = "rs"

    def fit(self, ss_sorted: StringSet) -> "RSModel":
        x = pack_prefix_u64(ss_sorted.bytes).astype(np.float64) / 2.0**64
        y = np.arange(len(ss_sorted), dtype=np.float64)
        # deduplicate x (keys sharing an 8-byte prefix collapse — RSS's weakness)
        ux, first = np.unique(x, return_index=True)
        uy = y[first]
        kx, ky = [ux[0]], [uy[0]]
        if len(ux) > 1:
            lo, hi = np.inf, -np.inf
            anchor = 0
            for i in range(1, len(ux)):
                dx = ux[i] - ux[anchor]
                if dx <= 0:
                    continue
                slope_hi = (uy[i] + self.error_bound - ky[-1]) / dx
                slope_lo = (uy[i] - self.error_bound - ky[-1]) / dx
                if i == anchor + 1:
                    lo, hi = slope_lo, slope_hi
                    continue
                if slope_lo > hi or slope_hi < lo:
                    kx.append(ux[i - 1])
                    ky.append(uy[i - 1])
                    anchor = i - 1
                    lo, hi = -np.inf, np.inf
                else:
                    lo, hi = max(lo, slope_lo), min(hi, slope_hi)
            kx.append(ux[-1])
            ky.append(uy[-1])
        self.knots_x = np.asarray(kx)
        self.knots_y = np.asarray(ky)
        return self

    def values(self, ss: StringSet, start: int = 0) -> np.ndarray:
        if self.knots_x is None:
            raise RuntimeError("RSModel.fit must be called first")
        b = ss.bytes[:, start:] if start else ss.bytes
        x = pack_prefix_u64(np.ascontiguousarray(b)).astype(np.float64) / 2.0**64
        return np.interp(x, self.knots_x, self.knots_y)


@dataclasses.dataclass
class SRMIModel:
    """Two-layer RMI over the SM encoding (learned-sort style)."""

    branch: int = 256
    name = "srmi"

    def fit(self, ss_sorted: StringSet) -> "SRMIModel":
        sm = SMModel()
        x = sm.values(ss_sorted)
        n = len(ss_sorted)
        y = np.arange(n, dtype=np.float64) / max(n - 1, 1)
        self._l1 = np.polyfit(x, y, 1) if n > 1 else np.array([0.0, 0.0])
        bucket = np.clip((np.polyval(self._l1, x) * self.branch).astype(np.int64), 0, self.branch - 1)
        self._l2 = np.zeros((self.branch, 2), np.float64)
        for b in range(self.branch):
            m = bucket == b
            if m.sum() >= 2 and np.ptp(x[m]) > 0:
                self._l2[b] = np.polyfit(x[m], y[m], 1)
            elif m.any():
                self._l2[b] = [0.0, float(y[m].mean())]
            else:
                self._l2[b] = [0.0, (b + 0.5) / self.branch]
        return self

    def values(self, ss: StringSet, start: int = 0) -> np.ndarray:
        sm = SMModel()
        x = sm.values(ss, start)
        bucket = np.clip((np.polyval(self._l1, x) * self.branch).astype(np.int64), 0, self.branch - 1)
        coef = self._l2[bucket]
        return coef[:, 0] * x + coef[:, 1]


def unique_rate(values: np.ndarray, scale_factor: float) -> float:
    """UR_SF (paper Eq. 6): occupied slots / |S| after linear mapping to SF*|S| slots."""
    n = values.size
    if n == 0:
        return 1.0
    m = max(int(scale_factor * n), 1)
    vmin, vmax = float(values.min()), float(values.max())
    if vmax <= vmin:
        return 1.0 / n
    pos = np.clip(((values - vmin) / (vmax - vmin) * (m - 1)).astype(np.int64), 0, m - 1)
    return float(np.unique(pos).size) / n


def hpt_values(hpt, ss: StringSet, start: int = 0) -> np.ndarray:
    """HPT as a baseline-comparable model (float64 oracle)."""
    from .hpt import get_cdf_np64

    return get_cdf_np64(hpt, ss, start=start)
