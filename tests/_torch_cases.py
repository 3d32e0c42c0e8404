"""Inputs shared by the port's tests (``test_torch_*.py``), made with numpy
from a seed so that both packages get the same arrays."""
from __future__ import annotations

from fractions import Fraction

import numpy as np

from repro_torch.core.strings import StringSet, random_strings


def query_rows(rng, n: int, width: int, rows: int = 256):
    """(n, width) rows of random keys, about a tenth of them over-width
    (length ``width + 1``, the pad_queries sentinel), random ``start``
    offsets, and an HPT built from a sample of the keys."""
    from repro_torch.core.hpt import build_hpt

    keys = random_strings(rng, n, 1, width + 8)
    ss = StringSet.from_list([k[:width] for k in keys], width=width)
    lens = np.array([min(len(k), width + 1) for k in keys], np.int32)
    hpt = build_hpt(ss.take(np.arange(min(n, 2000))), rows=rows, cols=128)
    start = rng.integers(0, 8, size=n).astype(np.int32)
    return ss.bytes, lens, start, hpt


def tie_cases():
    """Locate inputs whose ``alpha * cdf + beta`` lies within 2**-33 of a
    float32 rounding midpoint: rounding the float64 sum to float32 picks the
    wrong side there, and only a true single rounding (FMA) gets the slot
    right.  641 * 6700417 = 2**32 + 1, so the products carry a tail of
    2**-33 below the bits a float32 sum keeps.  Returns float32
    ``(cdf, alpha, beta)``; each row's exact sum is in 2**23..2**24, where
    float32 steps by 1 and the floor shows the side."""
    # alpha * cdf = +-(0.5 + 2**-33); beta an integer.  With an even beta
    # the float64 sum is a midpoint that round-to-even sends to beta, while
    # the exact sum lies past it (odd beta: both agree, as a control).
    a = np.float32(641 * 2.0 ** -17)
    b = np.float32(6700417 * 2.0 ** -16)
    bases = [2 ** 23 + d for d in (2, 6, 1000, 1, 3, 1001)]
    cdf = np.array([s * b for s in (1, -1) for _ in bases], np.float32)
    alpha = np.full(cdf.shape, a, np.float32)
    beta = np.array(bases * 2, np.float32)
    return cdf, alpha, beta


def saturation_cases():
    """``(cdf, alpha, beta)`` whose fma is NaN, +inf or -inf: the slot comes
    from a saturating float-to-int conversion that maps NaN to 0."""
    cdf = np.array([0.5, 0.0, 0.5, 1.0], np.float32)
    alpha = np.array([np.inf, np.inf, -np.inf, 3e38], np.float32)
    beta = np.array([0.0, 0.0, 0.0, 3e38], np.float32)
    return cdf, alpha, beta


def exact_fma_f32(a, b, c) -> np.ndarray:
    """Correctly rounded float32 ``a * b + c`` by exact rational arithmetic."""
    out = []
    for x, y, z in zip(a, b, c):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        r = np.float32(float(v))
        cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
        dist = [abs(Fraction(float(w)) - v) for w in cands]
        best = min(dist)
        ties = [w for w, d in zip(cands, dist) if d == best]
        # round half to even: the candidate whose last mantissa bit is 0
        out.append(ties[0] if len(ties) == 1 else
                   next(w for w in ties if not np.float32(w).view(np.int32) & 1))
    return np.array(out, np.float32)


def tie_table(cdf: np.ndarray):
    """A one-row HPT whose column ``c`` holds ``cdf[c - 1]``: the length-1
    query ``bytes([c])`` then has exactly that CDF."""
    cdf_tab = np.zeros((1, 128), np.float32)
    cdf_tab[0, 1 : 1 + cdf.shape[0]] = cdf
    prob_tab = np.full((1, 128), 1.0 / 128, np.float32)
    qb = np.arange(1, 1 + cdf.shape[0], dtype=np.uint8)[:, None]
    ql = np.ones(cdf.shape[0], np.int32)
    return cdf_tab, prob_tab, qb, ql
