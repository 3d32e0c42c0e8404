"""K2 and K7: batched HPT GetCDF (paper Alg. 1) — CUDA kernels and their
plain versions.

K2 replaces ``repro/kernels/hpt_cdf.py::_cdf_kernel_gather``.  The kernel is
``csrc/hpt_cdf.cu``: a group of 8 lanes walks each query
(``csrc/lits_cdf_group.cuh``).  The lanes load the row's bytes in one
coalesced pass, fold the FNV-1a states from bytes they shuffle among
themselves, issue every table read of the walk at once, and then run the
sum in the reference's step order, so a launch costs a few dependent round
trips instead of two per step.  Its bound is bytes (the row, three
per-query words, two table floats per active step); at the bulk load's
launch shapes a third of the time is the launch itself, and at 65,536 rows
the rate of scattered table reads sets the pace.  The plain version is the reference
``get_cdf_impl`` in tensor ops.

K7 replaces ``_cdf_kernel_onehot``, the same walk with each table value
selected by one-hot contractions: a (B, R) row one-hot times the table, a
true float32 product, then a select of the step's column.  In that product
``0 * inf`` and ``0 * nan`` are NaN, so a step's value is ``tab[row, c]``
unless column ``c`` holds a non-finite entry in another row, and then it is
NaN; a non-finite entry in another column does not reach the step (the
reference's column select passes column ``c`` alone).  On finite tables K7
equals K2 bit for bit.  The kernel is ``csrc/hpt_cdf_onehot.cu``: K2's lane
group walk, with each value read turned into NaN where the column's count
of non-finite entries, less the entry's own, is positive.  The counts are
made once per table (:func:`nonfinite_columns`).  The plain version does
the contraction as the reference does.

Numerics: ``cdf += prob * cval`` is two separately rounded float32 ops (the
reference does not contract it to an FMA), and ``prob *= pval``.  Each op
flushes subnormals as XLA on the CPU does (:func:`mul_ftz`, :func:`add_ftz`):
a subnormal operand counts as a zero of its sign and a subnormal result
becomes one, so a ``prob`` that underflows is 0, and 0 times an inf is NaN.  A step is
active while ``start + k < qlen``; the character index is clamped to
``L - 1`` and the character to ``C - 1``; the row is the uint32 FNV-1a state
``& (R - 1)``.  The walk takes ``min(max_steps, L)`` steps.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .strops import FNV_PRIME, U32

MAX_CDF_STEPS = 64
_TINY = 2.0 ** -126  # the smallest normal float32


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with subnormal float32 values replaced by zeros of their sign."""
    return torch.where(x.abs() < _TINY, x * 0, x)


def mul_ftz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b`` of flushed operands (:func:`flush_subnormal`), its
    result flushed when the product, rounded to 24 bits with an unbounded
    exponent, is below 2**-126 (tininess after rounding, the rule of x86's
    flush and of the card's ``mul.ftz``): a product just below 2**-126 that
    rounds up to it is kept.  Scaled by 2**64 the product rounds in the
    normal range, where that rounding is float32's own; an operand large
    enough to overflow the scaling makes a product far above 2**-126."""
    a, b = flush_subnormal(a), flush_subnormal(b)
    r = a * b
    return torch.where(((a * 2.0 ** 64) * b).abs() < 2.0 ** -62, r * 0, r)


def add_ftz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a + b`` of flushed operands, its result flushed.  A sum of
    normal float32 values below 2**-126 is exact, so no rounding rule is
    needed."""
    return flush_subnormal(flush_subnormal(a) + flush_subnormal(b))


def hpt_cdf_plain(qbytes, qlens, start, cdf_tab, prob_tab,
                  max_steps: int = MAX_CDF_STEPS) -> torch.Tensor:
    """Plain PyTorch GetCDF over zero-padded (B, L) uint8 query rows."""
    R, C = cdf_tab.shape
    B, L = qbytes.shape
    dev = qbytes.device
    start = _build.as_rows(start, B, torch.int64, dev)
    qlens = qlens.long()
    cdf = torch.zeros(B, dtype=torch.float32, device=dev)
    prob = torch.ones(B, dtype=torch.float32, device=dev)
    h = torch.zeros(B, dtype=torch.int64, device=dev)
    flat_cdf, flat_prob = cdf_tab.reshape(-1), prob_tab.reshape(-1)
    for k in range(min(max_steps, L)):
        pos = start + k
        c = qbytes.gather(1, pos.clamp(0, L - 1)[:, None])[:, 0].long().clamp(max=C - 1)
        active = pos < qlens
        idx = (h & (R - 1)) * C + c
        cval = flat_cdf[idx]
        pval = flat_prob[idx]
        cdf = add_ftz(cdf, torch.where(active, mul_ftz(prob, cval), 0.0))
        prob = mul_ftz(prob, torch.where(active, pval, 1.0))
        h = torch.where(active, ((h ^ c) * FNV_PRIME) & U32, h)
    return cdf


def hpt_cdf_onehot_plain(qbytes, qlens, start, cdf_tab, prob_tab,
                         max_steps: int = MAX_CDF_STEPS) -> torch.Tensor:
    """Plain one-hot GetCDF: per step a (B, R) row one-hot times each table
    (a true float32 product, never TF32, in which a zero weight on a
    non-finite entry gives NaN), then the step's column of the product,
    selected alone.  Subnormal table entries are flushed first, as the
    reference's contraction flushes its operands."""
    R, C = cdf_tab.shape
    B, L = qbytes.shape
    dev = qbytes.device
    start = _build.as_rows(start, B, torch.int64, dev)
    qlens = qlens.long()
    cdf = torch.zeros(B, dtype=torch.float32, device=dev)
    prob = torch.ones(B, dtype=torch.float32, device=dev)
    h = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = torch.arange(R, device=dev)[None, :]
    tabs = flush_subnormal(cdf_tab), flush_subnormal(prob_tab)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        for k in range(min(max_steps, L)):
            pos = start + k
            c = qbytes.gather(1, pos.clamp(0, L - 1)[:, None])[:, 0].long().clamp(max=C - 1)
            active = pos < qlens
            row_oh = (rows == (h & (R - 1))[:, None]).float()
            cval, pval = (torch.matmul(row_oh, t).gather(1, c[:, None])[:, 0] for t in tabs)
            cdf = add_ftz(cdf, torch.where(active, mul_ftz(prob, cval), 0.0))
            prob = mul_ftz(prob, torch.where(active, pval, 1.0))
            h = torch.where(active, ((h ^ c) * FNV_PRIME) & U32, h)
    finally:
        torch.set_float32_matmul_precision(precision)
    return cdf


def nonfinite_columns(tab) -> torch.Tensor:
    """(C,) int32: the non-finite entries of each column of an (R, C) table,
    made once per table (:func:`_build.derived`).  K7 reads a step's value
    as NaN where its column's count, less the entry's own, is positive."""
    return _build.derived("nonfinite_columns", (tab,),
                          lambda t: (~torch.isfinite(t)).sum(dim=0, dtype=torch.int32))


def _check_cdf_args(qbytes, qlens, start, cdf_tab, prob_tab):
    B, L = qbytes.shape
    R, C = cdf_tab.shape
    dev = qbytes.device
    _build.check(qbytes, "qbytes", torch.uint8, (B, L), dev)
    _build.check(qlens, "qlens", torch.int32, (B,), dev)
    _build.check(start, "start", torch.int32, (B,), dev)
    _build.check(cdf_tab, "cdf_tab", torch.float32, (R, C), dev)
    _build.check(prob_tab, "prob_tab", torch.float32, (R, C), dev)
    if R & (R - 1):
        raise ValueError(f"HPT rows must be a power of two, got {R}")
    return B, L, R, C


def hpt_cdf_onehot_cuda(qbytes, qlens, start, cdf_tab, prob_tab,
                        max_steps: int = MAX_CDF_STEPS) -> torch.Tensor:
    """Launch K7; the same arguments as :func:`hpt_cdf_cuda`."""
    B, L, R, C = _check_cdf_args(qbytes, qlens, start, cdf_tab, prob_tab)
    out = torch.empty(B, dtype=torch.float32, device=qbytes.device)
    if B == 0:
        return out
    cdf_bad, prob_bad = nonfinite_columns(cdf_tab), nonfinite_columns(prob_tab)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "hpt_cdf_onehot", "lits_hpt_cdf_onehot", [P, P, P, P, P, P, P, I, I, I, I, I, P],
        qbytes.data_ptr(), qlens.data_ptr(), start.data_ptr(), cdf_tab.data_ptr(),
        prob_tab.data_ptr(), cdf_bad.data_ptr(), prob_bad.data_ptr(), B, L, R, C,
        int(max_steps), out.data_ptr())
    _build.LAUNCHES["hpt_cdf_onehot"] += 1
    return out


def hpt_cdf_cuda(qbytes, qlens, start, cdf_tab, prob_tab,
                 max_steps: int = MAX_CDF_STEPS) -> torch.Tensor:
    """Launch K2.  ``qlens``/``start`` are (B,) int32; tables (R, C) float32."""
    B, L, R, C = _check_cdf_args(qbytes, qlens, start, cdf_tab, prob_tab)
    out = torch.empty(B, dtype=torch.float32, device=qbytes.device)
    if B == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "hpt_cdf", "lits_hpt_cdf", [P, P, P, P, P, I, I, I, I, I, P],
        qbytes.data_ptr(), qlens.data_ptr(), start.data_ptr(), cdf_tab.data_ptr(),
        prob_tab.data_ptr(), B, L, R, C, int(max_steps), out.data_ptr())
    _build.LAUNCHES["hpt_cdf"] += 1
    return out


VARIANTS = {"gather": (hpt_cdf_cuda, hpt_cdf_plain),
            "onehot": (hpt_cdf_onehot_cuda, hpt_cdf_onehot_plain)}


def hpt_cdf(qbytes, qlens, start=0, *, cdf_tab, prob_tab, variant: str = "gather",
            max_steps: int = MAX_CDF_STEPS) -> torch.Tensor:
    """Batched GetCDF.  ``variant`` "gather" is K2 and "onehot" K7 for CUDA
    tensors; CPU tensors run the variant's plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown GetCDF variant {variant!r}; expected one of {list(VARIANTS)}")
    kernel, plain = VARIANTS[variant]
    B = qbytes.shape[0]
    if qbytes.is_cuda:
        return kernel(qbytes, _build.as_rows(qlens, B, torch.int32, qbytes.device),
                      _build.as_rows(start, B, torch.int32, qbytes.device),
                      cdf_tab, prob_tab, max_steps)
    return plain(qbytes, qlens, start, cdf_tab, prob_tab, max_steps)
