"""K1: fused HPT GetCDF + model-node locate (paper Alg. 2, l.35-37).

Replaces ``repro/kernels/hpt_locate.py::_locate_kernel``:

    pos = clip(floor(fma(alpha, GetCDF(s + start), beta)), 1, nslots - 2)

The kernel is ``csrc/hpt_locate.cu``: K2's walk with a group of 8 lanes per
query (``csrc/lits_cdf_group.cuh``), then the locate in the lane that holds
the sum; its bound is bytes, as K2's.  K4 runs the same ``__device__``
locate after its own GetCDF, one thread per query, inside its model-node
step.  The reference contracts ``alpha * cdf + beta``
to one fused multiply-add, so the plain version emulates a float32 FMA
exactly (:func:`fma_f32`).  The float-to-int conversion saturates and maps
NaN to 0, as XLA's and CUDA's ``cvt.rmi.s32.f32`` do.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.spans import span

from . import _build
from .hpt_cdf import MAX_CDF_STEPS, flush_subnormal, hpt_cdf_plain

_I32_MIN, _I32_MAX = -2147483648, 2147483647


def _round_f32(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """float32 rounding of the exact sum ``s + e`` of a float64 ``s`` and
    its TwoSum error ``e``.  Rounding ``s`` alone is correct except where
    ``s`` sits exactly halfway between two float32 values while ``e != 0``:
    there the exact sum lies on the side of ``e``'s sign, and round-to-even
    may have picked the other side."""
    r = s.float()
    rd = r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    tie = torch.isfinite(s) & (e != 0) & (s == (rd + other.double()) * 0.5)
    up = torch.maximum(r, other)
    down = torch.minimum(r, other)
    return torch.where(tie, torch.where(e > 0, up, down), r)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a hardware FMA does, with
    subnormals flushed as XLA on the CPU flushes them: subnormal operands
    count as zeros of their sign, and a result that rounds (24 bits, an
    unbounded exponent) below 2**-126 becomes one.

    The float64 product of two float32 values is exact, and TwoSum gives
    the float64 sum ``s`` and its exact error ``e``.  Scaled by 2**64 the
    pair rounds in float32's normal range, which decides the flush.
    """
    a, b, c = flush_subnormal(a), flush_subnormal(b), flush_subnormal(c)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    e = (p - (s - bv)) + (cd - bv)
    r = _round_f32(s, e)
    tiny = _round_f32(s * 2.0 ** 64, e * 2.0 ** 64).abs() < 2.0 ** -62
    return torch.where(tiny, r * 0, r)


def slot_positions(cdf, alpha, beta, nslots) -> torch.Tensor:
    """clip(floor(fma(alpha, cdf, beta)), 1, nslots - 2) as int32."""
    t = fma_f32(alpha, cdf, beta).double().floor()
    t = torch.nan_to_num(t, nan=0.0).clamp(_I32_MIN, _I32_MAX).long()
    return torch.minimum(t.clamp(min=1), nslots.long() - 2).int()


def hpt_locate_plain(qbytes, qlens, start, alpha, beta, nslots, cdf_tab, prob_tab,
                     max_steps: int = MAX_CDF_STEPS) -> torch.Tensor:
    B = qbytes.shape[0]
    dev = qbytes.device
    cdf = hpt_cdf_plain(qbytes, qlens, start, cdf_tab, prob_tab, max_steps)
    return slot_positions(cdf, _build.as_rows(alpha, B, torch.float32, dev),
                          _build.as_rows(beta, B, torch.float32, dev),
                          _build.as_rows(nslots, B, torch.int32, dev))


def hpt_locate_cuda(qbytes, qlens, start, alpha, beta, nslots, cdf_tab, prob_tab,
                    max_steps: int = MAX_CDF_STEPS) -> torch.Tensor:
    """Launch K1.  Per-query vectors are (B,): int32 qlens/start/nslots,
    float32 alpha/beta."""
    B, L = qbytes.shape
    R, C = cdf_tab.shape
    dev = qbytes.device
    _build.check(qbytes, "qbytes", torch.uint8, (B, L), dev)
    for name, v in (("qlens", qlens), ("start", start), ("nslots", nslots)):
        _build.check(v, name, torch.int32, (B,), dev)
    for name, v in (("alpha", alpha), ("beta", beta)):
        _build.check(v, name, torch.float32, (B,), dev)
    _build.check(cdf_tab, "cdf_tab", torch.float32, (R, C), dev)
    _build.check(prob_tab, "prob_tab", torch.float32, (R, C), dev)
    if R & (R - 1):
        raise ValueError(f"HPT rows must be a power of two, got {R}")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "hpt_locate", "lits_hpt_locate", [P, P, P, P, P, P, P, P, I, I, I, I, I, P],
        qbytes.data_ptr(), qlens.data_ptr(), start.data_ptr(), alpha.data_ptr(),
        beta.data_ptr(), nslots.data_ptr(), cdf_tab.data_ptr(), prob_tab.data_ptr(),
        B, L, R, C, int(max_steps), out.data_ptr())
    _build.count_launch("hpt_locate")
    return out


def hpt_locate(qbytes, qlens, start, alpha, beta, nslots, *, cdf_tab, prob_tab,
               max_steps: int = MAX_CDF_STEPS) -> torch.Tensor:
    """Slot positions: K1 for CUDA tensors, the plain version for CPU ones.
    Scalars broadcast over the batch."""
    with span("lits.kernels.hpt_locate"):
        if not qbytes.is_cuda:
            return hpt_locate_plain(qbytes, qlens, start, alpha, beta, nslots,
                                    cdf_tab, prob_tab, max_steps)
        B, dev = qbytes.shape[0], qbytes.device
        i32 = lambda v: _build.as_rows(v, B, torch.int32, dev)
        f32 = lambda v: _build.as_rows(v, B, torch.float32, dev)
        return hpt_locate_cuda(qbytes, i32(qlens), i32(start), f32(alpha), f32(beta),
                               i32(nslots), cdf_tab, prob_tab, max_steps)
