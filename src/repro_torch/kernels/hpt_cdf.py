"""K2: batched HPT GetCDF (paper Alg. 1) — CUDA kernel and its plain version.

Replaces ``repro/kernels/hpt_cdf.py::_cdf_kernel_gather``.  The kernel is
``csrc/hpt_cdf.cu``: one thread per query walks its suffix, reading the two
HPT tables from device memory.  The plain version is the reference
``get_cdf_impl`` in tensor ops.

Numerics: ``cdf += prob * cval`` is two separately rounded float32 ops (the
reference does not contract it to an FMA), and ``prob *= pval``.  A step is
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
        cdf = cdf + torch.where(active, prob * cval, 0.0)
        prob = prob * torch.where(active, pval, 1.0)
        h = torch.where(active, ((h ^ c) * FNV_PRIME) & U32, h)
    return cdf


def hpt_cdf_cuda(qbytes, qlens, start, cdf_tab, prob_tab,
                 max_steps: int = MAX_CDF_STEPS) -> torch.Tensor:
    """Launch K2.  ``qlens``/``start`` are (B,) int32; tables (R, C) float32."""
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
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "hpt_cdf", "lits_hpt_cdf", [P, P, P, P, P, I, I, I, I, I, P],
        qbytes.data_ptr(), qlens.data_ptr(), start.data_ptr(), cdf_tab.data_ptr(),
        prob_tab.data_ptr(), B, L, R, C, int(max_steps), out.data_ptr())
    _build.LAUNCHES["hpt_cdf"] += 1
    return out


def hpt_cdf(qbytes, qlens, start=0, *, cdf_tab, prob_tab,
            max_steps: int = MAX_CDF_STEPS) -> torch.Tensor:
    """Batched GetCDF: K2 for CUDA tensors, the plain version for CPU ones."""
    B = qbytes.shape[0]
    if qbytes.is_cuda:
        return hpt_cdf_cuda(qbytes, _build.as_rows(qlens, B, torch.int32, qbytes.device),
                            _build.as_rows(start, B, torch.int32, qbytes.device),
                            cdf_tab, prob_tab, max_steps)
    return hpt_cdf_plain(qbytes, qlens, start, cdf_tab, prob_tab, max_steps)
