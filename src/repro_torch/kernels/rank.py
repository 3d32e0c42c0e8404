"""K5: ordered rank — the first rank r with key(ent_sorted[r]) >= query.

Replaces ``repro/kernels/rank.py::_rank_kernel``.  The kernel is
``csrc/rank.cu``: one thread per query runs the ``rank_iters``-step binary
search of ``csrc/lits_rank.cuh`` (which K6 calls too).  The plain version is
:func:`repro_torch.core.walk.rank_sorted`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.walk import rank_sorted

from . import _build

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def check_order(srt, off, ln, pool, dev) -> None:
    """Check one sorted order with its (off, len) tables and byte pool."""
    _build.check(srt, "sorted order", torch.int32, (srt.shape[0],), dev)
    _build.check(off, "entry offsets", torch.int32, (off.shape[0],), dev)
    _build.check(ln, "entry lengths", torch.int32, off.shape, dev)
    _build.check(pool, "byte pool", torch.uint8, (pool.shape[0],), dev)
    for t, name in ((srt, "sorted order"), (off, "entry offsets"), (pool, "byte pool")):
        if t.shape[0] == 0:
            raise ValueError(f"{name}: empty pool (freeze pads every pool to one element)")


def check_queries(ti, qbytes, qlens):
    B, W = qbytes.shape
    if W != ti.width:
        raise ValueError(f"query width {W} != index width {ti.width}")
    _build.check(qbytes, "qbytes", torch.uint8, (B, W), qbytes.device)
    _build.check(qlens, "qlens", torch.int32, (B,), qbytes.device)
    return B, W


def fused_rank_cuda(ti, qbytes, qlens) -> torch.Tensor:
    """Launch K5 on (B, width) uint8 rows and (B,) int32 lengths."""
    B, W = check_queries(ti, qbytes, qlens)
    dev = qbytes.device
    srt, off, ln, pool = ti.ent_sorted, ti.ent_off, ti.ent_len, ti.key_bytes
    check_order(srt, off, ln, pool, dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        _build.launch("rank", "lits_rank", [_P, _P, _P, _N, _P, _P, _N, _P, _N, _I, _I, _I, _P],
                      qbytes.data_ptr(), qlens.data_ptr(), srt.data_ptr(), srt.shape[0],
                      off.data_ptr(), ln.data_ptr(), off.shape[0], pool.data_ptr(),
                      pool.shape[0], B, W, ti.rank_iters, out.data_ptr())
        _build.LAUNCHES["rank"] += 1
    return out


def fused_rank_plain(ti, qbytes, qlens, *, trace=None) -> torch.Tensor:
    return rank_sorted(qbytes, qlens, ti.ent_sorted, ti.ent_off, ti.ent_len, ti.key_bytes,
                       rank_iters=ti.rank_iters, trace=trace)


def fused_rank(ti, qbytes, qlens) -> torch.Tensor:
    """(B,) int32 ranks into ``ti.ent_sorted``: K5 for CUDA tensors, the
    plain version for CPU ones."""
    if qbytes.is_cuda:
        return fused_rank_cuda(ti, qbytes, qlens.to(torch.int32).contiguous())
    return fused_rank_plain(ti, qbytes, qlens)
