"""K5: ordered rank — the first rank r with key(ent_sorted[r]) >= query.

Replaces ``repro/kernels/rank.py::_rank_kernel``.  The kernel is
``csrc/rank.cu``, the rank half of K6: the block stages its query rows in
shared memory, and a group of 4 lanes per query runs the multi-way search
``lits::group_rank`` (``csrc/lits_words.cuh``) over one 16-byte record per
rank (:func:`order_records`, shared with K6).  The plain
version is :func:`repro_torch.core.walk.rank_sorted`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.walk import rank_sorted

from repro_torch.spans import span

from . import _build

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def order_records(order, off, ln, tomb=None) -> torch.Tensor:
    """(n, 4) int32: per rank r of a sorted order, the entry id
    ``order[r]``, its key's offset and length and its tombstone flag (0
    without ``tomb``), so that a search step or a merge head reads them in
    one 16-byte load.  The entry index is clamped into the tables, as the
    reference's gathers clip.  Kept by :func:`_build.derived`, so K5 and K6
    share the table of ``ent_sorted``."""
    def make(order, off, ln, *tomb):
        e = order.long().clamp(0, off.shape[0] - 1)
        flag = tomb[0][e].to(torch.int32) if tomb else torch.zeros_like(order)
        return torch.stack([order, off[e], ln[e], flag], dim=1).contiguous()

    return _build.derived("order_records", (order, off, ln) + ((tomb,) if tomb is not None
                                                               else ()), make)


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


def check_rank_iters(ti) -> None:
    """Refuse a ``rank_iters`` that a halving search of ``ent_sorted`` would
    stop short with.  The kernels' multi-way search returns the lower bound,
    as a halving search of at least ceil(log2(n + 1)) steps does."""
    n = ti.ent_sorted.shape[0]
    if ti.rank_iters < n.bit_length():
        raise ValueError(f"rank_iters {ti.rank_iters} is too few for {n} sorted rows")


def fused_rank_cuda(ti, qbytes, qlens) -> torch.Tensor:
    """Launch K5 on (B, width) uint8 rows and (B,) int32 lengths."""
    B, W = check_queries(ti, qbytes, qlens)
    dev = qbytes.device
    srt, off, ln, pool = ti.ent_sorted, ti.ent_off, ti.ent_len, ti.key_bytes
    check_order(srt, off, ln, pool, dev)
    check_rank_iters(ti)
    rec = order_records(srt, off, ln)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    padded, wide = _build.wide_rows(qbytes, 4)  # held past the launch
    if B:
        _build.launch("rank", "lits_rank", [_P, _N, _P, _N, _P, _P, _I, _I, _P, _P, _I],
                      rec.data_ptr(), rec.shape[0], pool.data_ptr(), pool.shape[0],
                      qbytes.data_ptr(), qlens.data_ptr(), B, W, out.data_ptr(), *wide)
        _build.count_launch("rank")
    return out


def fused_rank_plain(ti, qbytes, qlens, *, trace=None) -> torch.Tensor:
    return rank_sorted(qbytes, qlens, ti.ent_sorted, ti.ent_off, ti.ent_len, ti.key_bytes,
                       rank_iters=ti.rank_iters, trace=trace)


def fused_rank(ti, qbytes, qlens) -> torch.Tensor:
    """(B,) int32 ranks into ``ti.ent_sorted``: K5 for CUDA tensors, the
    plain version for CPU ones."""
    with span("lits.kernels.rank"):
        if qbytes.is_cuda:
            return fused_rank_cuda(ti, qbytes, qlens.to(torch.int32).contiguous())
        return fused_rank_plain(ti, qbytes, qlens)
