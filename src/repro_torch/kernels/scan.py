"""K6: the delta-aware range scan — two ranks and a base/delta merge.

Replaces ``repro/kernels/scan.py::_scan_kernel``.  The kernel is
``csrc/scan.cu``: a group of lanes per query ranks into the frozen order and
the sorted delta view with a multi-way search and merges the two streams
into its window.  The plain version is
:func:`repro_torch.core.walk.scan_merged`.  Both return
``(eids, valid, is_delta)``, each ``(B, window)``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.walk import scan_merged

from repro_torch.spans import span

from . import _build
from .rank import check_order, check_queries, check_rank_iters, order_records

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class ScanPools(ctypes.Structure):
    """Field for field the ``ScanPools`` of ``csrc/scan.cu``."""
    _fields_ = [("ent_sorted", _P), ("n_sorted", _N), ("base_rec", _P), ("key_bytes", _P),
                ("n_key", _N), ("n_base", _P), ("delta_rec", _P), ("n_ds", _N),
                ("db_bytes", _P), ("n_db", _N), ("n_delta", _P)]


def scan_n_base(ti) -> torch.Tensor:
    """Live frozen-entry count, a 0-d int32 tensor: 0 for an EMPTY root,
    whose ``ent_sorted`` holds only the freeze pad."""
    return (ti.root_item != 0).to(torch.int32) * ti.ent_sorted.shape[0]


def fused_scan_cuda(ti, qbytes, qlens, *, window: int):
    """Launch K6 on (B, width) uint8 rows and (B,) int32 lengths."""
    B, W = check_queries(ti, qbytes, qlens)
    dev = qbytes.device
    if window < 1:
        raise ValueError(f"window must be positive, got {window}")
    srt, off, ln, pool = ti.ent_sorted, ti.ent_off, ti.ent_len, ti.key_bytes
    dso, doff, dln, dpool = ti.ds_order, ti.de_off, ti.de_len, ti.db_bytes
    check_order(srt, off, ln, pool, dev)
    check_order(dso, doff, dln, dpool, dev)
    _build.check(ti.de_tomb, "de_tomb", torch.bool, doff.shape, dev)
    _build.check(ti.de_count, "de_count", torch.int32, (), dev)
    check_rank_iters(ti)
    n_base = scan_n_base(ti)
    base_rec = order_records(srt, off, ln)
    delta_rec = order_records(dso, doff, dln, ti.de_tomb)
    pools = ScanPools(ent_sorted=srt.data_ptr(), n_sorted=srt.shape[0],
                      base_rec=base_rec.data_ptr(), key_bytes=pool.data_ptr(),
                      n_key=pool.shape[0], n_base=n_base.data_ptr(),
                      delta_rec=delta_rec.data_ptr(), n_ds=dso.shape[0],
                      db_bytes=dpool.data_ptr(), n_db=dpool.shape[0],
                      n_delta=ti.de_count.data_ptr())
    eids = torch.empty((B, window), dtype=torch.int32, device=dev)
    valid = torch.empty((B, window), dtype=torch.bool, device=dev)
    is_delta = torch.empty((B, window), dtype=torch.bool, device=dev)
    padded, wide = _build.wide_rows(qbytes, 4)  # held past the launch
    if B:
        _build.launch("scan", "lits_scan",
                      [ctypes.POINTER(ScanPools), _P, _P, _I, _I, _I, _P, _P, _P, _P, _I],
                      ctypes.byref(pools), qbytes.data_ptr(), qlens.data_ptr(), B, W, window,
                      eids.data_ptr(), valid.data_ptr(), is_delta.data_ptr(), *wide)
        _build.count_launch("scan")
    return eids, valid, is_delta


def fused_scan_plain(ti, qbytes, qlens, *, window: int, trace=None):
    return scan_merged(qbytes, qlens, ti.ent_sorted, ti.ent_off, ti.ent_len, ti.key_bytes,
                       scan_n_base(ti), ti.ds_order, ti.de_off, ti.de_len, ti.db_bytes,
                       ti.de_tomb, ti.de_count, window=window, rank_iters=ti.rank_iters,
                       trace=trace)


def fused_scan(ti, qbytes, qlens, *, window: int):
    """``(eids, valid, is_delta)`` windows: K6 for CUDA tensors, the plain
    version for CPU ones."""
    with span("lits.kernels.scan"):
        if qbytes.is_cuda:
            return fused_scan_cuda(ti, qbytes, qlens.to(torch.int32).contiguous(),
                                   window=window)
        return fused_scan_plain(ti, qbytes, qlens, window=window)
