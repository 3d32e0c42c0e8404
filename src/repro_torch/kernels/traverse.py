"""K4: the fused LITS point lookup (paper Alg. 2, whole walk).

Replaces ``repro/kernels/traverse.py::_fused_kernel``.  The kernel is
``csrc/traverse.cu``: one thread walks one query to its terminal item and
resolves it, with K1's locate and the one-thread form of K3's probe inline
(``lits::probe_first``: a chunk's hash codes loaded at once, then key
compares on the set bits of its match mask); it reads the HPT as one
interleaved (cdf, prob) table (:func:`paired_table`).  The plain version is
:func:`repro_torch.core.walk.walk_terminal` + ``resolve_terminal``.  Both
return ``(found, eid, levels)``; the delta-buffer probe stays outside, as
in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.walk import resolve_terminal, walk_terminal

from . import _build

_P, _N = ctypes.c_void_p, ctypes.c_longlong

# (field, dtype) groups that share one length; order matches LitsPools in
# csrc/traverse.cu
_POOL_GROUPS = (
    ("n_items", (("items", torch.int32),)),
    ("n_mn", (("mn_slot_base", torch.int32), ("mn_slot_cnt", torch.int32),
              ("mn_prefix_off", torch.int32), ("mn_prefix_len", torch.int32),
              ("mn_alpha", torch.float32), ("mn_beta", torch.float32))),
    ("n_tr", (("tr_byte", torch.int32), ("tr_mask", torch.int32),
              ("tr_left", torch.int32), ("tr_right", torch.int32))),
    ("n_cn", (("cn_base", torch.int32), ("cn_cnt", torch.int32))),
    ("n_ch", (("ch_hash", torch.int32), ("ch_ent", torch.int32))),
    ("n_key", (("key_bytes", torch.uint8),)),
    ("n_ent", (("ent_off", torch.int32), ("ent_len", torch.int32))),
)


class LitsPools(ctypes.Structure):
    _fields_ = ([("root_item", _P)]
                + [f for n, group in _POOL_GROUPS
                   for f in [(name, _P) for name, _ in group] + [(n, _N)]]
                + [("cp_tab", _P), ("R", _N), ("C", _N)])


def paired_table(cdf_tab: torch.Tensor, prob_tab: torch.Tensor) -> torch.Tensor:
    """(R, C, 2) float32: ``cdf_tab`` and ``prob_tab`` interleaved, a
    bit-exact copy, so that a GetCDF step reads its pair as one 8-byte load
    (kept by :func:`_build.derived`)."""
    return _build.derived("paired_table", (cdf_tab, prob_tab),
                          lambda c, p: torch.stack([c, p], dim=-1).contiguous())


def _pools(ti, dev) -> LitsPools:
    """Check every pool the kernel reads and gather their pointers."""
    _build.check(ti.root_item, "root_item", torch.int32, (), dev)
    kw = {"root_item": ti.root_item.data_ptr()}
    for n_name, group in _POOL_GROUPS:
        n = getattr(ti, group[0][0]).shape[0]
        if n == 0:
            raise ValueError(f"{group[0][0]}: empty pool (freeze pads every pool to one element)")
        for name, dtype in group:
            t = getattr(ti, name)
            _build.check(t, name, dtype, (n,), dev)
            kw[name] = t.data_ptr()
        kw[n_name] = n
    R, C = ti.cdf_tab.shape
    _build.check(ti.cdf_tab, "cdf_tab", torch.float32, (R, C), dev)
    _build.check(ti.prob_tab, "prob_tab", torch.float32, (R, C), dev)
    if R & (R - 1):
        raise ValueError(f"HPT rows must be a power of two, got {R}")
    return LitsPools(cp_tab=paired_table(ti.cdf_tab, ti.prob_tab).data_ptr(), R=R, C=C, **kw)


def fused_search_cuda(ti, qbytes, qlens):
    """Launch K4 on (B, width) uint8 rows and (B,) int32 lengths."""
    B, W = qbytes.shape
    dev = qbytes.device
    if W != ti.width:
        raise ValueError(f"query width {W} != index width {ti.width}")
    _build.check(qbytes, "qbytes", torch.uint8, (B, W), dev)
    _build.check(qlens, "qlens", torch.int32, (B,), dev)
    pools = _pools(ti, dev)
    padded, wide = _build.wide_rows(qbytes, 1)  # held past the launch
    found = torch.empty(B, dtype=torch.int32, device=dev)
    eid = torch.empty(B, dtype=torch.int32, device=dev)
    levels = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        I = ctypes.c_int
        _build.launch("traverse", "lits_fused_search",
                      [ctypes.POINTER(LitsPools), _P, _P, I, I, I, I, I, _P, _P, _P, _P, I],
                      ctypes.byref(pools), qbytes.data_ptr(), qlens.data_ptr(), B, W,
                      ti.max_iters, ti.cnode_cap, ti.cdf_steps,
                      found.data_ptr(), eid.data_ptr(), levels.data_ptr(), *wide)
        _build.count_launch("fused_search")
    return found != 0, eid, levels


def fused_search_plain(ti, qbytes, qlens, *, trace=None):
    """The same walk in tensor ops (:mod:`repro_torch.core.walk`).  A
    ``trace`` dict receives each query's terminal item as ``"item"``."""
    item, levels = walk_terminal(
        qbytes, qlens, ti.root_item,
        ti.items, ti.mn_slot_base, ti.mn_slot_cnt, ti.mn_prefix_off,
        ti.mn_prefix_len, ti.mn_alpha, ti.mn_beta,
        ti.tr_byte, ti.tr_mask, ti.tr_left, ti.tr_right,
        ti.key_bytes, ti.cdf_tab, ti.prob_tab,
        width=ti.width, max_iters=ti.max_iters, cdf_steps=ti.cdf_steps,
    )
    if trace is not None:
        trace["item"] = item
    found, eid = resolve_terminal(
        qbytes, qlens, item,
        ti.cn_base, ti.cn_cnt, ti.ch_hash, ti.ch_ent,
        ti.key_bytes, ti.ent_off, ti.ent_len,
        cnode_cap=ti.cnode_cap,
    )
    return found, eid, levels


def fused_search(ti, qbytes, qlens):
    """Whole-walk lookup over a TensorIndex: ``(found, eid, levels)``.  K4 for
    CUDA tensors, the plain version for CPU ones."""
    if qbytes.is_cuda:
        return fused_search_cuda(ti, qbytes, qlens.to(torch.int32).contiguous())
    return fused_search_plain(ti, qbytes, qlens)
