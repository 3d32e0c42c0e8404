"""The walks over flat pools in tensor ops — the plain versions of K4-K6.

``walk_terminal`` (tagged dispatch + HPT-CDF locate + critbit step, with the
early-exit loop and per-query level counter) and ``resolve_terminal``
(ENTRY string equality + compact-node h-pointer probe) are the counterparts
of :mod:`repro.core.walk`, with the same clamped indexing and the same
arithmetic; ``rank_sorted`` (K5) and ``scan_merged`` (K6) are the ordered
side.  The kernel wrappers launch the kernels for CUDA tensors and run these
for CPU ones; ``chip_smoke.py`` also runs these on the card to hold the
kernels against them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.hpt_locate import hpt_locate_plain
from repro_torch.kernels.strops import (
    hash16, str_cmp_full, str_cmp_pools, str_cmp_prefix, str_eq, take,
)

from .builder import PAYLOAD_BITS, PAYLOAD_MASK, TAG_CNODE, TAG_ENTRY, TAG_MNODE, TAG_TRIE


def item_tag(item: torch.Tensor) -> torch.Tensor:
    """Tag of an int32 item (a logical shift: the tag never sets bit 31)."""
    return (item.long() & 0xFFFFFFFF) >> PAYLOAD_BITS & 0x7


def item_payload(item: torch.Tensor) -> torch.Tensor:
    return item & PAYLOAD_MASK


def walk_terminal(
    qbytes, qlens, root_item,
    items, mn_slot_base, mn_slot_cnt, mn_prefix_off, mn_prefix_len,
    mn_alpha, mn_beta, tr_byte, tr_mask, tr_left, tr_right,
    key_bytes, cdf_tab, prob_tab,
    *, width: int, max_iters: int, cdf_steps: int,
):
    """Walk every query to a terminal item; returns ``(item, levels)``, where
    ``levels`` counts the steps each query took (at most ``max_iters``)."""
    B = qbytes.shape[0]
    item = root_item.to(torch.int32).expand(B).clone()
    levels = torch.zeros(B, dtype=torch.int32, device=qbytes.device)
    qlw = torch.clamp(qlens, max=width)
    for _ in range(max_iters):
        tag = item_tag(item)
        active = (tag == TAG_MNODE) | (tag == TAG_TRIE)
        if not bool(active.any()):
            break
        pay = item_payload(item)
        # ---- model-based node step (paper Alg. 2 `locate`) ----
        nid = pay.clamp(max=mn_slot_base.shape[0] - 1)
        pl = take(mn_prefix_len, nid)
        m = take(mn_slot_cnt, nid)
        cmp = str_cmp_prefix(qbytes, key_bytes, take(mn_prefix_off, nid), pl)
        pos = hpt_locate_plain(qbytes, qlens, pl, take(mn_alpha, nid), take(mn_beta, nid),
                               m, cdf_tab, prob_tab, max_steps=cdf_steps)
        pos = torch.where(cmp < 0, 0, torch.where(cmp > 0, m - 1, pos))
        mnext = take(items, take(mn_slot_base, nid) + pos)
        # ---- critbit subtrie step ----
        tid = pay.clamp(max=tr_byte.shape[0] - 1)
        cb = take(tr_byte, tid)
        qc = qbytes.gather(1, cb.long().clamp(0, width - 1)[:, None])[:, 0].int()
        qc = torch.where(cb < qlw, qc, 0)
        bit = (qc & take(tr_mask, tid)) != 0
        tnext = torch.where(bit, take(tr_right, tid), take(tr_left, tid))
        item = torch.where(tag == TAG_MNODE, mnext, torch.where(tag == TAG_TRIE, tnext, item))
        levels = levels + active.int()
    return item, levels


def resolve_terminal(
    qbytes, qlens, item,
    cn_base, cn_cnt, ch_hash, ch_ent, key_bytes, ent_off, ent_len,
    *, cnode_cap: int,
):
    """EMPTY/ENTRY/CNODE terminal item -> ``(found, eid)``; eid is -1 on a miss."""
    tag = item_tag(item)
    pay = item_payload(item)
    # ENTRY
    eid = pay.clamp(max=ent_off.shape[0] - 1)
    ent_ok = (tag == TAG_ENTRY) & str_eq(qbytes, qlens, key_bytes,
                                         take(ent_off, eid), take(ent_len, eid))
    # CNODE: the first of up to cnode_cap h-pointers whose hash and key match
    cid = pay.clamp(max=cn_base.shape[0] - 1)
    base = take(cn_base, cid)
    cnt = take(cn_cnt, cid)
    qh = hash16(qbytes, qlens)
    cfound = torch.zeros_like(ent_ok)
    ceid = torch.zeros_like(eid)
    for j in range(cnode_cap):
        sidx = base + j
        cand = take(ch_ent, sidx)
        hmatch = (j < cnt) & (take(ch_hash, sidx) == qh) & (tag == TAG_CNODE)
        eq = hmatch & str_eq(qbytes, qlens, key_bytes, take(ent_off, cand), take(ent_len, cand))
        ceid = torch.where(eq & ~cfound, cand, ceid)
        cfound = cfound | eq
    found = ent_ok | cfound
    out_eid = torch.where(ent_ok, eid, torch.where(cfound, ceid, -1))
    return found, out_eid


def rank_sorted(qbytes, qlens, ent_sorted, ent_off, ent_len, key_bytes,
                *, rank_iters: int, n_live=None, trace=None):
    """First rank r with key(ent_sorted[r]) >= query: a binary search of
    exactly ``rank_iters`` steps, each a full strcmp.  ``n_live`` (a 0-d
    tensor) bounds the search to the first ``n_live`` rows (the live region
    of the sorted delta view); ``None`` searches the whole table.  A lane
    with ``lo >= hi`` keeps ``lo``.  A ``trace`` list gets, per step, the
    (B,) entries compared and the (B,) mask of lanes still searching."""
    B = qbytes.shape[0]
    dev = qbytes.device
    n = ent_sorted.shape[0]
    lo = torch.zeros(B, dtype=torch.int32, device=dev)
    hi = (torch.full((B,), n, dtype=torch.int32, device=dev) if n_live is None
          else n_live.to(torch.int32).expand(B))
    for _ in range(rank_iters):
        mid = (lo + hi) // 2
        e = take(ent_sorted, mid.clamp(max=n - 1))
        if trace is not None:
            trace.append((e, lo < hi))
        cmp = str_cmp_full(qbytes, qlens, key_bytes, take(ent_off, e), take(ent_len, e))
        go_right = (cmp > 0) & (lo < hi)
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right | (lo >= hi), hi, mid)
    return lo


def delta_rank_iters(dcap: int) -> int:
    """Binary-search trip count covering a delta pool of ``dcap`` slots."""
    return int(math.ceil(math.log2(max(dcap, 2)))) + 2


def scan_merged(qbytes, qlens, ent_sorted, ent_off, ent_len, key_bytes, n_base,
                ds_order, de_off, de_len, db_bytes, de_tomb, n_delta,
                *, window: int, rank_iters: int, trace=None):
    """Delta-aware range scan: the next ``window`` live keys >= each query,
    a two-way merge of ``ent_sorted[rank:n_base]`` with the sorted delta view
    ``ds_order[rank:n_delta]`` (``n_base``, ``n_delta``: 0-d tensors).

    An equal delta key shadows the base key (both advance; the delta entry
    is emitted if live, swallowed if a tombstone); a smaller live delta
    entry is emitted, a smaller tombstone skipped; otherwise the base entry
    is emitted.  With no delta entries the window is one contiguous slice of
    the frozen order.  The merge runs batch-wide with every lane gated on
    its own ``active``, so a lane's result does not depend on the others.

    Returns ``(eids, valid, is_delta)``, each ``(B, window)``; ``eids`` are
    base entry ids where ``~is_delta``, delta entry ids where ``is_delta``,
    and -1 where invalid.  A ``trace`` dict gets the two ranks' traces
    (see :func:`rank_sorted`) under ``"base"`` and ``"delta"``, and under
    ``"merge"``, per merge step, the (B,) base and delta entries at the
    heads of the two streams with the (B,) masks of lanes that read the
    base head, read the delta head, and take the delta head.
    """
    tr = (lambda k: None) if trace is None else (lambda k: trace.setdefault(k, []))
    B, W = qbytes.shape
    dev = qbytes.device
    n_arr, d_arr = ent_sorted.shape[0], ds_order.shape[0]
    n_base = n_base.to(torch.int32)
    n_delta = n_delta.to(torch.int32)
    bi = rank_sorted(qbytes, qlens, ent_sorted, ent_off, ent_len, key_bytes,
                     rank_iters=rank_iters, trace=tr("base"))
    cols = torch.arange(window, dtype=torch.int32, device=dev)[None, :]
    if not bool(n_delta > 0):
        idx = bi[:, None] + cols
        valid = idx < n_base
        eids = take(ent_sorted, idx.clamp(max=n_arr - 1))
        return (torch.where(valid, eids, -1), valid,
                torch.zeros((B, window), dtype=torch.bool, device=dev))
    di = rank_sorted(qbytes, qlens, ds_order, de_off, de_len, db_bytes,
                     rank_iters=delta_rank_iters(d_arr), n_live=n_delta, trace=tr("delta"))
    k = torch.zeros(B, dtype=torch.int32, device=dev)
    oe = torch.full((B, window), -1, dtype=torch.int32, device=dev)
    ov = torch.zeros((B, window), dtype=torch.bool, device=dev)
    od = torch.zeros((B, window), dtype=torch.bool, device=dev)
    while bool(((k < window) & ((bi < n_base) | (di < n_delta))).any()):
        b_ok = bi < n_base
        d_ok = di < n_delta
        active = (k < window) & (b_ok | d_ok)
        be = take(ent_sorted, bi.clamp(max=n_arr - 1))
        de = take(ds_order, di.clamp(max=d_arr - 1))
        cmp = str_cmp_pools(db_bytes, take(de_off, de), take(de_len, de),
                            key_bytes, take(ent_off, be), take(ent_len, be), W)
        take_delta = d_ok & (~b_ok | (cmp <= 0))
        if trace is not None:
            tr("merge").append((be, de, active & b_ok, active & d_ok, active & take_delta))
        shadows = take_delta & b_ok & (cmp == 0)
        emit = active & torch.where(take_delta, ~take(de_tomb, de), b_ok)
        slot = emit[:, None] & (cols == k[:, None])
        oe = torch.where(slot, torch.where(take_delta, de, be)[:, None], oe)
        ov = ov | slot
        od = torch.where(slot, take_delta[:, None], od)
        bi = bi + (active & (~take_delta | shadows)).int()
        di = di + (active & take_delta).int()
        k = k + emit.int()
    return oe, ov, od
