"""The Alg. 2 walk over flat pools in tensor ops — the plain version of K4.

``walk_terminal`` (tagged dispatch + HPT-CDF locate + critbit step, with the
early-exit loop and per-query level counter) and ``resolve_terminal``
(ENTRY string equality + compact-node h-pointer probe) are the counterparts
of :mod:`repro.core.walk`, with the same clamped indexing and the same
arithmetic.  ``repro_torch.kernels.traverse`` launches K4 for CUDA tensors
and runs these for CPU ones; ``chip_smoke.py`` also runs these on the card
to hold K4 against them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hpt_locate import hpt_locate_plain
from repro_torch.kernels.strops import hash16, str_cmp_prefix, str_eq, take

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
