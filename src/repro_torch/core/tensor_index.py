"""Device-resident LITS: frozen structure-of-arrays pools + batched lookups.

``freeze`` exports a :class:`TensorIndex` (a dataclass of flat tensors on
one device) from a host :class:`~repro_torch.core.builder.LITSBuilder`.  It
has the data fields and ``STATIC_FIELDS`` of :class:`repro.core.tensor_index.TensorIndex`.
The reference's operations:

* :func:`search_batch`  — paper Alg. 2, batched point lookup with the
  delta-buffer probe
* :func:`base_search`   — the walk + terminal resolve, no delta probe
* :func:`lookup_values` — (lo, hi) 2×int32 value fetch
* :func:`rank_batch`    — ordered rank into the frozen order
* :func:`scan_batch`    — delta-aware range scans (read-your-writes)
* :func:`insert_batch` / :func:`delete_batch` — the write path: upserts and
  tombstones in the delta buffer, in op order
* :func:`delta_sort_order` — the sorted view of the claimed delta entries
* :func:`merge_delta` — compaction: the delta replayed into the host
  builder, then a refreeze

The tensors' device decides the kernels: K4 (``csrc/traverse.cu``), K5
(``csrc/rank.cu``) and K6 (``csrc/scan.cu``) on the card, the plain
:mod:`repro_torch.core.walk` on the CPU.  The delta probe and the write
path are plain tensor code on either, as the reference keeps them outside
its kernels.

Dtypes follow the reference, except ``de_hash``: the reference's uint32
hashes are held as int64 in [0, 2**32), which torch compares exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import fused_rank, fused_scan, fused_search
from repro_torch.kernels.strops import gather_bytes, hash32, str_eq, take
from repro_torch.spans import add, span

from .builder import LITSBuilder
from .hpt import MAX_CDF_STEPS

STATIC_FIELDS = ("width", "max_iters", "cnode_cap", "rank_iters",
                 "delta_probes", "cdf_steps")

# every data field with its dtype in the port
DATA_FIELDS = {
    "items": torch.int32, "mn_slot_base": torch.int32, "mn_slot_cnt": torch.int32,
    "mn_prefix_off": torch.int32, "mn_prefix_len": torch.int32,
    "mn_alpha": torch.float32, "mn_beta": torch.float32,
    "cn_base": torch.int32, "cn_cnt": torch.int32, "ch_hash": torch.int32,
    "ch_ent": torch.int32, "tr_byte": torch.int32, "tr_mask": torch.int32,
    "tr_left": torch.int32, "tr_right": torch.int32, "key_bytes": torch.uint8,
    "ent_off": torch.int32, "ent_len": torch.int32, "ent_val_lo": torch.int32,
    "ent_val_hi": torch.int32, "ent_sorted": torch.int32,
    "cdf_tab": torch.float32, "prob_tab": torch.float32, "root_item": torch.int32,
    "db_bytes": torch.uint8, "db_used": torch.int32, "de_off": torch.int32,
    "de_len": torch.int32, "de_val_lo": torch.int32, "de_val_hi": torch.int32,
    "de_hash": torch.int64, "de_tomb": torch.bool, "de_count": torch.int32,
    "dh_slot": torch.int32, "ds_order": torch.int32, "delta_overflow": torch.bool,
    "epoch": torch.int32,
}


@dataclasses.dataclass
class TensorIndex:
    # base structure
    items: torch.Tensor
    mn_slot_base: torch.Tensor
    mn_slot_cnt: torch.Tensor
    mn_prefix_off: torch.Tensor
    mn_prefix_len: torch.Tensor
    mn_alpha: torch.Tensor
    mn_beta: torch.Tensor
    cn_base: torch.Tensor
    cn_cnt: torch.Tensor
    ch_hash: torch.Tensor
    ch_ent: torch.Tensor
    tr_byte: torch.Tensor
    tr_mask: torch.Tensor
    tr_left: torch.Tensor
    tr_right: torch.Tensor
    key_bytes: torch.Tensor
    ent_off: torch.Tensor
    ent_len: torch.Tensor
    ent_val_lo: torch.Tensor
    ent_val_hi: torch.Tensor
    ent_sorted: torch.Tensor
    cdf_tab: torch.Tensor
    prob_tab: torch.Tensor
    root_item: torch.Tensor
    # delta buffer (log-structured inserts; written by the write path)
    db_bytes: torch.Tensor
    db_used: torch.Tensor
    de_off: torch.Tensor
    de_len: torch.Tensor
    de_val_lo: torch.Tensor
    de_val_hi: torch.Tensor
    de_hash: torch.Tensor
    de_tomb: torch.Tensor
    de_count: torch.Tensor
    dh_slot: torch.Tensor
    ds_order: torch.Tensor
    delta_overflow: torch.Tensor
    epoch: torch.Tensor
    # static metadata
    width: int
    max_iters: int
    cnode_cap: int
    rank_iters: int
    delta_probes: int
    cdf_steps: int

    @property
    def n_entries(self) -> int:
        return self.ent_off.shape[0]

    @property
    def device(self) -> torch.device:
        return self.items.device

    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in DATA_FIELDS)


def tensor_index_from_arrays(arrays: dict, static: dict, device) -> TensorIndex:
    """A TensorIndex from numpy arrays (one per data field, any integer or
    float dtype that holds the values) and the static fields."""
    np_dtypes = {torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32,
                 torch.uint8: np.uint8, torch.bool: np.bool_}
    with span("lits.ti.upload"):
        fields = {
            name: torch.from_numpy(np.array(arrays[name], dtype=np_dtypes[dt],
                                            order="C")).to(device)
            for name, dt in DATA_FIELDS.items()
        }
        return TensorIndex(**fields, **{k: int(static[k]) for k in STATIC_FIELDS})


# ---------------------------------------------------------------------------
# freeze
# ---------------------------------------------------------------------------

def _nz(a: np.ndarray, dtype) -> np.ndarray:
    """Pool as ``dtype``, padded to at least one element."""
    a = np.asarray(a, dtype=dtype)
    return np.zeros(1, dtype=dtype) if a.shape[0] == 0 else a


def freeze(
    b: LITSBuilder,
    delta_capacity: int = 4096,
    delta_bytes: int | None = None,
    delta_probes: int = 16,
    epoch: int = 0,
    device=None,
) -> TensorIndex:
    """Lay the builder's pools out on ``device`` (default: the builder's)."""
    with span("lits.ti.freeze"):
        arrays, static = _layout(b, delta_capacity, delta_bytes, delta_probes, epoch)
    return tensor_index_from_arrays(arrays, static, b.device if device is None else device)


def _layout(b: LITSBuilder, delta_capacity: int, delta_bytes, delta_probes: int, epoch: int):
    """The host arrays and static fields :func:`freeze` uploads."""
    heights = b.height_bound()
    n = max(b.ent_off.n, 1)
    ent_sorted = np.asarray(b.sorted_eids(), dtype=np.int32)
    if ent_sorted.size == 0:
        ent_sorted = np.zeros(1, np.int32)
    dcap = max(delta_capacity, 8)
    hcap = 1 << int(math.ceil(math.log2(dcap * 2)))
    dbcap = delta_bytes if delta_bytes is not None else dcap * max(b.width, 16) + b.width
    hpt = b.hpt
    arrays = dict(
        items=_nz(b.items.view(), np.int32),
        mn_slot_base=_nz(b.mn_slot_base.view(), np.int32),
        mn_slot_cnt=_nz(b.mn_slot_cnt.view(), np.int32),
        mn_prefix_off=_nz(b.mn_prefix_off.view(), np.int32),
        mn_prefix_len=_nz(b.mn_prefix_len.view(), np.int32),
        mn_alpha=_nz(b.mn_alpha.view(), np.float32),
        mn_beta=_nz(b.mn_beta.view(), np.float32),
        cn_base=_nz(b.cn_base.view(), np.int32),
        cn_cnt=_nz(b.cn_cnt.view(), np.int32),
        ch_hash=_nz(b.ch_hash.view().astype(np.int32), np.int32),
        ch_ent=_nz(b.ch_ent.view(), np.int32),
        tr_byte=_nz(b.tr_byte.view(), np.int32),
        tr_mask=_nz(b.tr_mask.view().astype(np.int32), np.int32),
        tr_left=_nz(b.tr_left.view(), np.int32),
        tr_right=_nz(b.tr_right.view(), np.int32),
        # the key pool is padded with width + 1 zeros
        key_bytes=np.concatenate([b.key_bytes.view(), np.zeros(b.width + 1, np.uint8)]),
        ent_off=_nz(b.ent_off.view().astype(np.int32), np.int32),
        ent_len=_nz(b.ent_len.view(), np.int32),
        ent_val_lo=_nz((b.ent_val.view() & 0xFFFFFFFF).astype(np.uint32).view(np.int32), np.int32),
        ent_val_hi=_nz((b.ent_val.view() >> 32).astype(np.int32), np.int32),
        ent_sorted=ent_sorted,
        cdf_tab=hpt.cdf_tab if hpt is not None else np.zeros((1, 128), np.float32),
        prob_tab=hpt.prob_tab if hpt is not None else np.full((1, 128), 1 / 128, np.float32),
        root_item=np.int32(b.root_item),
        db_bytes=np.zeros(dbcap, np.uint8),
        db_used=np.int32(0),
        de_off=np.zeros(dcap, np.int32),
        de_len=np.zeros(dcap, np.int32),
        de_val_lo=np.zeros(dcap, np.int32),
        de_val_hi=np.zeros(dcap, np.int32),
        de_hash=np.zeros(dcap, np.int64),
        de_tomb=np.zeros(dcap, bool),
        de_count=np.int32(0),
        dh_slot=np.full(hcap, -1, np.int32),
        ds_order=np.zeros(dcap, np.int32),
        delta_overflow=np.bool_(False),
        epoch=np.int32(epoch),
    )
    static = dict(
        width=int(b.width),
        max_iters=int(heights["base"] + heights["trie"] + 4),
        cnode_cap=int(b.cfg.cnode_cap),
        rank_iters=int(math.ceil(math.log2(n))) + 2,
        delta_probes=delta_probes,
        cdf_steps=int(min(max(b.max_suffix_len, 1), MAX_CDF_STEPS)),
    )
    return arrays, static


def pad_queries(keys, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: list[bytes] -> zero-padded (B, width) uint8 + true lens.

    The rows are a new, writeable, C-contiguous array, packed in one
    conversion of the whole batch; keys that are not exactly ``bytes``
    (bytearray, memoryview, np.bytes_) are copied to ``bytes`` first and
    counted in ``lits.ti.pad_queries.converted``.

    Lengths are clipped to ``width + 1``: the ``width + 1`` value is an
    over-width SENTINEL, not a length.  No stored key can have it, so
    ``str_eq``'s length comparison makes an over-width query miss every
    stored key instead of matching a truncated alias.
    """
    B = len(keys)
    with span("lits.ti.pad_queries", keys=B):
        converted = 0
        if not set(map(type, keys)) <= {bytes}:
            # numpy reads a bytearray as ints; any other buffer (memoryview,
            # np.bytes_) is copied to bytes first, and a str or int raises
            converted = sum(type(k) is not bytes for k in keys)
            keys = [k if type(k) is bytes else bytes(memoryview(k)) for k in keys]
        add("lits.ti.pad_queries.converted", converted)
        # one fixed-width conversion truncates and zero-pads every key
        # (np.fromiter skips np.array's shape discovery; "S0" would mean
        # unsized, so width 0 packs at 1 and keeps no column)
        w = max(width, 1)
        qb = np.fromiter(keys, f"S{w}", B).view(np.uint8).reshape(B, w)[:, :width]
        ql = np.fromiter(map(len, keys), np.int32, B)
        np.minimum(ql, width + 1, out=ql)
        return qb, ql


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _delta_lookup(ti: TensorIndex, qbytes, qlens):
    """Probe the delta buffer: (found, delta_entry_id); ``delta_probes``
    open-addressing slots of ``dh_slot`` from the query's 32-bit hash."""
    with span("lits.ti.delta_probe"):
        B = qbytes.shape[0]
        qh = hash32(qbytes, qlens)
        hcap = ti.dh_slot.shape[0]
        found = torch.zeros(B, dtype=torch.bool, device=qbytes.device)
        did = torch.full((B,), -1, dtype=torch.int32, device=qbytes.device)
        for p in range(ti.delta_probes):
            de = ti.dh_slot[(qh + p) & (hcap - 1)]
            dei = de.clamp(min=0)
            hm = (de >= 0) & (take(ti.de_hash, dei) == qh)
            eq = hm & str_eq(qbytes, qlens, ti.db_bytes, take(ti.de_off, dei), take(ti.de_len, dei))
            did = torch.where(eq & ~found, de, did)
            found = found | eq
        return found, did


def base_search(ti: TensorIndex, qbytes, qlens):
    """Walk + terminal resolve over the frozen base (no delta probe): (found, eid)."""
    found, eid, _levels = fused_search(ti, qbytes, qlens)
    return found, eid


def search_batch(ti: TensorIndex, qbytes, qlens):
    """Batched point lookup. Returns (found, eid, is_delta).

    A tombstoned delta entry shadows its base key: such queries miss.
    """
    dfound, did = _delta_lookup(ti, qbytes, qlens)
    dtomb = dfound & take(ti.de_tomb, did.clamp(min=0))
    bfound, beid = base_search(ti, qbytes, qlens)
    found = torch.where(dfound, ~dtomb, bfound)
    eid = torch.where(dfound, did, beid)
    return found, eid, dfound & ~dtomb


def lookup_values(ti: TensorIndex, eid, is_delta):
    """(lo, hi) int32 halves of each result's value (base or delta entry)."""
    with span("lits.ti.lookup_values"):
        e = eid.clamp(min=0)
        return (torch.where(is_delta, take(ti.de_val_lo, e), take(ti.ent_val_lo, e)),
                torch.where(is_delta, take(ti.de_val_hi, e), take(ti.ent_val_hi, e)))


# ---------------------------------------------------------------------------
# ordered rank + scan
# ---------------------------------------------------------------------------

def rank_batch(ti: TensorIndex, qbytes, qlens):
    """First rank r such that key(ent_sorted[r]) >= query: (B,) int32."""
    return fused_rank(ti, qbytes, qlens)


def scan_batch(ti: TensorIndex, qbytes, qlens, window: int = 16):
    """Delta-aware range scan: the next ``window`` keys >= each query in the
    live index order.  Returns ``(eids, valid, is_delta)``, each
    ``(B, window)``, in the :func:`lookup_values` contract: unmerged delta
    inserts appear in order, tombstoned keys are suppressed."""
    return fused_scan(ti, qbytes, qlens, window=window)


# ---------------------------------------------------------------------------
# the write path: delta-buffer upserts and tombstones
# ---------------------------------------------------------------------------

def delta_sort_order(db_bytes, de_off, de_len, de_count, width: int) -> torch.Tensor:
    """Entry ids of the delta pool in key order (int32, one per slot).

    Keys are zero-masked ``width``-byte windows packed 4 bytes to a
    big-endian word, ordered by word and then by true length: the
    ``str_cmp_full`` order.  Unclaimed slots (``>= de_count``) sort last and
    keep their index order.  A chain of stable sorts from the least
    significant key (length, then the words from last to first, then the
    claimed flag) gives the reference's ``lexsort``; the words sort as
    int64, where they are exact and non-negative.
    """
    dcap = de_off.shape[0]
    dev = de_off.device
    cols = torch.arange(width, device=dev)[None, :]
    kb = torch.where(cols < de_len[:, None], gather_bytes(db_bytes, de_off, width), 0).long()
    pad = (-width) % 4
    if pad:
        kb = torch.cat([kb, kb.new_zeros((dcap, pad))], dim=1)
    w = kb.reshape(dcap, -1, 4)
    packed = (w[:, :, 0] << 24) | (w[:, :, 1] << 16) | (w[:, :, 2] << 8) | w[:, :, 3]
    unclaimed = (torch.arange(dcap, device=dev) >= de_count).int()
    keys = [de_len] + [packed[:, i] for i in range(packed.shape[1] - 1, -1, -1)] + [unclaimed]
    order = torch.arange(dcap, device=dev)
    for key in keys:
        order = order[torch.sort(key[order], stable=True).indices]
    return order.int()


def _sink(t: torch.Tensor) -> torch.Tensor:
    """``t`` with one trailing scratch element: a write aimed past the end
    of ``t`` lands there and is dropped, as the reference's
    ``mode="drop"`` scatters drop it."""
    return torch.cat([t, t.new_zeros(1)])


def _get(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` for a 0-d index tensor, as a 0-d tensor, without a host sync."""
    return t.index_select(0, idx.reshape(1).long()).reshape(())


def _put_at(t: torch.Tensor, idx: torch.Tensor, val) -> None:
    """``t[idx] = val`` for a 0-d index, in place and without a host sync."""
    t.index_put_((idx.reshape(1).long(),), torch.as_tensor(val, dtype=t.dtype,
                                                            device=t.device).reshape(1))


def _base_values(ti: TensorIndex, bfound, beid, is_del, val_lo, val_hi):
    """The base-value update of a batch.  The reference scatters one write
    per op: a base put writes its value at its entry, every other op writes
    the old value at index 0, and duplicate indices resolve last write wins.
    So for each index the op with the highest position writes; found with a
    max over op positions, this is deterministic on every device.  A base
    put to entry 0 followed by any other op in its batch is lost, as in the
    reference."""
    B = bfound.shape[0]
    dev = bfound.device
    if B == 0:
        return ti.ent_val_lo, ti.ent_val_hi
    do_base = bfound & ~is_del
    upd_idx = torch.where(do_base, beid, 0).long()
    pos = torch.arange(B, device=dev)
    winner = torch.full((ti.ent_val_lo.shape[0],), -1, dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(0, upd_idx, pos, reduce="amax")
    wrote = winner >= 0
    w = winner.clamp(min=0)
    out = []
    for field, val in ((ti.ent_val_lo, val_lo), (ti.ent_val_hi, val_hi)):
        new = torch.where(do_base, val, take(field, upd_idx))
        out.append(torch.where(wrote, new[w], field))
    return out


def _mutate_batch(ti: TensorIndex, kbytes, klens, val_lo, val_hi, is_del):
    """The shared body of :func:`insert_batch` and :func:`delete_batch`.

    Ops run in order, each seeing the slots, tombstones and rejects of the
    ones before it.  A put upserts: a base key gets its value updated, a
    delta key its value refreshed and its tombstone cleared (resurrect), an
    unknown key a fresh delta entry.  A delete sets the tombstone of a delta
    key, or claims a tombstone entry for a key that lives only in the base.

    Returns ``(new_ti, in_base, newly, match, prev_live, rejected)``: the
    base walk's hits and, per op, a fresh slot claimed, an existing delta
    entry hit, that entry live before the op, and a needed slot refused
    because the pools were full.  Nothing here syncs with the host.

    The reference re-sorts ``ds_order`` under a ``lax.cond`` only when a
    fresh slot was claimed.  Deciding that here would need a host sync, so
    the sort runs on every batch and its result is kept only where a slot
    was claimed: the same ``ds_order``, with device work wasted on batches
    that claim nothing (delete-only or update-only ones).
    """
    with span("lits.ti.mutate", ops=kbytes.shape[0]):
        return _mutate_ops(ti, kbytes, klens, val_lo, val_hi, is_del)


def _mutate_ops(ti: TensorIndex, kbytes, klens, val_lo, val_hi, is_del):
    B, W = kbytes.shape
    dev = kbytes.device
    klens = klens.to(torch.int32)
    bfound, beid, _ = fused_search(ti, kbytes, klens)
    ent_val_lo, ent_val_hi = _base_values(ti, bfound, beid, is_del, val_lo, val_hi)
    qh = hash32(kbytes, klens)
    hcap, dcap, dbcap = ti.dh_slot.shape[0], ti.de_off.shape[0], ti.db_bytes.shape[0]
    P = ti.delta_probes
    probes = torch.arange(P, device=dev)
    wj = torch.arange(W, device=dev)
    # working copies, each with a trailing sink for dropped writes
    dh_slot, db_bytes = _sink(ti.dh_slot), _sink(ti.db_bytes)
    de_off, de_len = _sink(ti.de_off), _sink(ti.de_len)
    de_vlo, de_vhi = _sink(ti.de_val_lo), _sink(ti.de_val_hi)
    de_hash, de_tomb = _sink(ti.de_hash), _sink(ti.de_tomb)
    db_used, de_count, overflow = ti.db_used, ti.de_count, ti.delta_overflow
    newly, match, prev_live, rejected = [], [], [], []
    for i in range(B):
        kb, kl, h, dele = kbytes[i], klens[i], qh[i], is_del[i]
        # the delta_probes probes at once: first free slot, and the first
        # probe that is free or holds the key, if it holds the key
        slots = (h + probes) & (hcap - 1)
        de = dh_slot[slots]
        free = de < 0
        dei = de.clamp(min=0).long()
        off2 = de_off[dei]
        klen2 = de_len[dei]
        kb2 = db_bytes[(off2[:, None] + wj[None, :]).clamp(max=dbcap - 1)]
        key_eq = (~free & (de_hash[dei] == h)
                  & (torch.where(wj[None, :] < klen2[:, None], kb2, 0) == kb).all(dim=1)
                  & (klen2 == kl))
        first_free = torch.where(free, probes, P).min()
        fslot = torch.where(first_free < P, _get(slots, first_free.clamp(max=P - 1)), -1)
        stop = torch.where(free | key_eq, probes, P).min().clamp(max=P - 1)
        hit = _get(key_eq, stop)
        mde = torch.where(hit, _get(de, stop), 0)
        was_live = hit & ~_get(de_tomb, mde)
        # a matched entry: a put refreshes the value and clears the tombstone,
        # a delete sets the tombstone and keeps the value
        upd = torch.where(hit & ~dele, mde, dcap)
        _put_at(de_vlo, upd, val_lo[i])
        _put_at(de_vhi, upd, val_hi[i])
        _put_at(de_tomb, torch.where(hit, mde, dcap), dele)
        # a fresh slot: a put of an unknown key, or a delete of a key that
        # lives only in the base; over-width keys never get one
        want_new = (kl <= W) & ~hit & torch.where(dele, bfound[i], ~bfound[i])
        can = want_new & (fslot >= 0) & (de_count < dcap) & (db_used + kl <= dbcap)
        did = torch.where(can, de_count, dcap)
        _put_at(dh_slot, torch.where(can, fslot, hcap), de_count)
        widx = torch.where((wj < kl) & can, db_used + wj, dbcap).long()
        db_bytes.index_put_((widx,), kb)
        _put_at(de_off, did, db_used)
        _put_at(de_len, did, kl)
        _put_at(de_vlo, did, val_lo[i])
        _put_at(de_vhi, did, val_hi[i])
        _put_at(de_hash, did, h)
        _put_at(de_tomb, did, dele)
        db_used = torch.where(can, db_used + kl, db_used)
        de_count = torch.where(can, de_count + 1, de_count)
        refused = want_new & ~can
        overflow = overflow | refused
        newly.append(can)
        match.append(hit)
        prev_live.append(was_live)
        rejected.append(refused)
    newly, match, prev_live, rejected = (torch.stack(x) if x else torch.zeros(
        0, dtype=torch.bool, device=dev) for x in (newly, match, prev_live, rejected))
    de_off, de_len = de_off[:-1], de_len[:-1]
    db_bytes = db_bytes[:-1]
    # the claimed key set changes only when a fresh slot was claimed; the
    # reference keeps the old view otherwise, and so does this select
    ds_order = torch.where(newly.any(), delta_sort_order(db_bytes, de_off, de_len, de_count, W),
                           ti.ds_order)
    nti = dataclasses.replace(
        ti, ent_val_lo=ent_val_lo, ent_val_hi=ent_val_hi, dh_slot=dh_slot[:-1],
        db_bytes=db_bytes, db_used=db_used, de_off=de_off, de_len=de_len,
        de_val_lo=de_vlo[:-1], de_val_hi=de_vhi[:-1], de_hash=de_hash[:-1],
        de_tomb=de_tomb[:-1], de_count=de_count, ds_order=ds_order, delta_overflow=overflow)
    return nti, bfound, newly, match, prev_live, rejected


def insert_batch(ti: TensorIndex, kbytes, klens, val_lo, val_hi):
    """Batched upsert.  Returns ``(new_ti, inserted, updated)``.

    Keys in the base get their value updated; new keys go to the delta
    buffer; a put on a tombstoned key resurrects it (inserted).  Over-width
    keys (length ``width + 1``, the ``pad_queries`` sentinel) are rejected,
    both masks False; so are puts that find the delta pools full
    (``new_ti.delta_overflow`` latches).
    """
    B = kbytes.shape[0]
    nti, in_base, newly, match, prev_live, _rej = _mutate_batch(
        ti, kbytes, klens, val_lo.to(torch.int32), val_hi.to(torch.int32),
        torch.zeros(B, dtype=torch.bool, device=kbytes.device))
    return nti, newly | (match & ~prev_live), prev_live | (in_base & ~match)


def delete_batch(ti: TensorIndex, kbytes, klens):
    """Batched delete by delta tombstones.  Returns
    ``(new_ti, deleted, rejected)``: ``deleted`` marks keys that were live
    and are now unpublished; ``rejected`` marks deletes that needed a
    tombstone slot when the pools were full.  Absent and over-width keys
    come back with both masks False."""
    B = kbytes.shape[0]
    z = torch.zeros(B, dtype=torch.int32, device=kbytes.device)
    nti, _in_base, newly, _match, prev_live, rejected = _mutate_batch(
        ti, kbytes, klens, z, z, torch.ones(B, dtype=torch.bool, device=kbytes.device))
    return nti, newly | prev_live, rejected


def delta_fill_fraction(ti: TensorIndex) -> float:
    """Claimed share of the delta entry pool.  Syncs with the device; the
    facade keeps a host mirror instead."""
    return float(ti.de_count) / ti.de_off.shape[0]


def merge_delta(builder: LITSBuilder, ti: TensorIndex, *,
                sync_base_values: bool = False) -> TensorIndex:
    """Compaction: replay the delta buffer into the host builder and refreeze.

    One copy of the three delta scalars, then one of the live delta region
    (never the whole pools); the tombstones replay as one
    ``builder.delete_many``, the live entries as one upserting
    ``builder.insert_many``.  Both bulk ops keep the builder's sorted order
    and height bound, so the refreeze walks nothing whole.

    ``sync_base_values=True`` first copies the base values that
    :func:`insert_batch` updated in place back into the builder, over the
    entries both hold (after an aborted replay the builder may hold more).
    A builder in entry-id lockstep with ``ti`` must pass it, or those
    updates revert; a builder rebuilt from the live pools already has them.

    The returned index, on ``ti``'s device, starts an empty delta buffer of
    the same sizing and carries ``epoch = ti.epoch + 1``.
    """
    with span("lits.merge.copy"):
        cnt, used, epoch = torch.stack(
            [ti.de_count.long(), ti.db_used.long(), ti.epoch.long()]).cpu().tolist()
        if sync_base_values:
            n = min(builder.ent_val.n, ti.ent_val_lo.shape[0])
            if n:
                lo, hi = torch.stack([ti.ent_val_lo[:n], ti.ent_val_hi[:n]]).cpu().numpy()
                builder.ent_val.data[:n] = ((hi.astype(np.int64) << 32)
                                            | lo.view(np.uint32).astype(np.int64))
        if cnt:
            db = ti.db_bytes[: max(used, 1)].cpu().numpy()
            offs, lens, vlo, vhi, tomb = torch.stack([
                ti.de_off[:cnt], ti.de_len[:cnt], ti.de_val_lo[:cnt], ti.de_val_hi[:cnt],
                ti.de_tomb[:cnt].int()]).cpu().numpy()
    if cnt:
        dead = tomb != 0
        with span("lits.merge.replay", keys=int(cnt - dead.sum()), tombstones=int(dead.sum())):
            keys = [db[o: o + n].tobytes() for o, n in zip(offs.tolist(), lens.tolist())]
            vals = (vhi.astype(np.int64) << 32) | vlo.view(np.uint32).astype(np.int64)
            if dead.any():
                builder.delete_many([k for k, d in zip(keys, dead) if d])
            if not dead.all():
                builder.insert_many([k for k, d in zip(keys, dead) if not d], vals[~dead])
    return freeze(builder, delta_capacity=ti.de_off.shape[0],
                  delta_bytes=ti.db_bytes.shape[0], delta_probes=ti.delta_probes,
                  epoch=epoch + 1, device=ti.device)
