"""Host-side LITS builder: bulkload and dynamic operations (paper Sec. 3.1,
Alg. 2/3).

A copy of :class:`repro.core.builder.LITSBuilder`.  The builder owns
growable numpy pools (structure of arrays, with tagged 32-bit items in
place of the paper's tagged 64-bit pointers) and implements:

* bulkload: sample → HPT → recursive top-down build with PMSS decisions,
* collision-driven model-based nodes (LIPP): no last-mile search,
* compact leaf nodes (≤16 key-sorted h-pointers),
* critbit subtries,
* insert/delete/update with path-count resizing (Alg. 3 incCount, the 2×
  rule) and local rebuilds, one key at a time or in bulk
  (:meth:`LITSBuilder.insert_many`/:meth:`LITSBuilder.delete_many`, the
  merge's replay), keeping the sorted entry order and the height bound
  that ``freeze`` reads up to date.

Slot positions come from :func:`repro_torch.core.hpt.positions` on the
builder's ``device``: K1 on the card, the plain version on the CPU.  Both
equal the reference's float32 ``positions_jnp`` bit for bit, so the pools
equal the reference's array for array, including where the reference loses
keys: ``_build_mnode`` groups runs of equal positions and assumes the
positions never decrease, which float32 rounding of the CDF can break by an
ulp; a later run then overwrites an earlier run's slot.  The lost key stays
in the sorted order until a rebuild walks its subtree.

``LITSConfig.exact_slots`` (default False) departs from the reference there:
every run whose position lands in one slot goes into that slot's one child
group, built over the runs' keys in key order, so no stored key becomes
unreachable.  The pools keep their format and the kernels do not change;
where no slot is shared the pools equal the default mode's.  A benchmark
configuration sets it through ``index_config.builder`` (``{"exact_slots":
true}``, which :class:`repro_torch.index.IndexConfig` turns into a
:class:`LITSConfig`).  Either way the counter
``lits.build.bulkload.shared_slot_keys`` counts the keys of the runs that
share a slot, in the open call's record.

A bulk walk copies its keys to the device once and computes each model
node's slot positions for the whole batch in one call, when the walk first
reaches that node: K1 runs once per distinct node visited.

A builder given a ``host_model`` (:mod:`repro_torch.core.baselines`: RS,
SRMI or SM, as Fig. 14 plugs them in) builds no HPT and takes its model
values and slot positions from that model in float64 on the host, as the
reference's does: it launches no K1 or K2, and its index is searched with
:meth:`LITSBuilder.host_search`.
"""
from __future__ import annotations

import bisect
import dataclasses
import sys
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import resolve_device
from repro_torch.spans import add, span

from . import pmss as pmss_mod
from .gpkl import gpkl
from .hpt import HPT, build_hpt, get_cdf, positions
from .strings import StringSet, dedup_sorted, group_cpl, key_hash16, sort_order

# ---------------------------------------------------------------------------
# Tagged 32-bit items
# ---------------------------------------------------------------------------
TAG_EMPTY = 0
TAG_ENTRY = 1
TAG_MNODE = 2
TAG_CNODE = 3
TAG_TRIE = 4

PAYLOAD_BITS = 28
PAYLOAD_MASK = (1 << PAYLOAD_BITS) - 1

# Alg. 3 incCount + resize (LIPP rule): a model node is rebuilt once it holds
# RESIZE_GROW times its slots in keys, or fewer than RESIZE_SHRINK times them
RESIZE_GROW = 2.0
RESIZE_SHRINK = 0.2

# counter of the keys of every run of a model node whose slot another run of
# that node also takes: with exact_slots False the keys a build can lose,
# with it True the keys it groups
SHARED_SLOT_KEYS = "lits.build.bulkload.shared_slot_keys"


def _shared_runs(run_pos: np.ndarray) -> Optional[np.ndarray]:
    """Per run of a model node, whether another run takes its slot; None
    where no slot is shared (always so where the positions never decrease)."""
    if (np.diff(run_pos) > 0).all():
        return None
    _, inv, cnt = np.unique(run_pos, return_inverse=True, return_counts=True)
    shared = cnt[inv] > 1
    return shared if shared.any() else None


def make_item(tag: int, payload: int = 0) -> int:
    if not 0 <= payload <= PAYLOAD_MASK:
        raise OverflowError("pool overflow: payload does not fit 28 bits")
    return (tag << PAYLOAD_BITS) | payload


def item_tag(item: int) -> int:
    return (int(item) >> PAYLOAD_BITS) & 0x7


def item_payload(item: int) -> int:
    return int(item) & PAYLOAD_MASK


class GrowArr:
    """Amortized-doubling 1-D numpy array."""

    def __init__(self, dtype, cap: int = 1024) -> None:
        self.data = np.zeros(cap, dtype=dtype)
        self.n = 0

    def _ensure(self, extra: int) -> None:
        need = self.n + extra
        if need > self.data.shape[0]:
            cap = max(need, self.data.shape[0] * 2)
            nd = np.zeros(cap, dtype=self.data.dtype)
            nd[: self.n] = self.data[: self.n]
            self.data = nd

    def append(self, v) -> int:
        self._ensure(1)
        self.data[self.n] = v
        self.n += 1
        return self.n - 1

    def extend(self, arr: np.ndarray) -> int:
        arr = np.asarray(arr, dtype=self.data.dtype)
        self._ensure(arr.shape[0])
        base = self.n
        self.data[base : base + arr.shape[0]] = arr
        self.n += arr.shape[0]
        return base

    def view(self) -> np.ndarray:
        return self.data[: self.n]

    @property
    def nbytes_live(self) -> int:
        return self.n * self.data.dtype.itemsize


@dataclasses.dataclass
class LITSConfig:
    cnode_cap: int = 16          # paper: w = 16 (Sec. 4.4)
    min_slots: int = 8
    slots_factor: float = 2.0    # paper: item array ≤ 2× elements (App. A.6)
    max_slots: int = 1 << 22
    heavy_slot_frac: float = 0.5  # paper's >50% rule -> subtrie
    use_subtrie: bool = True      # False => the paper's LIT ablation
    hpt_rows: int = 1024
    hpt_cols: int = 128
    smoothing: float = 0.5
    sample_frac: float = 0.01
    min_sample: int = 2048
    min_width: int = 16
    # True: every run of keys whose model position lands in one slot goes
    # into that slot's one child group, so that no stored key becomes
    # unreachable; False: the reference's placement (a later run overwrites)
    exact_slots: bool = False


class LITSBuilder:
    """Host-side index; :func:`repro_torch.core.tensor_index.freeze` exports
    the device :class:`TensorIndex`.  ``device`` is where the model values
    and slot positions are computed (default ``"cuda"``)."""

    def __init__(
        self,
        config: LITSConfig | None = None,
        hpt: HPT | None = None,
        host_model=None,
        pmss: pmss_mod.PMSS | None = None,
        rng: np.random.Generator | None = None,
        device="cuda",
    ) -> None:
        self.cfg = config or LITSConfig()
        self.hpt = hpt
        self.host_model = host_model  # RS/SRMI etc.: float64 host values (Fig. 14)
        self.pmss = pmss if pmss is not None else pmss_mod.PMSS()
        self.rng = rng or np.random.default_rng(0)
        self.device = resolve_device(device)
        self.width = self.cfg.min_width
        # pools
        self.key_bytes = GrowArr(np.uint8, 1 << 16)
        self.ent_off = GrowArr(np.int64)
        self.ent_len = GrowArr(np.int32)
        self.ent_val = GrowArr(np.int64)
        self.items = GrowArr(np.int32)
        self.mn_slot_base = GrowArr(np.int32)
        self.mn_slot_cnt = GrowArr(np.int32)
        self.mn_prefix_off = GrowArr(np.int64)
        self.mn_prefix_len = GrowArr(np.int32)
        self.mn_alpha = GrowArr(np.float32)
        self.mn_beta = GrowArr(np.float32)
        self.mn_nkeys = GrowArr(np.int32)
        self.cn_base = GrowArr(np.int32)
        self.cn_cnt = GrowArr(np.int32)
        self.ch_hash = GrowArr(np.uint16)
        self.ch_ent = GrowArr(np.int32)
        self.tr_byte = GrowArr(np.int32)
        self.tr_mask = GrowArr(np.uint8)
        self.tr_left = GrowArr(np.int32)
        self.tr_right = GrowArr(np.int32)
        self.root_item = make_item(TAG_EMPTY)
        self.n_keys = 0
        self.max_suffix_len = 1  # longest (key - node prefix) any mnode models
        self._tables = None
        # the sorted entry order and the height bound, kept across mutations
        # so that a merge's refreeze never walks the whole structure; None
        # means unknown, recomputed exactly on next use
        self._sorted_cache: Optional[np.ndarray] = None  # live eids, key order
        self._hb: Optional[dict] = None                  # {"base","trie"} bound
        # a bulk walk's position memo: its rows on the device, the row being
        # walked, and per model node the positions of every row
        self._bulk_pos: Optional[dict] = None

    # ------------------------------------------------------------------
    # model values / positions (on the builder's device)
    # ------------------------------------------------------------------
    def _dev_tables(self):
        if self._tables is None:
            self._tables = (torch.from_numpy(self.hpt.cdf_tab).to(self.device),
                            torch.from_numpy(self.hpt.prob_tab).to(self.device))
        return self._tables

    def _query_rows(self, bytes_mat: np.ndarray, lens: np.ndarray):
        """(n, width) rows and lengths clipped to the width, on the device;
        for a host model, the host arrays as they are."""
        if self.host_model is not None:
            return bytes_mat, lens
        qb = np.zeros((bytes_mat.shape[0], self.width), np.uint8)
        qb[:, : bytes_mat.shape[1]] = bytes_mat[:, : self.width]
        ql = np.minimum(lens, self.width).astype(np.int32)
        return torch.from_numpy(qb).to(self.device), torch.from_numpy(ql).to(self.device)

    def _values(self, qb, ql, start: int) -> np.ndarray:
        """Model values of the rows ``(qb, ql)`` from character ``start``."""
        if self.host_model is not None:
            return self.host_model.values(StringSet(qb, ql), start)
        cdf_tab, prob_tab = self._dev_tables()
        return get_cdf(cdf_tab, prob_tab, qb, ql, start).cpu().numpy()

    def _positions(self, qb, ql, start: int, alpha: float, beta: float, m: int) -> np.ndarray:
        """Slot positions of the rows ``(qb, ql)`` in a node of ``m`` slots."""
        if self.host_model is not None:
            v = self.host_model.values(StringSet(qb, ql), start)
            pos = np.floor(np.float64(alpha) * v + np.float64(beta)).astype(np.int64)
            return np.clip(pos, 1, m - 2).astype(np.int32)
        cdf_tab, prob_tab = self._dev_tables()
        return positions(cdf_tab, prob_tab, qb, ql, start, alpha, beta, m).cpu().numpy()

    def _node_pos(self, nid: int, q: np.ndarray, qlen: int, pl: int, m: int) -> int:
        """Model slot position of one key at model node ``nid``.  A single
        key pays one ``_positions`` call; inside a bulk walk the batch's
        positions at this node are computed once, over all its rows, and
        memoized.  The per-row math is the same, so is the position."""
        alpha, beta = float(self.mn_alpha.data[nid]), float(self.mn_beta.data[nid])
        bp = self._bulk_pos
        if bp is None:
            qb, ql = self._query_rows(q[None, :], np.array([qlen], np.int32))
            return int(self._positions(qb, ql, pl, alpha, beta, m)[0])
        tab = bp["memo"].get(nid)
        if tab is None:
            tab = bp["memo"][nid] = self._positions(*bp["rows"], pl, alpha, beta, m)
        return int(tab[bp["row"]])

    def _bulk_rows(self, keys: Sequence[bytes]) -> None:
        """Start a bulk walk over ``keys``: their rows go to the device once
        (for a host model, they stay on the host)."""
        W = self.width
        qb = np.zeros((len(keys), W), np.uint8)
        ql = np.zeros(len(keys), np.int32)
        for i, k in enumerate(keys):
            kb = np.frombuffer(k[:W], np.uint8)
            qb[i, : kb.shape[0]] = kb
            ql[i] = len(k)
        self._bulk_pos = {"rows": self._query_rows(qb, ql), "row": 0, "memo": {}}

    # ------------------------------------------------------------------
    # entries
    # ------------------------------------------------------------------
    def _add_entry_bytes(self, key: np.ndarray, klen: int, val: int) -> int:
        off = self.key_bytes.extend(key[:klen])
        self.ent_off.append(off)
        self.ent_len.append(klen)
        self.ent_val.append(val)
        return self.ent_off.n - 1

    def key_at(self, eid: int) -> bytes:
        off = int(self.ent_off.data[eid])
        ln = int(self.ent_len.data[eid])
        return self.key_bytes.data[off : off + ln].tobytes()

    def entry_matrix(self, eids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(n, width) zero-padded key bytes and lengths of entries ``eids``
        (byte indices clamped into the key pool, as the reference's)."""
        eids = np.asarray(eids, np.int64)
        offs = self.ent_off.data[eids]
        lens = self.ent_len.data[eids]
        W = self.width
        idx = offs[:, None] + np.arange(W)[None, :]
        idx = np.minimum(idx, max(self.key_bytes.n - 1, 0))
        mat = self.key_bytes.data[idx]
        mask = np.arange(W)[None, :] < lens[:, None]
        return (mat * mask).astype(np.uint8), lens.astype(np.int32)

    # ------------------------------------------------------------------
    # bulkload (paper Sec. 3.1)
    # ------------------------------------------------------------------
    def bulkload(
        self, keys: StringSet, values: np.ndarray | None = None, width: int | None = None
    ) -> None:
        with span("lits.build.bulkload", keys=len(keys)):
            add(SHARED_SLOT_KEYS, 0)    # in the record even where no slot is shared
            self._bulkload(keys, values, width)

    def _bulkload(self, keys: StringSet, values: np.ndarray | None, width: int | None) -> None:
        order = sort_order(keys)
        ss = keys.take(order)
        uniq = dedup_sorted(ss)
        if len(uniq) != len(ss):
            ss = ss.take(uniq)
            order = order[uniq]
        vals = (values[order] if values is not None else np.arange(len(ss), dtype=np.int64))
        maxlen = int(ss.lens.max(initial=1))
        if width is None:
            width = maxlen + 8  # headroom for post-bulkload inserts
        elif width < maxlen:
            raise ValueError(f"width {width} < longest key {maxlen}")
        self.width = max(self.cfg.min_width, width)
        ss = ss.pad_to(self.width)
        if self.hpt is None and self.host_model is None:
            k = max(min(len(ss), self.cfg.min_sample), int(len(ss) * self.cfg.sample_frac))
            sample_idx = self.rng.choice(len(ss), size=min(k, len(ss)), replace=False)
            self.hpt = build_hpt(
                ss.take(sample_idx), self.cfg.hpt_rows, self.cfg.hpt_cols, self.cfg.smoothing
            )
        # register all entries (packed bytes, key order)
        flat = [ss.bytes[i, : ss.lens[i]] for i in range(len(ss))]
        offs = self.key_bytes.n + np.concatenate(
            [[0], np.cumsum(ss.lens[:-1], dtype=np.int64)]) if len(ss) else np.zeros(0, np.int64)
        if flat:
            self.key_bytes.extend(np.concatenate(flat))
        ent_base = self.ent_off.extend(offs)
        self.ent_len.extend(ss.lens)
        self.ent_val.extend(vals)
        eids = ent_base + np.arange(len(ss), dtype=np.int64)
        sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))
        self.root_item = self._build_group(eids, ss.bytes, ss.lens, force_mnode=True)
        self.n_keys = len(ss)
        # entries were registered in sorted key order -> the ordered-traversal
        # eid sequence is exactly ``eids``
        self._sorted_cache = eids.copy()
        self._hb = None

    # ------------------------------------------------------------------
    # recursive group build with PMSS decision
    # ------------------------------------------------------------------
    def _build_group(self, eids: np.ndarray, bytes_mat: Optional[np.ndarray] = None,
                     lens: Optional[np.ndarray] = None, force_mnode: bool = False) -> int:
        n = len(eids)
        if n == 0:
            return make_item(TAG_EMPTY)
        if bytes_mat is None:
            bytes_mat, lens = self.entry_matrix(eids)
        if n == 1:
            return make_item(TAG_ENTRY, int(eids[0]))
        if n <= self.cfg.cnode_cap and not force_mnode:
            return self._build_cnode(eids, bytes_mat, lens)
        if self.cfg.use_subtrie and not force_mnode:
            g = gpkl(StringSet(bytes_mat, lens))
            if self.pmss.decide(g, n) == "trie":
                return self._build_trie(eids, bytes_mat, lens)
        return self._build_mnode(eids, bytes_mat, lens)

    def _build_mnode(self, eids: np.ndarray, bytes_mat: np.ndarray, lens: np.ndarray) -> int:
        n = len(eids)
        pl = group_cpl(StringSet(bytes_mat, lens))
        pl = min(pl, self.width - 1)
        qb, ql = self._query_rows(bytes_mat, lens)  # one copy to the device for both calls
        v = self._values(qb, ql, pl).astype(np.float64)
        vmin, vmax = float(v.min()), float(v.max())
        if not (vmax > vmin):  # model cannot split this group -> trie (strengthened 50% rule)
            return self._build_trie(eids, bytes_mat, lens)
        m = int(np.clip(int(self.cfg.slots_factor * n), self.cfg.min_slots, self.cfg.max_slots))
        alpha = np.float32((m - 3) / (vmax - vmin))
        beta = np.float32(1.0 - float(alpha) * vmin)
        pos = self._positions(qb, ql, pl, float(alpha), float(beta), m)
        self.max_suffix_len = max(self.max_suffix_len, int((lens - pl).max()))
        base = self.items.extend(np.zeros(m, np.int32))
        nid = self.mn_slot_base.append(base)
        self.mn_slot_cnt.append(m)
        self.mn_prefix_off.append(self.ent_off.data[eids[0]])
        self.mn_prefix_len.append(pl)
        self.mn_alpha.append(alpha)
        self.mn_beta.append(beta)
        self.mn_nkeys.append(n)
        # runs of equal positions; the reference assumes positions never
        # decrease, and a position that comes back is overwritten as it is there
        cut = np.flatnonzero(np.diff(pos)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [n]])
        shared = _shared_runs(pos[starts])
        if shared is not None:
            add(SHARED_SLOT_KEYS, int((ends - starts)[shared].sum()))
        grouped = self.cfg.exact_slots and shared is not None
        for r, (s, e) in enumerate(zip(starts, ends)):
            p = int(pos[s])
            rows = slice(s, e)
            if grouped and shared[r]:
                # exact mode: the slot's first run builds one group of every
                # run that lands there, in key order; the later runs are in it
                rows = np.flatnonzero(pos == p)
                if rows[0] != s:
                    continue
            sub = eids[rows]
            k = len(sub)
            if k == 1:
                self.items.data[base + p] = make_item(TAG_ENTRY, int(sub[0]))
            elif k > self.cfg.heavy_slot_frac * n or k == n:
                self.items.data[base + p] = self._build_trie(sub, bytes_mat[rows], lens[rows])
            else:
                self.items.data[base + p] = self._build_group(sub, bytes_mat[rows], lens[rows])
        return make_item(TAG_MNODE, nid)

    def _build_cnode(self, eids: np.ndarray, bytes_mat: np.ndarray, lens: np.ndarray) -> int:
        hashes = key_hash16(bytes_mat, lens)
        base = self.ch_hash.extend(hashes.astype(np.uint16))
        self.ch_ent.extend(eids.astype(np.int32))
        cid = self.cn_base.append(base)
        self.cn_cnt.append(len(eids))
        return make_item(TAG_CNODE, cid)

    def _build_trie(self, eids: np.ndarray, bytes_mat: np.ndarray, lens: np.ndarray) -> int:
        def rec(lo: int, hi: int) -> int:
            if hi - lo == 1:
                return make_item(TAG_ENTRY, int(eids[lo]))
            sub = bytes_mat[lo:hi]
            neq = (sub != sub[0:1]).any(axis=0)
            if not neq.any():  # duplicate keys cannot reach here (deduped)
                raise AssertionError("duplicate keys in trie build")
            p = int(neq.argmax())
            vals = sub[:, p].astype(np.int32)
            diff = int(vals.min()) ^ int(vals.max())
            b = diff.bit_length() - 1
            mask = 1 << b
            bits = (vals & mask) != 0
            split = int(bits.argmax())  # sorted keys => bits monotone 0..0 1..1
            left = rec(lo, lo + split)
            right = rec(lo + split, hi)
            tid = self.tr_byte.append(p)
            self.tr_mask.append(mask)
            self.tr_left.append(left)
            self.tr_right.append(right)
            return make_item(TAG_TRIE, tid)

        return rec(0, len(eids))

    # ------------------------------------------------------------------
    # host search (the oracle; the device walk is in tensor_index.py)
    # ------------------------------------------------------------------
    def _pad_query(self, key: bytes) -> Tuple[np.ndarray, int]:
        q = np.zeros(self.width, np.uint8)
        kb = np.frombuffer(key[: self.width], np.uint8)
        q[: kb.shape[0]] = kb
        return q, len(key)

    def _trie_descend(self, item: int, q: np.ndarray, qlen: int) -> int:
        while item_tag(item) == TAG_TRIE:
            tid = item_payload(item)
            cb = int(self.tr_byte.data[tid])
            c = int(q[cb]) if cb < min(qlen, self.width) else 0
            if c & int(self.tr_mask.data[tid]):
                item = int(self.tr_right.data[tid])
            else:
                item = int(self.tr_left.data[tid])
        return item

    def _child_loc(self, nid: int, key: bytes, q: np.ndarray, qlen: int) -> int:
        """The items-pool slot a key takes at model node ``nid``: the first
        or last slot for keys below or above the node's prefix, else its
        model position."""
        pl = int(self.mn_prefix_len.data[nid])
        poff = int(self.mn_prefix_off.data[nid])
        prefix = self.key_bytes.data[poff : poff + pl].tobytes()
        kp = key[:pl]
        base = int(self.mn_slot_base.data[nid])
        m = int(self.mn_slot_cnt.data[nid])
        if kp < prefix:
            return base
        if kp > prefix:
            return base + m - 1
        return base + self._node_pos(nid, q, qlen, pl, m)

    def host_search(self, key: bytes) -> Tuple[bool, int]:
        q, qlen = self._pad_query(key)
        item = self.root_item
        while True:
            tag = item_tag(item)
            if tag == TAG_EMPTY:
                return False, -1
            if tag == TAG_ENTRY:
                eid = item_payload(item)
                return (self.key_at(eid) == key), eid
            if tag == TAG_CNODE:
                cid = item_payload(item)
                base, cnt = int(self.cn_base.data[cid]), int(self.cn_cnt.data[cid])
                h = int(key_hash16(q[None, :], np.array([qlen], np.int32))[0])
                for j in range(cnt):
                    if int(self.ch_hash.data[base + j]) == h:
                        eid = int(self.ch_ent.data[base + j])
                        if self.key_at(eid) == key:
                            return True, eid
                return False, -1
            if tag == TAG_TRIE:
                item = self._trie_descend(item, q, qlen)
                continue
            item = int(self.items.data[self._child_loc(item_payload(item), key, q, qlen)])

    def get(self, key: bytes) -> Optional[int]:
        found, eid = self.host_search(key)
        return int(self.ent_val.data[eid]) if found else None

    # ------------------------------------------------------------------
    # insert / delete / update (paper Alg. 3)
    # ------------------------------------------------------------------
    def _insert_walk(self, key: bytes, val: int):
        """Structural insert without the Alg. 3 incCount/resize pass.

        Returns ``(inserted, path, loc, eid)``: ``path`` is the model-node
        chain walked, as ``(node id, item location of that node)``; ``loc``
        the item location whose content changed (-1 is the root, a tuple a
        trie child link, else an index into the items pool); ``eid`` the
        new entry, or on a duplicate key the existing one.
        """
        if len(key) > self.width:
            raise ValueError("key longer than index width; rebuild with larger width")
        q, qlen = self._pad_query(key)
        path: List[Tuple[int, int]] = []
        loc = -1
        item = self.root_item
        while True:
            tag = item_tag(item)
            if tag == TAG_EMPTY:
                eid = self._add_entry_bytes(q, qlen, val)
                self._set_item(loc, make_item(TAG_ENTRY, eid))
                return True, path, loc, eid
            if tag == TAG_ENTRY:
                eid = item_payload(item)
                if self.key_at(eid) == key:
                    return False, path, loc, eid
                neid = self._add_entry_bytes(q, qlen, val)
                pair = np.array([eid, neid], np.int64)
                bm, ls = self.entry_matrix(pair)
                o = sort_order(StringSet(bm, ls))
                self._set_item(loc, self._build_cnode(pair[o], bm[o], ls[o]))
                return True, path, loc, neid
            if tag == TAG_CNODE:
                inserted, eid = self._cnode_insert(loc, item, key, q, qlen, val)
                return inserted, path, loc, eid
            if tag == TAG_TRIE:
                inserted, eid = self._trie_insert(loc, item, key, q, qlen, val)
                return inserted, path, loc, eid
            nid = item_payload(item)
            path.append((nid, loc))
            loc = self._child_loc(nid, key, q, qlen)
            item = int(self.items.data[loc])

    def insert(self, key: bytes, val: int) -> bool:
        inserted, path, _loc, _eid = self._insert_walk(key, val)
        if not inserted:
            return False
        self.n_keys += 1
        self._sorted_cache = None
        self._hb = None
        # incCount + resize (Alg. 3): rebuild the topmost node past the 2x rule
        for nid, _ in path:
            self.mn_nkeys.data[nid] += 1
        for nid, nloc in path:
            if self.mn_nkeys.data[nid] >= RESIZE_GROW * self.mn_slot_cnt.data[nid]:
                self._rebuild_at(nloc, make_item(TAG_MNODE, nid))
                break
        return True

    def _cnode_insert(self, loc, item: int, key: bytes, q, qlen, val):
        cid = item_payload(item)
        base, cnt = int(self.cn_base.data[cid]), int(self.cn_cnt.data[cid])
        eids = self.ch_ent.data[base : base + cnt].astype(np.int64)
        keys = [self.key_at(int(e)) for e in eids]
        p = bisect.bisect_left(keys, key)
        if p < cnt and keys[p] == key:
            return False, int(eids[p])
        neid = self._add_entry_bytes(q, qlen, val)
        new_eids = np.insert(eids, p, neid)
        bm, ls = self.entry_matrix(new_eids)
        if cnt < self.cfg.cnode_cap:
            # a fresh slab of cnt + 1 (paper Sec. 3.3, no pre-allocation)
            self._set_item(loc, self._build_cnode(new_eids, bm, ls))
        else:
            # full: PMSS decides model-based node or subtrie (Sec. 3.4 scenario 2)
            self._set_item(loc, self._build_group(new_eids, bm, ls))
        return True, neid

    def _trie_insert(self, loc, item: int, key: bytes, q, qlen, val):
        leaf = self._trie_descend(item, q, qlen)
        leid = item_payload(leaf)
        lkey = self.key_at(leid)
        if lkey == key:
            return False, leid
        lq = np.zeros(self.width, np.uint8)
        lb = np.frombuffer(lkey, np.uint8)
        lq[: lb.shape[0]] = lb
        diff = q.astype(np.int32) ^ lq.astype(np.int32)
        p = int((diff != 0).argmax())
        b = int(diff[p]).bit_length() - 1
        mask = 1 << b
        newdir = 1 if (int(q[p]) & mask) else 0
        neid = self._add_entry_bytes(q, qlen, val)
        # walk again, stopping where the new critbit node belongs
        cur_loc, cur = loc, item
        while item_tag(cur) == TAG_TRIE:
            tid = item_payload(cur)
            cb, cm = int(self.tr_byte.data[tid]), int(self.tr_mask.data[tid])
            if (cb, -cm) > (p, -mask):  # the new discriminating bit is more significant
                break
            c = int(q[cb]) if cb < min(qlen, self.width) else 0
            if c & cm:
                cur_loc, cur = ("trie_r", tid), int(self.tr_right.data[tid])
            else:
                cur_loc, cur = ("trie_l", tid), int(self.tr_left.data[tid])
        nitem = make_item(TAG_ENTRY, neid)
        left, right = (cur, nitem) if newdir else (nitem, cur)
        tid = self.tr_byte.append(p)
        self.tr_mask.append(mask)
        self.tr_left.append(left)
        self.tr_right.append(right)
        self._set_item(cur_loc, make_item(TAG_TRIE, tid))
        return True, neid

    def _item_at(self, loc) -> int:
        if loc == -1:
            return int(self.root_item)
        if isinstance(loc, tuple):
            kind, tid = loc
            return int(self.tr_left.data[tid] if kind == "trie_l" else self.tr_right.data[tid])
        return int(self.items.data[loc])

    def _set_item(self, loc, item: int) -> None:
        if loc == -1:
            self.root_item = item
        elif isinstance(loc, tuple):
            kind, tid = loc
            if kind == "trie_l":
                self.tr_left.data[tid] = item
            else:
                self.tr_right.data[tid] = item
        else:
            self.items.data[loc] = item

    def _rebuild_at(self, loc, item: int) -> None:
        eids = np.array(list(self.iter_subtree(item)), np.int64)
        if self.cfg.exact_slots:
            eids = self._key_sorted(eids)
        self._set_item(loc, self._build_group(eids))

    def _key_sorted(self, eids: np.ndarray) -> np.ndarray:
        """``eids`` in key order.  With exact_slots a slot's group can hold
        keys on both sides of a neighbouring slot's, so a walk of the
        structure need not visit keys in order."""
        return eids[sort_order(StringSet(*self.entry_matrix(eids)))]

    def _delete_walk(self, key: bytes):
        """Structural delete without the shrink-resize pass.  Returns
        ``(removed, path, loc, eid)`` as :meth:`_insert_walk` does; ``eid``
        is the entry unlinked (the entry pool keeps its bytes)."""
        q, qlen = self._pad_query(key)
        path: List[Tuple[int, int]] = []
        loc = -1
        item = self.root_item
        while True:
            tag = item_tag(item)
            if tag == TAG_EMPTY:
                return False, path, loc, -1
            if tag == TAG_ENTRY:
                eid = item_payload(item)
                if self.key_at(eid) != key:
                    return False, path, loc, -1
                self._set_item(loc, make_item(TAG_EMPTY))
                return True, path, loc, eid
            if tag == TAG_CNODE:
                cid = item_payload(item)
                base, cnt = int(self.cn_base.data[cid]), int(self.cn_cnt.data[cid])
                eids = self.ch_ent.data[base : base + cnt].astype(np.int64)
                keep = [int(e) for e in eids if self.key_at(int(e)) != key]
                if len(keep) == cnt:
                    return False, path, loc, -1
                gone = next(int(e) for e in eids if self.key_at(int(e)) == key)
                if len(keep) == 1:
                    self._set_item(loc, make_item(TAG_ENTRY, keep[0]))
                else:
                    arr = np.array(keep, np.int64)
                    bm, ls = self.entry_matrix(arr)
                    self._set_item(loc, self._build_cnode(arr, bm, ls))
                return True, path, loc, gone
            if tag == TAG_TRIE:
                removed, eid = self._trie_delete(loc, item, key, q, qlen)
                return removed, path, loc, eid
            nid = item_payload(item)
            path.append((nid, loc))
            loc = self._child_loc(nid, key, q, qlen)
            item = int(self.items.data[loc])

    def _shrinks(self, nid: int) -> bool:
        m = int(self.mn_slot_cnt.data[nid])
        k = self.mn_nkeys.data[nid]
        return m > self.cfg.min_slots and k < RESIZE_SHRINK * m and k >= 0

    def delete(self, key: bytes) -> bool:
        removed, path, _loc, _eid = self._delete_walk(key)
        if not removed:
            return False
        self.n_keys -= 1
        self._sorted_cache = None
        self._hb = None
        for nid, _ in path:
            self.mn_nkeys.data[nid] -= 1
        for nid, nloc in path:
            if self._shrinks(nid):
                self._rebuild_at(nloc, make_item(TAG_MNODE, nid))
                break
        return True

    def _trie_delete(self, loc, item: int, key: bytes, q, qlen):
        # walk, remembering the parent's side, then splice the sibling up
        parent = None  # (tid, side)
        cur = item
        while item_tag(cur) == TAG_TRIE:
            tid = item_payload(cur)
            cb, cm = int(self.tr_byte.data[tid]), int(self.tr_mask.data[tid])
            c = int(q[cb]) if cb < min(qlen, self.width) else 0
            side = 1 if (c & cm) else 0
            parent = (tid, side)
            cur = int(self.tr_right.data[tid]) if side else int(self.tr_left.data[tid])
        if item_tag(cur) != TAG_ENTRY or self.key_at(item_payload(cur)) != key:
            return False, -1
        gone = item_payload(cur)
        tid, side = parent  # a trie item always has >= 2 leaves
        sibling = int(self.tr_left.data[tid]) if side else int(self.tr_right.data[tid])
        # find the link to tid
        gp_loc, gcur = loc, item
        while True:
            gtid = item_payload(gcur)
            if gtid == tid:
                self._set_item(gp_loc, sibling)
                return True, gone
            cb, cm = int(self.tr_byte.data[gtid]), int(self.tr_mask.data[gtid])
            c = int(q[cb]) if cb < min(qlen, self.width) else 0
            if c & cm:
                gp_loc, gcur = ("trie_r", gtid), int(self.tr_right.data[gtid])
            else:
                gp_loc, gcur = ("trie_l", gtid), int(self.tr_left.data[gtid])

    def update(self, key: bytes, val: int) -> bool:
        found, eid = self.host_search(key)
        if not found:
            return False
        self.ent_val.data[eid] = val
        return True

    # ------------------------------------------------------------------
    # bulk replay (the merge's path)
    # ------------------------------------------------------------------
    def _rank_in(self, sorted_arr: np.ndarray, key: bytes) -> int:
        """First index i with key_at(sorted_arr[i]) >= key."""
        lo, hi = 0, sorted_arr.shape[0]
        while lo < hi:
            mid = (lo + hi) // 2
            if self.key_at(int(sorted_arr[mid])) < key:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def insert_many(self, keys: Sequence[bytes], vals: np.ndarray) -> np.ndarray:
        """Bulk upsert: insert each new key, overwrite the value of existing
        ones.  Returns the per-key inserted mask (False: a value update).

        The structural edits run key by key, in key order, but the Alg. 3
        incCount/resize pass runs once at the end, so a subtree that many
        keys reach rebuilds once; the sorted order takes one batched splice
        and the height bound folds in the heights of the subtrees that
        changed, so the next ``freeze`` walks nothing whole.
        """
        n0 = len(keys)
        inserted = np.zeros(n0, bool)
        if n0 == 0:
            return inserted
        sorted_arr = self.sorted_eids()
        hb = dict(self.height_bound())
        # unknown until the batch completes: an exception midway leaves the
        # structure partly replayed, and the next freeze must walk it exactly
        self._sorted_cache = None
        self._hb = None
        # key order, so that the batched splice keeps equal ranks in order
        order = sorted(range(n0), key=lambda i: keys[i])
        paths: List[List[Tuple[int, int]]] = []
        dirty: dict = {}        # changed item location -> model-node depth there
        ranks: List[int] = []
        new_eids: List[int] = []
        self._bulk_rows(keys)
        try:
            for i in order:
                key = keys[i]
                self._bulk_pos["row"] = i
                ok, path, loc, eid = self._insert_walk(key, int(vals[i]))
                if not ok:
                    self.ent_val.data[eid] = int(vals[i])  # upsert: refresh
                    continue
                inserted[i] = True
                self.n_keys += 1
                new_eids.append(eid)
                ranks.append(self._rank_in(sorted_arr, key))
                for nid, _ in path:
                    self.mn_nkeys.data[nid] += 1
                paths.append(path)
                dirty[loc] = len(path)
        finally:
            self._bulk_pos = None
        # the deferred resize: the topmost node past the rule on each path;
        # a node an earlier rebuild restructured no longer holds its slot
        for path in paths:
            for depth, (nid, nloc) in enumerate(path):
                if self.mn_nkeys.data[nid] >= RESIZE_GROW * self.mn_slot_cnt.data[nid]:
                    if self._item_at(nloc) == make_item(TAG_MNODE, nid):
                        self._rebuild_at(nloc, make_item(TAG_MNODE, nid))
                        dirty[nloc] = depth
                    break
        if new_eids:
            sorted_arr = np.insert(sorted_arr, np.asarray(ranks, np.int64),
                                   np.asarray(new_eids, np.int64))
        self._sorted_cache = sorted_arr
        self._update_height_bound(hb, dirty)
        return inserted

    def delete_many(self, keys: Sequence[bytes]) -> np.ndarray:
        """Bulk delete, with :meth:`insert_many`'s deferred resize and
        cache upkeep.  Returns the per-key removed mask."""
        n0 = len(keys)
        removed = np.zeros(n0, bool)
        if n0 == 0:
            return removed
        sorted_arr = self.sorted_eids()
        hb = dict(self.height_bound())
        self._sorted_cache = None
        self._hb = None
        paths: List[List[Tuple[int, int]]] = []
        dirty: dict = {}
        gone: List[int] = []
        self._bulk_rows(keys)
        try:
            for i in range(n0):
                self._bulk_pos["row"] = i
                ok, path, loc, eid = self._delete_walk(keys[i])
                if not ok:
                    continue
                removed[i] = True
                self.n_keys -= 1
                gone.append(eid)
                for nid, _ in path:
                    self.mn_nkeys.data[nid] -= 1
                paths.append(path)
                dirty[loc] = len(path)
        finally:
            self._bulk_pos = None
        for path in paths:
            for depth, (nid, nloc) in enumerate(path):
                if self._shrinks(nid):
                    if self._item_at(nloc) == make_item(TAG_MNODE, nid):
                        self._rebuild_at(nloc, make_item(TAG_MNODE, nid))
                        dirty[nloc] = depth
                    break
        if gone:
            sorted_arr = sorted_arr[~np.isin(sorted_arr, np.asarray(gone, np.int64))]
        self._sorted_cache = sorted_arr
        self._update_height_bound(hb, dirty)
        return removed

    def _update_height_bound(self, hb: dict, dirty: dict) -> None:
        """Fold the heights of the changed subtrees into the cached bound.
        The rest is covered by the previous bound, and deletes only shrink
        a subtree, so the maximum stays an upper bound, possibly a loose
        one: ``freeze`` takes the walk's iteration bound from it."""
        with span("lits.build.folds", subtrees=len(dirty)):
            for loc, depth in dirty.items():
                b, t = self._subtree_heights(self._item_at(loc), depth)
                hb["base"] = max(hb["base"], b)
                hb["trie"] = max(hb["trie"], t)
        self._hb = hb

    # ------------------------------------------------------------------
    # sorted order + height bound (what freeze needs)
    # ------------------------------------------------------------------
    def sorted_eids(self) -> np.ndarray:
        """Live entry ids in key order (``iter_subtree(root)`` after a bulk
        load or a full walk), kept across mutations by the bulk ops."""
        if self._sorted_cache is None:
            eids = np.fromiter(self.iter_subtree(self.root_item), dtype=np.int64, count=-1)
            self._sorted_cache = self._key_sorted(eids) if self.cfg.exact_slots else eids
        return self._sorted_cache

    def height_bound(self) -> dict:
        """An upper bound on ``heights()``: exact after a bulk load or a
        full walk, kept by the bulk ops (:meth:`_update_height_bound`);
        ``freeze`` derives the walk's bound from it."""
        if self._hb is None:
            self._hb = self.heights()
        return self._hb

    def iter_subtree(self, item: int) -> Iterator[int]:
        tag = item_tag(item)
        if tag == TAG_EMPTY:
            return
        if tag == TAG_ENTRY:
            yield item_payload(item)
            return
        if tag == TAG_CNODE:
            cid = item_payload(item)
            base, cnt = int(self.cn_base.data[cid]), int(self.cn_cnt.data[cid])
            for j in range(cnt):
                yield int(self.ch_ent.data[base + j])
            return
        if tag == TAG_TRIE:
            tid = item_payload(item)
            yield from self.iter_subtree(int(self.tr_left.data[tid]))
            yield from self.iter_subtree(int(self.tr_right.data[tid]))
            return
        nid = item_payload(item)
        base, m = int(self.mn_slot_base.data[nid]), int(self.mn_slot_cnt.data[nid])
        for p in range(m):
            yield from self.iter_subtree(int(self.items.data[base + p]))

    def scan(self, begin: bytes, count: int) -> List[Tuple[bytes, int]]:
        """Host range scan: first ``count`` entries with key >= begin."""
        out: List[Tuple[bytes, int]] = []
        order = self.sorted_eids() if self.cfg.exact_slots else self.iter_subtree(self.root_item)
        for eid in order:
            k = self.key_at(eid)
            if k >= begin:
                out.append((k, int(self.ent_val.data[eid])))
                if len(out) >= count:
                    break
        return out

    def heights(self) -> dict:
        """Paper Table 3: (base height, trie height) by depth-first walk."""
        base_h, trie_h = self._subtree_heights(self.root_item, 0)
        return {"base": base_h, "trie": trie_h}

    def _subtree_heights(self, item: int, base_depth: int) -> Tuple[int, int]:
        """(base, trie) height of the subtree under ``item``, with mnode/cnode
        levels counted from ``base_depth`` (the slot's depth in the index)."""
        base_h = trie_h = 0
        stack = [(item, base_depth, 0)]
        while stack:
            item, bd, td = stack.pop()
            tag = item_tag(item)
            if tag == TAG_EMPTY:
                continue
            if tag == TAG_ENTRY:
                base_h = max(base_h, bd)
                trie_h = max(trie_h, td)
                continue
            if tag == TAG_CNODE:
                base_h = max(base_h, bd + 1)
                trie_h = max(trie_h, td)
                continue
            if tag == TAG_TRIE:
                tid = item_payload(item)
                stack.append((int(self.tr_left.data[tid]), bd, td + 1))
                stack.append((int(self.tr_right.data[tid]), bd, td + 1))
                continue
            nid = item_payload(item)
            base, m = int(self.mn_slot_base.data[nid]), int(self.mn_slot_cnt.data[nid])
            for p in range(m):
                it = int(self.items.data[base + p])
                if it:
                    stack.append((it, bd + 1, td))
        return base_h, trie_h

    def space_bytes(self) -> dict:
        """Live bytes of each host pool and of the HPT, and their total."""
        pools = {
            "keys": self.key_bytes.nbytes_live,
            "entries": self.ent_off.nbytes_live + self.ent_len.nbytes_live + self.ent_val.nbytes_live,
            "items": self.items.nbytes_live,
            "mnodes": sum(
                g.nbytes_live
                for g in (self.mn_slot_base, self.mn_slot_cnt, self.mn_prefix_off,
                          self.mn_prefix_len, self.mn_alpha, self.mn_beta, self.mn_nkeys)
            ),
            "cnodes": self.cn_base.nbytes_live + self.cn_cnt.nbytes_live
            + self.ch_hash.nbytes_live + self.ch_ent.nbytes_live,
            "tries": self.tr_byte.nbytes_live + self.tr_mask.nbytes_live
            + self.tr_left.nbytes_live + self.tr_right.nbytes_live,
            "hpt": self.hpt.nbytes() if self.hpt is not None else 0,
        }
        pools["total"] = sum(pools.values())
        return pools
