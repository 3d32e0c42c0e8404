"""Host-side LITS builder: bulkload (paper Sec. 3.1, Alg. 2).

A copy of the bulk-load half of :class:`repro.core.builder.LITSBuilder`.
The builder owns growable numpy pools (structure of arrays, with tagged
32-bit items in place of the paper's tagged 64-bit pointers) and builds:

* bulkload: sample → HPT → recursive top-down build with PMSS decisions,
* collision-driven model-based nodes (LIPP): no last-mile search,
* compact leaf nodes (≤16 key-sorted h-pointers),
* critbit subtries.

Slot positions come from :func:`repro_torch.core.hpt.positions` on the
builder's ``device``: K1 on the card, the plain version on the CPU.  Both
equal the reference's float32 ``positions_jnp`` bit for bit, so the pools
equal the reference's array for array, including where the reference loses
keys: ``_build_mnode`` groups runs of equal positions and assumes the
positions never decrease, which float32 rounding of the CDF can break by an
ulp; a later run then overwrites an earlier run's slot.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import resolve_device

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


class LITSBuilder:
    """Host-side index; :func:`repro_torch.core.tensor_index.freeze` exports
    the device :class:`TensorIndex`.  ``device`` is where the model values
    and slot positions are computed (default ``"cuda"``)."""

    def __init__(
        self,
        config: LITSConfig | None = None,
        hpt: HPT | None = None,
        pmss: pmss_mod.PMSS | None = None,
        rng: np.random.Generator | None = None,
        device="cuda",
    ) -> None:
        self.cfg = config or LITSConfig()
        self.hpt = hpt
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
        self._sorted_cache: Optional[np.ndarray] = None  # live eids, key order
        self._hb: Optional[dict] = None                  # {"base","trie"} bound

    # ------------------------------------------------------------------
    # model values / positions (on the builder's device)
    # ------------------------------------------------------------------
    def _dev_tables(self):
        if self._tables is None:
            self._tables = (torch.from_numpy(self.hpt.cdf_tab).to(self.device),
                            torch.from_numpy(self.hpt.prob_tab).to(self.device))
        return self._tables

    def _query_rows(self, bytes_mat: np.ndarray, lens: np.ndarray):
        """(n, width) rows and lengths clipped to the width, on the device."""
        qb = np.zeros((bytes_mat.shape[0], self.width), np.uint8)
        qb[:, : bytes_mat.shape[1]] = bytes_mat[:, : self.width]
        ql = np.minimum(lens, self.width).astype(np.int32)
        return torch.from_numpy(qb).to(self.device), torch.from_numpy(ql).to(self.device)

    def _values(self, bytes_mat: np.ndarray, lens: np.ndarray, start: int) -> np.ndarray:
        cdf_tab, prob_tab = self._dev_tables()
        qb, ql = self._query_rows(bytes_mat, lens)
        return get_cdf(cdf_tab, prob_tab, qb, ql, start).cpu().numpy()

    def _positions(
        self, bytes_mat: np.ndarray, lens: np.ndarray, start: int,
        alpha: float, beta: float, m: int,
    ) -> np.ndarray:
        cdf_tab, prob_tab = self._dev_tables()
        qb, ql = self._query_rows(bytes_mat, lens)
        return positions(cdf_tab, prob_tab, qb, ql, start, alpha, beta, m).cpu().numpy()

    # ------------------------------------------------------------------
    # entries
    # ------------------------------------------------------------------
    def key_at(self, eid: int) -> bytes:
        off = int(self.ent_off.data[eid])
        ln = int(self.ent_len.data[eid])
        return self.key_bytes.data[off : off + ln].tobytes()

    # ------------------------------------------------------------------
    # bulkload (paper Sec. 3.1)
    # ------------------------------------------------------------------
    def bulkload(
        self, keys: StringSet, values: np.ndarray | None = None, width: int | None = None
    ) -> None:
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
        if self.hpt is None:
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
    def _build_group(self, eids: np.ndarray, bytes_mat: np.ndarray, lens: np.ndarray,
                     force_mnode: bool = False) -> int:
        n = len(eids)
        if n == 0:
            return make_item(TAG_EMPTY)
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
        v = self._values(bytes_mat, lens, pl).astype(np.float64)
        vmin, vmax = float(v.min()), float(v.max())
        if not (vmax > vmin):  # model cannot split this group -> trie (strengthened 50% rule)
            return self._build_trie(eids, bytes_mat, lens)
        m = int(np.clip(int(self.cfg.slots_factor * n), self.cfg.min_slots, self.cfg.max_slots))
        alpha = np.float32((m - 3) / (vmax - vmin))
        beta = np.float32(1.0 - float(alpha) * vmin)
        pos = self._positions(bytes_mat, lens, pl, float(alpha), float(beta), m)
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
        for s, e in zip(starts, ends):
            p = int(pos[s])
            sub = eids[s:e]
            if e - s == 1:
                self.items.data[base + p] = make_item(TAG_ENTRY, int(sub[0]))
            elif (e - s) > self.cfg.heavy_slot_frac * n or (e - s) == n:
                self.items.data[base + p] = self._build_trie(sub, bytes_mat[s:e], lens[s:e])
            else:
                self.items.data[base + p] = self._build_group(sub, bytes_mat[s:e], lens[s:e])
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
    # sorted order + height bound (what freeze needs)
    # ------------------------------------------------------------------
    def sorted_eids(self) -> np.ndarray:
        """Entry ids in key order (``iter_subtree(root)`` after bulkload)."""
        if self._sorted_cache is None:
            self._sorted_cache = np.fromiter(
                self.iter_subtree(self.root_item), dtype=np.int64, count=-1)
        return self._sorted_cache

    def height_bound(self) -> dict:
        """``heights()``, cached; ``freeze`` derives the walk's bound from it."""
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
