"""Device-resident LITS: frozen structure-of-arrays pools + batched lookups.

``freeze`` exports a :class:`TensorIndex` (a dataclass of flat tensors on
one device) from a host :class:`~repro_torch.core.builder.LITSBuilder`.  It
has the data fields and ``STATIC_FIELDS`` of :class:`repro.core.tensor_index.TensorIndex`.
The read side of the reference's operations:

* :func:`search_batch`  — paper Alg. 2, batched point lookup with the
  delta-buffer probe
* :func:`base_search`   — the walk + terminal resolve, no delta probe
* :func:`lookup_values` — (lo, hi) 2×int32 value fetch

The tensors' device decides the walk: K4 (``csrc/traverse.cu``) on the
card, the plain :mod:`repro_torch.core.walk` on the CPU.  The delta probe is
plain tensor code on either, as the reference keeps it outside its kernel.

Dtypes follow the reference, except ``de_hash``: the reference's uint32
hashes are held as int64 in [0, 2**32), which torch compares exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import fused_search
from repro_torch.kernels.strops import hash32, str_eq, take

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
    fields = {
        name: torch.from_numpy(np.array(arrays[name], dtype=np_dtypes[dt], order="C")).to(device)
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
    return tensor_index_from_arrays(arrays, static, b.device if device is None else device)


def pad_queries(keys, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: list[bytes] -> zero-padded (B, width) uint8 + true lens.

    Lengths are clipped to ``width + 1``: the ``width + 1`` value is an
    over-width SENTINEL, not a length.  No stored key can have it, so
    ``str_eq``'s length comparison makes an over-width query miss every
    stored key instead of matching a truncated alias.
    """
    B = len(keys)
    qb = np.zeros((B, width), np.uint8)
    ql = np.zeros(B, np.int32)
    for i, k in enumerate(keys):
        kb = np.frombuffer(k[:width], np.uint8)
        qb[i, : kb.shape[0]] = kb
        ql[i] = min(len(k), width + 1)
    return qb, ql


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _delta_lookup(ti: TensorIndex, qbytes, qlens):
    """Probe the delta buffer: (found, delta_entry_id); ``delta_probes``
    open-addressing slots of ``dh_slot`` from the query's 32-bit hash."""
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
    e = eid.clamp(min=0)
    return (torch.where(is_delta, take(ti.de_val_lo, e), take(ti.ent_val_lo, e)),
            torch.where(is_delta, take(ti.de_val_hi, e), take(ti.ent_val_hi, e)))
