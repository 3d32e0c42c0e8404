"""`StringIndex` — the port's application-facing index.

The counterpart of :class:`repro.index.StringIndex` for bulk load, batched
point lookups, writes and range scans:

* :class:`IndexConfig` — width, delta-buffer sizing, builder policy and the
  ``device`` everything runs on (default ``"cuda"``; there is no fallback to
  the CPU, pass ``device="cpu"`` for the plain versions).
* :meth:`StringIndex.bulk_load` — paper Sec. 3.1 bulkload to a frozen
  device index; :meth:`StringIndex.from_builder` wraps a loaded builder.
* :meth:`StringIndex.get_batch` / :meth:`StringIndex.get` — point lookups.
* :meth:`StringIndex.put_batch` / :meth:`StringIndex.delete_batch` — upserts
  and tombstones in the device delta buffer.
* :meth:`StringIndex.scan_batch` — delta-aware range scans.

Compaction is not ported yet, so nothing merges the delta buffer: the port
behaves as the reference with ``IndexConfig(auto_merge_threshold=None)``,
``put_batch``/``delete_batch`` report ``merged=False``, and a full delta
buffer rejects further claims (``delta_overflowed``).

The device decides the path: on the card the builder places keys with K2/K1,
lookups and the write path's base walk run K4, ranks K5 and scans K6; on the
CPU the plain versions run.  Both give the reference's answers bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.builder import LITSBuilder, LITSConfig
from repro_torch.core.strings import StringSet
from repro_torch.core.tensor_index import (
    TensorIndex, delete_batch, freeze, insert_batch, lookup_values, pad_queries, scan_batch,
    search_batch,
)
from repro_torch.kernels._build import resolve_device


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Index policy: sizing, build policy and the device."""

    width: Optional[int] = None          # None: longest bulk-load key + headroom
    delta_capacity: int = 4096           # delta-buffer entry pool size
    delta_bytes: Optional[int] = None    # delta byte pool (None: capacity-derived)
    delta_probes: int = 16               # open-addressing probe bound
    builder: Optional[LITSConfig] = None  # host build policy (cnode cap, HPT shape)
    device: str = "cuda"                 # where the index lives and the kernels run


def _split_np(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    v = np.asarray(vals, np.int64)
    lo = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (v >> 32).astype(np.int32)
    return lo, hi


def _join_values(lo, hi) -> np.ndarray:
    lo = np.asarray(lo, np.int32).view(np.uint32).astype(np.int64)
    hi = np.asarray(hi, np.int32).astype(np.int64)
    return (hi << 32) | lo


class StringIndex:
    """Single-device LITS over the HPT + sub-trie + PMSS hybrid."""

    def __init__(self, builder: Optional[LITSBuilder], ti: TensorIndex,
                 config: IndexConfig):
        self._builder = builder
        self.ti = ti
        self.config = config
        # host mirrors of the delta fill, the latched overflow flag and the
        # epoch, so that reading them never syncs with the device
        self._mirror(self._delta_state().cpu())

    def _delta_state(self) -> torch.Tensor:
        """``(de_count, delta_overflow, epoch)`` as one int64 device tensor."""
        ti = self.ti
        return torch.stack([ti.de_count.long(), ti.delta_overflow.long(), ti.epoch.long()])

    def _mirror(self, state) -> None:
        """Set the host mirrors from :meth:`_delta_state` copied to the host."""
        de_count, overflow, epoch = (int(x) for x in state)
        self._delta_fill = de_count / self.ti.de_off.shape[0]
        self._overflowed = bool(overflow)
        self._epoch = epoch

    @classmethod
    def bulk_load(cls, keys: Sequence[bytes],
                  values: Optional[np.ndarray] = None,
                  config: Optional[IndexConfig] = None) -> "StringIndex":
        """Paper Sec. 3.1: sample -> HPT -> collision-driven build -> freeze."""
        cfg = config or IndexConfig()
        builder = LITSBuilder(config=cfg.builder, device=cfg.device)
        vals = (np.asarray(values, np.int64) if values is not None
                else np.arange(len(keys), dtype=np.int64))
        builder.bulkload(StringSet.from_list(list(keys)), vals, width=cfg.width)
        return cls.from_builder(builder, cfg)

    @classmethod
    def from_builder(cls, builder: LITSBuilder,
                     config: Optional[IndexConfig] = None) -> "StringIndex":
        """Freeze an already bulk-loaded builder onto ``config.device``."""
        cfg = config or IndexConfig()
        ti = freeze(builder, delta_capacity=cfg.delta_capacity,
                    delta_bytes=cfg.delta_bytes, delta_probes=cfg.delta_probes,
                    device=resolve_device(cfg.device))
        return cls(builder, ti, cfg)

    @property
    def width(self) -> int:
        return self.ti.width

    @property
    def n_entries(self) -> int:
        return self.ti.n_entries

    @property
    def delta_fill(self) -> float:
        """Claimed share of the delta entry pool (host mirror)."""
        return self._delta_fill

    @property
    def delta_overflowed(self) -> bool:
        """True once a write was refused for lack of delta slots or bytes
        (host mirror of ``ti.delta_overflow``)."""
        return self._overflowed

    @property
    def epoch(self) -> int:
        """Compaction epoch (host mirror of ``ti.epoch``)."""
        return self._epoch

    def nbytes(self) -> int:
        return self.ti.nbytes()

    def _queries(self, keys: Sequence[bytes]):
        qb, ql = pad_queries(list(keys), self.ti.width)
        dev = self.ti.device
        return torch.from_numpy(qb).to(dev), torch.from_numpy(ql).to(dev)

    def _finish_write(self, a, b) -> Tuple[np.ndarray, np.ndarray]:
        """One device-to-host copy of two op masks and the delta state."""
        host = torch.cat([a.long(), b.long(), self._delta_state()]).cpu().numpy()
        B = a.shape[0]
        self._mirror(host[2 * B:])
        return host[:B] != 0, host[B: 2 * B] != 0

    def get_batch(self, keys: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
        """Point lookups: (found bool mask, int64 values; misses hold 0)."""
        if not keys:
            return np.zeros(0, bool), np.zeros(0, np.int64)
        found, eid, isd = search_batch(self.ti, *self._queries(keys))
        lo, hi = lookup_values(self.ti, eid, isd)
        found, lo, hi = found.cpu().numpy(), lo.cpu().numpy(), hi.cpu().numpy()
        return found, np.where(found, _join_values(lo, hi), 0)

    def put_batch(self, keys: Sequence[bytes],
                  values: Sequence[int]) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Upserts: (inserted mask, updated mask, merged).

        New keys go to the device delta buffer; keys live in the base or in
        the delta get their value updated in place; a put on a deleted key
        resurrects it (inserted).  Over-width keys and puts that find the
        delta buffer full come back with both masks False.  ``merged`` is
        always False: there is no auto-merge until compaction is ported.
        """
        if not len(keys):
            return np.zeros(0, bool), np.zeros(0, bool), False
        qb, ql = self._queries(keys)
        lo, hi = (torch.from_numpy(x).to(self.ti.device)
                  for x in _split_np(np.asarray(values, np.int64)))
        self.ti, ins, upd = insert_batch(self.ti, qb, ql, lo, hi)
        ins, upd = self._finish_write(ins, upd)
        return ins, upd, False

    def delete_batch(self, keys: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Deletes: (deleted mask, rejected-full mask, merged).

        A key in the delta gets its tombstone set in place; a key that lives
        only in the frozen base claims a tombstone entry that shadows it.
        Gets and scans see the delete at once.  ``merged`` is always False.
        """
        if not len(keys):
            return np.zeros(0, bool), np.zeros(0, bool), False
        qb, ql = self._queries(keys)
        self.ti, deleted, rejected = delete_batch(self.ti, qb, ql)
        deleted, rejected = self._finish_write(deleted, rejected)
        return deleted, rejected, False

    def scan_batch(self, starts: Sequence[bytes], window: int):
        """Delta-aware range scans: ``(eids, valid, is_delta)``, each
        ``(B, window)`` on the index's device.  Unmerged delta inserts
        appear in order, tombstoned keys are suppressed; ``eids`` index the
        base pools where ``~is_delta`` and the delta pools where
        ``is_delta`` (the ``lookup_values`` contract)."""
        qb, ql = self._queries(starts)
        return scan_batch(self.ti, qb, ql, window)

    def get(self, key: bytes) -> Optional[int]:
        found, vals = self.get_batch([key])
        return int(vals[0]) if found[0] else None
