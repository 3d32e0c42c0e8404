"""`StringIndex` — the port's application-facing index.

The counterpart of :class:`repro.index.StringIndex`:

* :class:`IndexConfig` — width, delta-buffer sizing, builder policy, the
  default scan window and the ``device`` everything runs on (default
  ``"cuda"``; there is no fallback to the CPU, pass ``device="cpu"`` for the
  plain versions).  The reference's ``search_backend``/``kernel_backend``
  fields and their environment variables have no counterpart: the device
  alone decides the path.
* :meth:`StringIndex.bulk_load` — paper Sec. 3.1 bulkload to a frozen
  device index; :meth:`StringIndex.from_builder` wraps a loaded builder.
* Typed batched ops — :class:`GetRequest` / :class:`PutRequest` /
  :class:`ScanRequest` / :class:`DeleteRequest` in, :class:`BatchResult`
  out, with per-op :class:`Status` codes (failures are data, not
  exceptions); :meth:`StringIndex.execute` runs a mixed batch as grouped
  dispatches: puts, then deletes, then gets, then one scan per distinct
  window.
* The batch primitives: :meth:`StringIndex.get_batch`,
  :meth:`StringIndex.put_batch` / :meth:`StringIndex.delete_batch` (upserts
  and tombstones in the device delta buffer; a batch that leaves the delta
  at ``auto_merge_threshold`` of its entries, or that overflowed it,
  merges) and :meth:`StringIndex.scan_batch` (delta-aware range scans).
* :meth:`StringIndex.merge` — compaction: the delta replayed into the host
  builder, a refreeze, the swap; composed of ``begin_merge``/``run_merge``/
  ``commit_merge`` (or ``abort_merge``), between which writes land on the
  live index and are journaled, then replayed onto the merged one.
* :meth:`StringIndex.save` / :meth:`StringIndex.load` — versioned snapshots
  in the reference's format (:mod:`repro_torch.index.snapshot`).

The device decides the path: on the card the builder places keys with K2/K1
(bulk loads and a merge's replay), lookups and the write path's base walk
run K4, ranks K5 and scans K6; on the CPU the plain versions run.  Both give
the reference's answers bit for bit.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.builder import LITSBuilder, LITSConfig
from repro_torch.core.hpt import uniform_hpt
from repro_torch.core.strings import StringSet
from repro_torch.core.tensor_index import (
    TensorIndex, delete_batch, freeze, insert_batch, lookup_values, merge_delta, pad_queries,
    scan_batch, search_batch,
)
from repro_torch.kernels._build import resolve_device

from .snapshot import load_index, save_index


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Index policy: sizing, build policy and the device."""

    width: Optional[int] = None          # None: longest bulk-load key + headroom
    delta_capacity: int = 4096           # delta-buffer entry pool size
    delta_bytes: Optional[int] = None    # delta byte pool (None: capacity-derived)
    delta_probes: int = 16               # open-addressing probe bound
    auto_merge_threshold: Optional[float] = 0.75  # None disables auto-compaction
    scan_window: int = 16                # default ScanRequest window
    builder: Optional[LITSConfig] = None  # host build policy (cnode cap, HPT shape)
    device: str = "cuda"                 # where the index lives and the kernels run


class Status(enum.IntEnum):
    """Per-op result codes, the reference's: failures are data, never exceptions."""

    OK = 0
    NOT_FOUND = 1            # GET: key absent
    REJECTED_OVER_WIDTH = 2  # key longer than the index width (unrepresentable)
    REJECTED_FULL = 3        # PUT/DELETE: delta pool full (merge and retry)
    UNSUPPORTED = 4          # op not available on this implementation
    ROUTING_OVERFLOW = 5     # distributed: a shard's routing capacity was exceeded
    OVERLOADED = 6           # service admission control shed this op: back off, retry
    FORBIDDEN = 7            # tenant isolation: a scan cursor of another tenant


@dataclasses.dataclass(frozen=True, slots=True)
class GetRequest:
    key: bytes


@dataclasses.dataclass(frozen=True, slots=True)
class PutRequest:
    key: bytes
    value: int


@dataclasses.dataclass(frozen=True, slots=True)
class ScanRequest:
    start: bytes
    window: Optional[int] = None   # None -> IndexConfig.scan_window


@dataclasses.dataclass(frozen=True, slots=True)
class DeleteRequest:
    key: bytes


Request = Union[GetRequest, PutRequest, ScanRequest, DeleteRequest]


@dataclasses.dataclass(frozen=True, slots=True)
class OpResult:
    status: Status
    value: Optional[int] = None       # GET hit: the stored 64-bit value
    updated: bool = False             # PUT: the key existed and its value was updated
    entries: Optional[Tuple[Tuple[bytes, int], ...]] = None  # SCAN results

    @property
    def ok(self) -> bool:
        return self.status == Status.OK


# results without a payload, shared: they are frozen
_PUT_OK = OpResult(Status.OK)
_PUT_UPDATED = OpResult(Status.OK, updated=True)
_DELETED = OpResult(Status.OK)
_NOT_FOUND = OpResult(Status.NOT_FOUND)
_REJECTED_OVER_WIDTH = OpResult(Status.REJECTED_OVER_WIDTH)
_REJECTED_FULL = OpResult(Status.REJECTED_FULL)
OVERLOADED_RESULT = OpResult(Status.OVERLOADED)


@dataclasses.dataclass
class BatchResult:
    """``execute`` output: per-op results in request order and the batch's effects."""

    results: List[OpResult]
    n_get: int = 0
    n_put: int = 0
    n_scan: int = 0
    n_delete: int = 0
    merged: bool = False              # a merge ran during this batch
    delta_fill: float = 0.0           # fill fraction after the batch

    def statuses(self) -> List[Status]:
        return [r.status for r in self.results]


@dataclasses.dataclass(frozen=True)
class MergeTicket:
    """One open merge epoch: the index ``run_merge`` replays (writes meanwhile
    land on the live index and are journaled), its epoch, and whether the
    builder was rebuilt from the pools for it (its values are then current)."""

    ti: TensorIndex
    epoch: int
    builder_fresh: bool


def _coalesce_journal(journal: list) -> list:
    """Consecutive journal batches of one kind joined, in arrival order, so
    that the commit replays each run of puts or deletes as one batch."""
    out: list = []
    for kind, qb, ql, lo, hi in journal:
        if out and out[-1][0] == kind:
            k, pqb, pql, plo, phi = out[-1]
            out[-1] = (k, np.concatenate([pqb, qb]), np.concatenate([pql, ql]),
                       None if lo is None else np.concatenate([plo, lo]),
                       None if hi is None else np.concatenate([phi, hi]))
        else:
            out.append((kind, qb, ql, lo, hi))
    return out


def _pad_batch_pow2(qb, ql, lo, hi):
    """A replayed batch padded to a power-of-two row count, as the reference
    pads it.  Pad rows carry the over-width length sentinel (``width + 1``),
    which no stored key has: the write path claims nothing for them.  They
    are ops all the same, and not base puts, so they can make a base put to
    entry 0 in the batch lost, as in the reference (ROADMAP Queue 3)."""
    real = qb.shape[0]
    cap = 1 << max(real - 1, 0).bit_length()
    if cap == real:
        return qb, ql, lo, hi
    pad = cap - real
    qb = np.concatenate([qb, np.zeros((pad, qb.shape[1]), qb.dtype)])
    ql = np.concatenate([ql, np.full(pad, qb.shape[1] + 1, ql.dtype)])
    if lo is not None:
        lo = np.concatenate([lo, np.zeros(pad, lo.dtype)])
        hi = np.concatenate([hi, np.zeros(pad, hi.dtype)])
    return qb, ql, lo, hi


def _split_np(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    v = np.asarray(vals, np.int64)
    lo = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (v >> 32).astype(np.int32)
    return lo, hi


def _join_values(lo, hi) -> np.ndarray:
    lo = np.asarray(lo, np.int32).view(np.uint32).astype(np.int64)
    hi = np.asarray(hi, np.int32).astype(np.int64)
    return (hi << 32) | lo


class StringIndexBase:
    """What every StringIndex implementation provides: ``execute`` and
    ``get_batch``, and the one mapping of get answers to results."""

    config: IndexConfig

    def execute(self, batch: Sequence[Request]) -> BatchResult:
        raise NotImplementedError

    def get_batch(self, keys: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    @staticmethod
    def _map_get_results(gets, found, vals, width: int, results) -> None:
        """(found, values) arrays -> an OpResult per get, written into
        ``results`` at the get's position in its batch."""
        for (i, req), f, v in zip(gets, found.tolist(), vals.tolist()):
            if len(req.key) > width:
                results[i] = _REJECTED_OVER_WIDTH
            elif f:
                results[i] = OpResult(Status.OK, value=v)
            else:
                results[i] = _NOT_FOUND


class StringIndex(StringIndexBase):
    """Single-device LITS over the HPT + sub-trie + PMSS hybrid."""

    def __init__(self, builder: Optional[LITSBuilder], ti: TensorIndex,
                 config: IndexConfig):
        self._builder = builder        # None: rebuilt from the pools at the first merge
        self.ti = ti
        self.config = config
        self.merge_count = 0
        self._host_pool = None         # host copies of (key_bytes, ent_off, ent_len)
        # None while no merge is open; else the writes landed since
        # begin_merge, replayed onto the merged index at commit_merge
        self._merge_journal: Optional[list] = None
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

    def save(self, path: str) -> None:
        """Versioned snapshot of the whole index (base and live delta)."""
        save_index(self.ti, path)

    @classmethod
    def load(cls, path: str, config: Optional[IndexConfig] = None) -> "StringIndex":
        """Restore a snapshot onto ``config.device``.  ``config`` gives the
        run-time policy (merge threshold, scan window, device); the width and
        the delta's sizing come from the snapshot.  The host builder is
        rebuilt from the pools at the first merge."""
        cfg = config or IndexConfig()
        return cls(None, load_index(path, device=cfg.device), cfg)

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
        return self._to_device(*pad_queries(list(keys), self.ti.width))

    def _to_device(self, *arrays):
        return [torch.from_numpy(a).to(self.ti.device) for a in arrays]

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
        delta buffer full come back with both masks False.  ``merged`` says
        that the batch then merged the delta (:meth:`_maybe_merge`).
        """
        if not len(keys):
            return np.zeros(0, bool), np.zeros(0, bool), False
        qb, ql = pad_queries(list(keys), self.ti.width)
        lo, hi = _split_np(np.asarray(values, np.int64))
        self.ti, ins, upd = insert_batch(self.ti, *self._to_device(qb, ql, lo, hi))
        ins, upd = self._finish_write(ins, upd)
        if self._merge_journal is not None:
            # only the accepted ops: a refused one was reported refused
            acc = ins | upd
            if acc.any():
                self._merge_journal.append(("put", qb[acc], ql[acc], lo[acc], hi[acc]))
        return ins, upd, self._maybe_merge()

    def delete_batch(self, keys: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Deletes: (deleted mask, rejected-full mask, merged).

        A key in the delta gets its tombstone set in place; a key that lives
        only in the frozen base claims a tombstone entry that shadows it.
        Gets and scans see the delete at once.  ``merged`` as in
        :meth:`put_batch`.
        """
        if not len(keys):
            return np.zeros(0, bool), np.zeros(0, bool), False
        qb, ql = pad_queries(list(keys), self.ti.width)
        self.ti, deleted, rejected = delete_batch(self.ti, *self._to_device(qb, ql))
        deleted, rejected = self._finish_write(deleted, rejected)
        if self._merge_journal is not None and deleted.any():
            # only the deletes that took effect: the others change nothing
            self._merge_journal.append(("delete", qb[deleted], ql[deleted], None, None))
        return deleted, rejected, self._maybe_merge()

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

    def put(self, key: bytes, value: int) -> OpResult:
        return self.execute([PutRequest(key, value)]).results[0]

    def delete(self, key: bytes) -> OpResult:
        return self.execute([DeleteRequest(key)]).results[0]

    def scan(self, start: bytes, window: Optional[int] = None) -> List[Tuple[bytes, int]]:
        res = self.execute([ScanRequest(start, window)]).results[0]
        return list(res.entries or ())

    def execute(self, batch: Sequence[Request]) -> BatchResult:
        """Run a mixed GET/PUT/SCAN/DELETE batch as grouped dispatches.

        Puts apply first (one ``put_batch``), then deletes (one
        ``delete_batch``: a delete beats a put of the same key in the
        batch), then gets (one ``get_batch``) and scans (one ``scan_batch``
        per distinct window, one copy to the host each) see the index after
        the writes.  Failures come back as :class:`Status` codes; only a
        request of an unknown type raises.
        """
        results: List[Optional[OpResult]] = [None] * len(batch)
        gets: List[Tuple[int, GetRequest]] = []
        puts: List[Tuple[int, PutRequest]] = []
        dels: List[Tuple[int, DeleteRequest]] = []
        scans: List[Tuple[int, ScanRequest]] = []
        for i, req in enumerate(batch):
            if isinstance(req, GetRequest):
                gets.append((i, req))
            elif isinstance(req, PutRequest):
                puts.append((i, req))
            elif isinstance(req, DeleteRequest):
                dels.append((i, req))
            elif isinstance(req, ScanRequest):
                scans.append((i, req))
            else:
                raise TypeError(f"unknown request type: {type(req).__name__}")

        merged = False
        width = self.ti.width
        if puts:
            ins, upd, merged = self.put_batch([r.key for _, r in puts],
                                              [r.value for _, r in puts])
            for (i, req), in_, up in zip(puts, ins.tolist(), upd.tolist()):
                if len(req.key) > width:
                    results[i] = _REJECTED_OVER_WIDTH
                elif in_ or up:
                    results[i] = _PUT_UPDATED if up else _PUT_OK
                else:
                    results[i] = _REJECTED_FULL

        if dels:
            deleted, rejected, dmerged = self.delete_batch([r.key for _, r in dels])
            merged = merged or dmerged
            for (i, req), d, rej in zip(dels, deleted.tolist(), rejected.tolist()):
                if len(req.key) > width:
                    results[i] = _REJECTED_OVER_WIDTH
                elif d:
                    results[i] = _DELETED
                elif rej:
                    results[i] = _REJECTED_FULL
                else:
                    results[i] = _NOT_FOUND

        if gets:
            found, vals = self.get_batch([r.key for _, r in gets])
            self._map_get_results(gets, found, vals, width, results)

        if scans:
            by_window: Dict[int, List[Tuple[int, ScanRequest]]] = {}
            for i, req in scans:
                w = self.config.scan_window if req.window is None else req.window
                by_window.setdefault(w, []).append((i, req))
            pool, ent_off, ent_len = self._host_entries()
            for w, group in by_window.items():
                self._scan_group(group, w, pool, ent_off, ent_len, results)

        return BatchResult(
            results=results,  # type: ignore[arg-type]
            n_get=len(gets), n_put=len(puts), n_scan=len(scans),
            n_delete=len(dels), merged=merged, delta_fill=self._delta_fill,
        )

    def _scan_group(self, group, window, pool, ent_off, ent_len, results) -> None:
        """One scan group of ``execute``: one ``scan_batch``, then one copy
        to the host of the windows, their values and, with a live delta,
        the delta entries' key bytes, gathered on the device with every
        index clamped as the reference's gathers clip."""
        ti = self.ti
        eids, valid, isd = self.scan_batch([r.start for _, r in group], window)
        vlo, vhi = lookup_values(ti, eids.clamp(min=0), isd)
        fetch = [eids, valid, isd, vlo, vhi]
        if self._delta_fill > 0.0:
            e = eids.clamp(0, ti.de_off.shape[0] - 1).long()
            didx = (ti.de_off[e].long()[..., None]
                    + torch.arange(ti.width, device=ti.device)).clamp(max=ti.db_bytes.shape[0] - 1)
            fetch += [ti.de_len[e], ti.db_bytes[didx]]
        got = [t.cpu().numpy() for t in fetch]
        eids, valid, isd, vlo, vhi = got[:5]
        dlen, dbytes = got[5:] if len(got) > 5 else (None, None)
        vals = _join_values(vlo, vhi)
        for row, (i, _req) in enumerate(group):
            entries = []
            for col, (e, v, ok, d) in enumerate(zip(eids[row].tolist(), vals[row].tolist(),
                                                    valid[row].tolist(), isd[row].tolist())):
                if not ok:
                    continue
                if d:
                    key = dbytes[row, col, : dlen[row, col]].tobytes()
                else:
                    key = pool[ent_off[e]: ent_off[e] + ent_len[e]].tobytes()
                entries.append((key, v))
            results[i] = OpResult(Status.OK, entries=tuple(entries))

    # -- compaction --------------------------------------------------------

    def merge(self) -> None:
        """Compaction: replay the delta buffer into the host builder,
        refreeze, swap.  Runs by itself from ``put_batch``/``delete_batch``
        at ``config.auto_merge_threshold``."""
        ticket = self.begin_merge()
        try:
            new_ti = self.run_merge(ticket)
        except BaseException:
            self.abort_merge(ticket)
            raise
        self.commit_merge(ticket, new_ti)

    def begin_merge(self) -> MergeTicket:
        """Open a merge epoch: keep the current index for the replay and
        start the journal.  One merge may be open at a time."""
        if self._merge_journal is not None:
            raise RuntimeError("a merge epoch is already open")
        self._merge_journal = []
        return MergeTicket(ti=self.ti, epoch=self._epoch, builder_fresh=self._builder is None)

    def run_merge(self, ticket: MergeTicket) -> TensorIndex:
        """Replay the ticket's delta into the builder and refreeze; reads the
        ticket's index and the builder, never the live ``self.ti``."""
        builder = self._ensure_builder(ticket.ti)
        # a builder in lockstep with the index takes the base values that
        # puts updated in place; one rebuilt just now read them already
        return merge_delta(builder, ticket.ti, sync_base_values=not ticket.builder_fresh)

    def commit_merge(self, ticket: MergeTicket, new_ti: TensorIndex) -> int:
        """Swap the merged index in and replay the journal onto it in arrival
        order, each run of one kind as one batch padded to a power of two.
        Returns the number of ops replayed."""
        journal, self._merge_journal = self._merge_journal or [], None
        redrained = 0
        for kind, qb, ql, lo, hi in _coalesce_journal(journal):
            real = qb.shape[0]
            redrained += real
            qb, ql, lo, hi = _pad_batch_pow2(qb, ql, lo, hi)
            for attempt in (0, 1):
                if kind == "put":
                    new_ti, ins, upd = insert_batch(new_ti, *self._to_device(qb, ql, lo, hi))
                    clean = bool((ins | upd)[:real].all())
                else:
                    new_ti, _, rej = delete_batch(new_ti, *self._to_device(qb, ql))
                    clean = not bool(rej[:real].any())
                if clean:
                    break
                if attempt:
                    # refused against an empty delta: the batch alone is larger
                    # than the pool, and its ops were acknowledged
                    raise RuntimeError(
                        "re-drain rejected acknowledged ops even after a fold-down "
                        "merge; delta pool too small for the journal batch")
                # the fresh delta filled during the replay: fold it down, retry
                new_ti = merge_delta(self._ensure_builder(), new_ti, sync_base_values=True)
        self.ti = new_ti
        self.merge_count += 1
        self._host_pool = None
        self._mirror(self._delta_state().cpu())
        return redrained

    def abort_merge(self, ticket: MergeTicket) -> None:
        """Close a merge epoch without a swap; the journal is dropped."""
        self._merge_journal = None

    def _maybe_merge(self) -> bool:
        """Merge when the delta fill reached the threshold or a write was
        refused; not with the policy off, nor inside an open merge epoch
        (whose commit replays this write)."""
        thr = self.config.auto_merge_threshold
        if thr is None or self._merge_journal is not None:
            return False
        if self._overflowed or self._delta_fill >= thr:
            self.merge()
            return True
        return False

    def _ensure_builder(self, ti: Optional[TensorIndex] = None) -> LITSBuilder:
        """The host builder, rebuilt when there is none from the live
        entries of ``ti`` (default: the live index) with the live index's
        key pool.  A rebuilt builder trains its HPT anew, so entry ids after
        the merge may differ; keys and values do not."""
        if self._builder is None:
            ti = self.ti if ti is None else ti
            pool, ent_off, ent_len = self._host_entries()
            if int(ti.root_item) == 0:
                # no live entry: freeze pads ent_sorted with entry 0, which
                # may be a deleted key that must not come back
                b = LITSBuilder(config=self.config.builder, hpt=uniform_hpt(),
                                device=self.config.device)
                b.width = ti.width
                b._sorted_cache = np.zeros(0, np.int64)
                self._builder = b
                return b
            eids = ti.ent_sorted.cpu().numpy().astype(np.int64)
            vals = _join_values(ti.ent_val_lo.cpu().numpy(), ti.ent_val_hi.cpu().numpy())
            keys = [pool[ent_off[i]: ent_off[i] + ent_len[i]].tobytes() for i in eids]
            b = LITSBuilder(config=self.config.builder, device=self.config.device)
            b.bulkload(StringSet.from_list(keys), vals[eids], width=ti.width)
            self._builder = b
        return self._builder

    def _host_entries(self):
        """Host copies of the live index's key pool and entry table, kept
        until the next merge."""
        if self._host_pool is None:
            self._host_pool = tuple(t.cpu().numpy() for t in (
                self.ti.key_bytes, self.ti.ent_off, self.ti.ent_len))
        return self._host_pool

    def _entry_key(self, eid: int) -> bytes:
        pool, ent_off, ent_len = self._host_entries()
        return pool[ent_off[eid]: ent_off[eid] + ent_len[eid]].tobytes()
