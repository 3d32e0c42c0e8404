"""Distributed LITS query service: CDF range partition + routed lookups.

The counterpart of :mod:`repro.distributed.index_service`.  The paper's own
global model is the partition function: ``GetCDF`` is monotone in
lexicographic order, so CDF boundary values define a range partition of the
key space.  Each shard holds an independent LITS over its key range; all
shards' pools are padded to a common size and stacked with a leading shard
axis (:func:`build_sharded`).

A routed lookup (:func:`make_service_fn`) does what the reference's
``shard_map`` program does on each device:

  1. every sender computes GetCDF of its rows from character 0 (K2 on the
     card), with the HPT all shards share,
  2. buckets it against the boundaries (``searchsorted(side="right")``)
     -> owner shard,
  3. packs its rows per destination into ``(n, C, W)`` send buffers in
     ``argsort(owner)`` order; rows past the capacity ``C`` are dropped and
     counted,
  4. the buffers are exchanged, and each owner searches the ``n * C`` rows
     it received with ``base_search`` (K4 on the card; no delta probe), then
     ``lookup_values``, then ``found &= qlen > 0``,
  5. the results are exchanged back and unpacked to the senders' row order.

The reference runs one SPMD program over a mesh; the port exchanges the
send buffers explicitly, in one of two forms the caller chooses:

* ``group=None``: every shard lives in this process on one device, and each
  exchange is the transpose ``(n_src, n_dst, C) -> (n_dst, n_src, C)`` —
  what the reference does when every shard of a mesh is in one process;
* ``group=`` a ``torch.distributed`` process group of ``n_shards`` ranks:
  rank ``r`` holds shard ``r`` only, and the five exchanges of the
  reference's ``all_to_all`` are ``all_to_all_single`` calls (NCCL between
  cards, gloo between CPU processes).  Every call of :meth:`get_batch`,
  :meth:`scan_entries` and :meth:`execute` is then collective: every rank
  makes it, with its own rows, and gets the answers to its own rows.

Both reproduce two faults of the reference (ROADMAP Queue 3):

* its docstring promises an ε-margin recheck at shard boundaries that its
  code never does.  The boundaries are float32 midpoints of the host's
  float64 GetCDF, the router uses the device's float32 GetCDF, so a stored
  key whose two CDFs fall on opposite sides of a boundary is routed to a
  shard that does not hold it and comes back NOT_FOUND;
* a shard with fewer sorted entries than the largest has its ``ent_sorted``
  padded with entry 0 (its smallest key), and the reference's scan ranks
  and gathers over the padded order.  The port scans the shard's true order
  with K6 and replays the reference's search over the padding from that
  rank (:func:`_padded_window`), so a window gives the reference's answer:
  a shard's smallest key again after its largest, or an empty window where
  the search stepped into the padding.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.builder import LITSBuilder
from repro_torch.distributed.sharding import axes_extent
from repro_torch.core.hpt import get_cdf, get_cdf_np64
from repro_torch.core.strings import StringSet, sort_order
from repro_torch.core.tensor_index import (
    DATA_FIELDS, STATIC_FIELDS, TensorIndex, base_search, freeze, lookup_values, pad_queries,
    scan_batch,
)
from repro_torch.index.facade import (
    BatchResult, GetRequest, IndexConfig, OpResult, ScanRequest, Status, StringIndexBase,
)
from repro_torch.kernels._build import resolve_device
from repro_torch.kernels.strops import str_cmp_full


class RoutingOverflowError(RuntimeError):
    """A routed query batch exceeded a shard's per-destination capacity."""


@dataclasses.dataclass
class ShardedIndex:
    stacked: TensorIndex          # every data field has a leading [n_shards] dim
    boundaries: np.ndarray        # (n_shards-1,) f32 CDF split points
    n_shards: int
    width: int
    sorted_lens: Tuple[int, ...]  # each shard's ent_sorted length before the padding


def build_sharded(keys: List[bytes], values: np.ndarray, n_shards: int,
                  **builder_kw) -> ShardedIndex:
    """CDF range partition -> one LITS per shard -> pools stacked.  One
    global HPT, from a probe bulk load of every key, is every shard's model
    and the router's.  ``builder_kw`` go to every :class:`LITSBuilder`
    (``device`` among them: the shards live there)."""
    ss = StringSet.from_list(keys)
    order = sort_order(ss)
    ss = ss.take(order)
    values = np.asarray(values)[order]
    probe = LITSBuilder(**builder_kw)
    probe.bulkload(StringSet(ss.bytes.copy(), ss.lens.copy()), values.copy())
    hpt = probe.hpt
    width = probe.width
    cdfs = get_cdf_np64(hpt, ss).astype(np.float32)
    n = len(ss)
    cuts = [int(round(i * n / n_shards)) for i in range(1, n_shards)]
    boundaries = []
    for c in cuts:
        lo = cdfs[c - 1] if c > 0 else 0.0
        hi = cdfs[c] if c < n else 1.0
        boundaries.append((float(lo) + float(hi)) / 2.0)
    boundaries = np.asarray(boundaries, np.float32)
    shard_of = np.searchsorted(boundaries, cdfs, side="right")
    tis = []
    for s in range(n_shards):
        m = shard_of == s
        b = LITSBuilder(hpt=hpt, **{k: v for k, v in builder_kw.items() if k != "hpt"})
        b.bulkload(StringSet(ss.bytes[m], ss.lens[m]), values[m], width=width)
        tis.append(freeze(b))
    return ShardedIndex(_stack_indices(tis), boundaries, n_shards, width,
                        tuple(t.ent_sorted.shape[0] for t in tis))


def _stack_indices(tis: List[TensorIndex]) -> TensorIndex:
    """Pad every pool with zeros to the max size across shards, stack on a
    new axis 0; the walk and rank bounds are the shards' maximum."""
    out = {}
    for name in DATA_FIELDS:
        leaves = [getattr(t, name) for t in tis]
        mx = max(leaf.shape[0] for leaf in leaves) if leaves[0].ndim else 0
        out[name] = torch.stack([
            torch.cat([leaf, leaf.new_zeros((mx - leaf.shape[0],) + leaf.shape[1:])])
            if leaf.ndim and leaf.shape[0] < mx else leaf for leaf in leaves])
    meta = dict(
        width=tis[0].width,
        max_iters=max(t.max_iters for t in tis),
        cnode_cap=tis[0].cnode_cap,
        rank_iters=max(t.rank_iters for t in tis),
        delta_probes=tis[0].delta_probes,
        cdf_steps=max(t.cdf_steps for t in tis),
    )
    return TensorIndex(**out, **meta)


def _slice_shard(stacked: TensorIndex, s: int, device=None) -> TensorIndex:
    """Shard ``s`` of a stacked index (views, or copies on ``device``)."""
    return TensorIndex(**{name: getattr(stacked, name)[s].to(device or stacked.device)
                          for name in DATA_FIELDS},
                       **{k: getattr(stacked, k) for k in STATIC_FIELDS})


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    """The all_to_all: ``(a, b, C, ...) -> (b, a, C, ...)``.  In one process
    it is the transpose; across a group each rank holds its own row of the
    first axis (``a == 1``) and receives its row of the second.  The receive
    buffer starts zeroed: over torch's fake process group (the dry-run) no
    collective moves data, and the owners then search empty rows rather
    than whatever the buffer held."""
    if group is None:
        return t.transpose(0, 1).contiguous()
    out = torch.zeros_like(t[0])
    dist.all_to_all_single(out, t[0].contiguous(), group=group)
    return out[None]


class RoutedLookup:
    """The counterpart of the reference's ``make_service_fn`` program:
    ``(qbytes, qlens) -> (found, lo, hi, overflow)``.  The rows are the
    senders' blocks, one after the other (``senders`` of them in this
    process, each ``B / senders`` rows); ``overflow`` holds each sender's
    dropped rows.  ``shards`` are the shards this process holds, by id."""

    def __init__(self, shards: dict, boundaries: torch.Tensor, n_shards: int,
                 per_dest_capacity: int, group=None, mesh=None,
                 shard_axes: Sequence[str] = ()):
        self.shards, self.boundaries = shards, boundaries
        self.n, self.C, self.group = n_shards, per_dest_capacity, group
        self.senders = n_shards if group is None else 1
        self.mesh, self.shard_axes = mesh, tuple(shard_axes)

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the query rows ``t`` (a leading row dim), split
        over the mesh axes ``shard_axes`` as the reference's ``P(shard_axes)``
        splits them; ``t`` itself without them."""
        if not self.shard_axes:
            return t
        n, j = axes_extent(self.shard_axes, self.mesh)
        return torch.chunk(t, n, dim=0)[j]

    def __call__(self, qbytes: torch.Tensor, qlens: torch.Tensor):
        n, C, S = self.n, self.C, self.senders
        B, W = qbytes.shape
        dev = qbytes.device
        router = next(iter(self.shards.values()))
        cdf = get_cdf(router.cdf_tab, router.prob_tab, qbytes, qlens, 0)
        owner = torch.searchsorted(self.boundaries, cdf, right=True)
        # pack: each sender's rows in stable argsort(owner) order, a slot per
        # destination; rows past the capacity are dropped and counted
        key = torch.arange(S, device=dev).repeat_interleave(B // S) * n + owner
        order = torch.argsort(key, stable=True)
        sk = key[order]
        slot = torch.arange(B, device=dev) - torch.searchsorted(sk, sk)
        ok = slot < C
        dst, pos, rows = sk[ok], slot[ok], order[ok]
        sendq = qbytes.new_zeros((S * n, C, W))
        sendq[dst, pos] = qbytes[rows]
        sendl = torch.zeros((S * n, C), dtype=torch.int32, device=dev)
        sendl[dst, pos] = qlens[rows].to(torch.int32)
        overflow = (~ok).view(S, B // S).sum(dim=1)
        # route to the owners, which search what they received
        recvq = _exchange(sendq.view(S, n, C, W), self.group)
        recvl = _exchange(sendl.view(S, n, C), self.group)
        res = []
        for d, ti in enumerate(self.shards.values()):
            rq, rl = recvq[d].reshape(-1, W), recvl[d].reshape(-1)
            found, eid = base_search(ti, rq, rl)
            lo, hi = lookup_values(ti, eid, torch.zeros_like(found))
            res.append(((found & (rl > 0)).to(torch.uint8), lo, hi))
        # send the results home, unpack to the senders' row order
        sc = slot.clamp(max=C - 1)
        out = []
        for part in zip(*res):
            back = _exchange(torch.stack(part).view(-1, n, C), self.group).reshape(S * n, C)
            out.append(back[sk, sc])
        gf = out[0].bool() & ok
        found = torch.empty_like(gf)
        found[order] = gf
        lo, hi = (torch.empty_like(v) for v in out[1:])
        lo[order] = torch.where(gf, out[1], 0)
        hi[order] = torch.where(gf, out[2], 0)
        return found, lo, hi, overflow


def make_service_fn(sidx: ShardedIndex, per_dest_capacity: int = 256, group=None,
                    device=None, *, mesh=None, axis: str = "data",
                    shard_axes: Optional[Sequence[str]] = None) -> RoutedLookup:
    """The routed lookup over ``sidx`` (:class:`RoutedLookup`).  With
    ``group=None`` and no ``mesh`` it holds every shard; with a process group
    of ``n_shards`` ranks, rank ``r`` holds shard ``r``.  With a ``mesh``
    (a ``torch.distributed`` device mesh, as the reference's
    ``make_service_fn(sidx, mesh, axis, shard_axes=...)`` takes one) the
    index is partitioned over the mesh axis ``axis``, whose group routes the
    rows, and replicated over its other axes: each rank holds the shard of
    its coordinate on ``axis``, and the query rows are split over
    ``shard_axes`` (default ``(axis,)``; extra axes act as serving replicas,
    ``RoutedLookup.local_rows``).  The shards go to ``device`` (default:
    where ``sidx`` is)."""
    n = sidx.n_shards
    if mesh is not None:
        group = mesh.get_group(axis)
        shard_axes = (axis,) if shard_axes is None else tuple(shard_axes)
    if group is not None and dist.get_world_size(group) != n:
        raise ValueError(f"the group has {dist.get_world_size(group)} ranks; the index "
                         f"has {n} shards and needs one rank per shard")
    dev = sidx.stacked.items.device if device is None else resolve_device(device)
    local = range(n) if group is None else [dist.get_rank(group)]
    shards = {s: _slice_shard(sidx.stacked, s, dev) for s in local}
    return RoutedLookup(shards, torch.from_numpy(sidx.boundaries).to(dev), n,
                        per_dest_capacity, group, mesh, shard_axes or ())


def _padded_window(ti: TensorIndex, m: int, qbytes, qlens, eids, valid, window: int):
    """The reference's frozen-only scan window over ``ti``'s whole
    ``ent_sorted``, whose rows past ``m`` pad it with entry 0, from the
    window ``(eids, valid)`` over its first ``m`` rows (the true order).

    The first valid entry of that window gives each start's rank ``r`` in
    the true order.  The reference's binary search goes right at a true row
    below ``r`` and at a pad row whose key (entry 0's) is below the start;
    it is replayed from those facts alone, then the window is gathered from
    the padded order as the reference gathers it."""
    N = ti.ent_sorted.shape[0]
    B = qbytes.shape[0]
    dev = qbytes.device
    order = ti.ent_sorted[:m].long()
    pos = torch.zeros(ti.ent_off.shape[0], dtype=torch.long, device=dev)
    pos[order] = torch.arange(m, device=dev)
    r = torch.where(valid[:, 0], pos[eids[:, 0].clamp(min=0).long()], m)
    pad_below = str_cmp_full(qbytes, qlens, ti.key_bytes, ti.ent_off[:1].expand(B),
                             ti.ent_len[:1].expand(B)) > 0
    lo = torch.zeros(B, dtype=torch.long, device=dev)
    hi = torch.full((B,), N, dtype=torch.long, device=dev)
    for _ in range(ti.rank_iters):
        mid = (lo + hi) // 2
        go = torch.where(mid < m, mid < r, pad_below) & (lo < hi)
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go | (lo >= hi), hi, mid)
    idx = lo[:, None] + torch.arange(window, device=dev)[None, :]
    valid = idx < N
    return torch.where(valid, ti.ent_sorted[idx.clamp(max=N - 1)], -1), valid


# ---------------------------------------------------------------------------
# StringIndex over the shards
# ---------------------------------------------------------------------------

class DistributedStringIndex(StringIndexBase):
    """A :class:`repro_torch.index.StringIndexBase` over a sharded index.

    The same typed batched-op surface as the local
    :class:`repro_torch.index.StringIndex`: ``get_batch`` / ``execute``
    with per-op :class:`~repro_torch.index.Status` codes.  Serving
    snapshots are immutable (delta probes are skipped shard-side), so PUTs
    and DELETEs report ``Status.UNSUPPORTED`` — rebuild via :meth:`build`
    to ingest.  SCANs are served (:meth:`scan_entries`): the CDF partition
    is a range partition of lexicographic order, so per-shard windows
    concatenate in shard order into the global window.  Front it with
    :class:`repro_torch.serve.service.IndexService` to serve it as a
    multi-tenant request plane.

    ``config.device`` decides where the shards live (default the card);
    ``group`` picks the exchange (module docstring): ``None`` holds every
    shard here, a process group of ``n_shards`` ranks holds shard ``rank``.
    """

    def __init__(self, sidx: ShardedIndex, group=None, per_dest_capacity: int = 256,
                 config: Optional[IndexConfig] = None):
        self.config = config or IndexConfig()
        self.sidx = sidx
        self.group = group
        self._per_dest_capacity = per_dest_capacity
        self._fn = make_service_fn(sidx, per_dest_capacity, group, self.config.device)
        # per shard held: a view pinned to the frozen stream (de_count 0)
        # over its true sorted order, and whether its order is padded
        self._scan_views = {}
        for s, ti in self._fn.shards.items():
            m = sidx.sorted_lens[s]
            self._scan_views[s] = (dataclasses.replace(
                ti, ent_sorted=ti.ent_sorted[:m], de_count=torch.zeros_like(ti.de_count)),
                m < ti.ent_sorted.shape[0] and bool(ti.root_item != 0))
        self._shard_host: dict = {}   # shard id -> host entry-pool mirrors
        #                               (immutable snapshot: cache is safe)

    @classmethod
    def build(cls, keys: List[bytes], values: np.ndarray, n_shards: int, group=None,
              config: Optional[IndexConfig] = None, **kw) -> "DistributedStringIndex":
        """Bulk load: CDF-range partition -> per-shard LITS, on
        ``config.device``."""
        cfg = config or IndexConfig()
        sidx = build_sharded(keys, values, n_shards, device=cfg.device)
        return cls(sidx, group=group, config=cfg, **kw)

    @property
    def width(self) -> int:
        return self.sidx.width

    @property
    def n_shards(self) -> int:
        return self.sidx.n_shards

    @property
    def device(self) -> torch.device:
        return self._fn.boundaries.device

    def get_batch(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        """Routed point lookups: (found mask, int64 values; misses hold 0).

        The batch is padded to a multiple of the senders in this process
        (zero-length pads can never match — ``found &= qlens > 0``
        shard-side), routed, searched on the owner shard and routed back.

        Raises :class:`RoutingOverflowError` if any destination shard
        received more than ``per_dest_capacity`` rows from a sender (from
        any rank's, across a group): the dropped queries would otherwise
        come back as silently-wrong NOT_FOUNDs.
        """
        B = len(keys)
        if B == 0 and self.group is None:
            return np.zeros(0, bool), np.zeros(0, np.int64)
        S = self._fn.senders
        Bp = -(-B // S) * S
        qb, ql = pad_queries(list(keys), self.width)
        qbp = np.zeros((Bp, qb.shape[1]), np.uint8)
        qbp[:B] = qb
        qlp = np.zeros(Bp, np.int32)
        qlp[:B] = ql
        found, lo, hi, overflow = self._fn(torch.from_numpy(qbp).to(self.device),
                                           torch.from_numpy(qlp).to(self.device))
        dropped = overflow.sum()
        if self.group is not None:
            dist.all_reduce(dropped, group=self.group)
        n_dropped = int(dropped)
        if n_dropped:
            raise RoutingOverflowError(
                f"{n_dropped} queries exceeded per_dest_capacity="
                f"{self._per_dest_capacity} on their owner shard; raise the "
                f"capacity or split the batch")
        found = found[:B].cpu().numpy()
        lo = lo[:B].cpu().numpy().view(np.uint32).astype(np.int64)
        hi = hi[:B].cpu().numpy().astype(np.int64)
        return found, np.where(found, (hi << 32) | lo, 0)

    # -- range scans over the shards ---------------------------------------

    def _shard_host_entries(self, s: int):
        """Host mirrors of shard ``s``'s entry pools (scan results carry
        real key bytes), fetched once: serving snapshots are immutable."""
        if s not in self._shard_host:
            ti = self._fn.shards[s]
            self._shard_host[s] = (ti.key_bytes.cpu().numpy(), ti.ent_off.cpu().numpy(),
                                   ti.ent_len.cpu().numpy())
        return self._shard_host[s]

    def _shard_windows(self, s: int, qb, ql, window: int):
        """Shard ``s``'s window of each start as ``(key, value)`` lists, or
        None where no start has an entry there: its frozen stream only, as
        the reference's shard-side scan (K6 on the card)."""
        ti, padded = self._scan_views[s]
        eids, valid, _ = scan_batch(ti, qb, ql, window)
        if padded:
            eids, valid = _padded_window(self._fn.shards[s], ti.ent_sorted.shape[0], qb, ql,
                                         eids, valid, window)
        vlo, vhi = lookup_values(ti, eids.clamp(min=0), torch.zeros_like(valid))
        eids, valid, vlo, vhi = (x.cpu().numpy() for x in (eids, valid, vlo, vhi))
        if not valid.any():
            return None
        vals = (vhi.astype(np.int64) << 32) | vlo.view(np.uint32).astype(np.int64)
        pool, eo, el = self._shard_host_entries(s)
        out = []
        for e_row, ok_row, v_row in zip(eids.tolist(), valid.tolist(), vals.tolist()):
            row = []
            for e, ok, v in zip(e_row, ok_row, v_row):
                if not ok:
                    break
                row.append((pool[eo[e]: eo[e] + el[e]].tobytes(), v))
            out.append(row)
        return out

    def scan_entries(self, starts, window: int):
        """Range scans: per-query lists of ``(key, value)`` pairs — the next
        ``window`` keys >= each start across ALL shards.

        Each shard scans its frozen stream (``de_count`` zeroed): like the
        shard-side GET path, serving scans skip the delta region.  The CDF
        partition is a range partition of lexicographic order, so shard
        ``s``'s window sorts before shard ``s+1``'s: the windows concatenate
        in shard order and the first ``window`` entries are the answer.
        In one process the shards are scanned in order until every window
        is full; across a group every rank scans its shard for every rank's
        starts and the windows are gathered.
        """
        B = len(starts)
        out = [[] for _ in range(B)]
        if self.group is None:
            if B == 0:
                return out
            qb, ql = (torch.from_numpy(a).to(self.device)
                      for a in pad_queries(list(starts), self.width))
            for s in range(self.n_shards):
                if all(len(o) >= window for o in out):
                    break
                wins = self._shard_windows(s, qb, ql, window)
                for o, w in zip(out, wins or ()):
                    o.extend(w[: window - len(o)])
            return out
        every = [None] * self.n_shards
        dist.all_gather_object(every, list(starts), group=self.group)
        flat = [k for part in every for k in part]
        (s,) = self._fn.shards
        wins = None
        if flat:
            qb, ql = (torch.from_numpy(a).to(self.device) for a in pad_queries(flat, self.width))
            wins = self._shard_windows(s, qb, ql, window)
        parts = [None] * self.n_shards
        dist.all_gather_object(parts, wins, group=self.group)
        first = sum(len(p) for p in every[: dist.get_rank(self.group)])
        for part in parts:
            for o, w in zip(out, (part or ())[first: first + B]):
                o.extend(w[: window - len(o)])
        return out

    def execute(self, batch: Sequence) -> BatchResult:
        """Typed batch entry point (GETs + SCANs on the read-only shards).

        Failures stay data: mutating ops (PUT/DELETE) report
        ``Status.UNSUPPORTED``, and a batch that trips a shard's routing
        capacity marks every get ``Status.ROUTING_OVERFLOW`` (the dropped
        subset is unknowable once routed — retry with a smaller batch or a
        larger ``per_dest_capacity``).  Across a group the call is
        collective: every rank routes its gets, and scans every window any
        rank asks for, in order.
        """
        results = [None] * len(batch)
        gets = [(i, r) for i, r in enumerate(batch) if isinstance(r, GetRequest)]
        scans = [(i, r) for i, r in enumerate(batch) if isinstance(r, ScanRequest)]
        for i, r in enumerate(batch):
            if not isinstance(r, (GetRequest, ScanRequest)):
                results[i] = OpResult(Status.UNSUPPORTED)
        if gets or self.group is not None:
            try:
                found, vals = self.get_batch([r.key for _, r in gets])
            except RoutingOverflowError:
                overflowed = OpResult(Status.ROUTING_OVERFLOW)
                for i, _ in gets:
                    results[i] = overflowed
            else:
                self._map_get_results(gets, found, vals, self.sidx.width, results)
        default_w = self.config.scan_window
        by_window: dict = {}
        for i, r in scans:
            by_window.setdefault(default_w if r.window is None else r.window, []).append((i, r))
        windows = set(by_window)
        if self.group is not None:
            every = [None] * self.n_shards
            dist.all_gather_object(every, sorted(windows), group=self.group)
            windows = set().union(*every)
        for w in sorted(windows):
            reqs = by_window.get(w, [])
            entries = self.scan_entries([r.start for _, r in reqs], w)
            for (i, _r), ent in zip(reqs, entries):
                results[i] = OpResult(Status.OK, entries=tuple(ent))
        return BatchResult(results=results, n_get=len(gets), n_put=0, n_scan=len(scans),
                           n_delete=0, merged=False, delta_fill=0.0)
