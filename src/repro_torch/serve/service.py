"""`IndexService` — the asynchronous, multi-tenant request plane over a
:class:`~repro_torch.index.StringIndexBase`, the port of
:mod:`repro.serve.service`.

* :meth:`IndexService.submit` / :meth:`~IndexService.submit_many` /
  :meth:`~IndexService.submit_batch` enqueue typed ops and return
  :class:`OpFuture` objects; :meth:`~IndexService.execute` submits a batch
  and waits for it.
* Micro-batch coalescing: a flusher thread drains the queue when
  ``max_batch`` ops are pending or the oldest has waited ``max_delay_ms``,
  and runs each flush as ONE ``execute`` on the index, so that many
  callers share one set of device dispatches.  The results are those of a
  direct ``execute`` of the same ops.
* Tenant namespaces: keys are stored as ``tenant + 0x1f + key``, so tenants
  are contiguous, disjoint key ranges; scan results are cut to the caller's
  range and stripped of the prefix.
* Streaming scans: :meth:`~IndexService.scan_page` returns a page and an
  opaque cursor that carries the next key, so that a merge between pages
  neither skips nor repeats an entry; a cursor of another tenant comes back
  ``Status.FORBIDDEN``.
* Admission control: past ``max_queue`` pending ops, submissions resolve at
  once to ``Status.OVERLOADED``.
* Background maintenance: the service turns the facade's auto-merge off
  while it owns the index and merges from a maintenance thread through
  ``begin_merge``/``run_merge``/``commit_merge``; the replay and refreeze
  run outside the index lock while flushes go on, and only the commit
  pauses the request path.  :meth:`~IndexService.close` restores the
  facade's ``auto_merge_threshold``.
* :meth:`~IndexService.stats` — queue depth, flush sizes, coalescing
  factor, shed ops, p50/p99 latency and the merges' pauses, read from host
  counters and the facade's host mirrors only, never from the device.

Both threads reach the kernels (a flush runs K4 and K6, a merge K1 and K2
through the builder) on the device's default stream, so their device work
is serialised in the order the threads enqueue it.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import logging
import re
import threading
import time
from collections import deque
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.index import (
    DeleteRequest,
    GetRequest,
    IndexConfig,
    OpResult,
    OVERLOADED_RESULT,
    PutRequest,
    Request,
    ScanRequest,
    Status,
    StringIndex,
    StringIndexBase,
)

_LOG = logging.getLogger(__name__)

# tenant ids are printable identifiers; the separator byte (0x1f, ASCII unit
# separator) can therefore never appear inside a tenant prefix, which is what
# makes per-tenant key ranges disjoint and contiguous in lexicographic order
TENANT_SEP = b"\x1f"
_TENANT_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Request-plane policy (index policy stays in :class:`IndexConfig`)."""

    max_batch: int = 256           # flush when this many ops are pending
    max_delay_ms: float = 2.0      # ... or when the oldest op is this stale
    max_queue: int = 8192          # admission bound; beyond -> OVERLOADED
    default_tenant: str = "default"
    merge_threshold: Optional[float] = 0.6  # maintenance compaction trigger
    #                                         (None: never merge in background)
    maintenance_interval_ms: float = 500.0  # maintenance poll period (the
    #                                         flusher wakes it early on need)
    latency_window: int = 4096     # ring buffer behind the p50/p99 estimates
    scan_page_size: int = 64       # default scan_page size


@dataclasses.dataclass
class ServiceStats:
    """Point-in-time service metrics snapshot (one :meth:`IndexService.stats` call)."""

    submitted: int = 0             # ops admitted into the queue
    completed: int = 0             # ops resolved through a flush
    shed: int = 0                  # ops refused with Status.OVERLOADED
    flushes: int = 0               # coalesced execute() dispatches
    queue_depth: int = 0           # pending ops right now
    max_flush: int = 0             # largest single flush
    coalescing_factor: float = 0.0  # completed / flushes (ops per dispatch)
    merges: int = 0                # background merge_delta compactions
    delta_fill: float = 0.0        # backing index delta fill right now
    p50_ms: float = 0.0            # median submit->resolve latency
    p99_ms: float = 0.0
    # epoch-based compaction metrics (DESIGN.md §10)
    epoch: int = 0                 # backing index compaction epoch
    merge_pause_ms: float = 0.0    # last commit pause (index lock held)
    merge_pause_ms_max: float = 0.0
    merge_wall_ms: float = 0.0     # last full merge wall time (mostly off-lock)
    redrained_ops: int = 0         # total ops re-drained at commit swaps
    # maintenance-loop health: a persistently failing compaction is surfaced,
    # never silently retried forever
    maintenance_errors: int = 0
    last_maintenance_error: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ScanPage:
    """One :meth:`IndexService.scan_page` result."""

    entries: Tuple[Tuple[bytes, int], ...]  # tenant-local (key, value) pairs
    cursor: Optional[str]                   # opaque token; None = exhausted
    status: Status = Status.OK


class OpFuture:
    """Lightweight future for one submitted op.

    `concurrent.futures.Future` allocates a private Condition (an RLock +
    waiter list) per instance — ~10µs each, which at coalescing batch sizes
    costs more than the fused dispatch it waits for.  Service futures
    instead share ONE condition owned by the service; a flush resolves its
    whole batch and then wakes every waiter once.  API: :meth:`done`,
    :meth:`result` — the subset callers need.
    """

    __slots__ = ("_cv", "_result", "_exc", "_done")

    def __init__(self, cv: threading.Condition):
        self._cv = cv
        self._result = None   # OpResult (submit) or List[OpResult] (batch)
        self._exc: Optional[BaseException] = None
        self._done = False

    def done(self) -> bool:
        return self._done

    def result(self, timeout: Optional[float] = None):
        if not self._done:
            deadline = None if timeout is None else time.monotonic() + timeout
            with self._cv:
                while not self._done:
                    left = (None if deadline is None
                            else deadline - time.monotonic())
                    if left is not None and left <= 0:
                        raise TimeoutError("op not resolved within timeout")
                    self._cv.wait(left)
        if self._exc is not None:
            raise self._exc
        return self._result  # type: ignore[return-value]

    # resolution is service-internal: set fields, then the service notifies
    # the shared condition ONCE per flush (set-before-notify makes the
    # check-then-wait in result() race-free: notify needs the same lock)
    def _set(self, result, exc: Optional[BaseException] = None) -> None:
        self._result = result
        self._exc = exc
        self._done = True


class _Pending:
    """One queued submission: a GROUP of ops resolved by one future.

    `submit()` enqueues a group of one (future -> OpResult);
    `submit_batch()` enqueues the caller's whole batch as one group
    (future -> List[OpResult]) — the bulk path, whose per-op overhead is
    amortized over the group.  Groups are never split across flushes."""

    __slots__ = ("reqs", "raws", "future", "t_submit", "single")

    def __init__(self, reqs: List[Request], raws: Sequence[Request],
                 future: OpFuture, t_submit: float, single: bool):
        self.reqs = reqs        # tenant-encoded requests (what the index sees)
        self.raws = raws        # caller's requests (for result decoding)
        self.future = future
        self.t_submit = t_submit
        self.single = single    # resolve to results[0] instead of the list


class IndexService:
    """Asynchronous multi-tenant request plane over a :class:`StringIndexBase`."""

    def __init__(self, index: StringIndexBase,
                 config: Optional[ServiceConfig] = None):
        self.index = index
        self.config = config or ServiceConfig()
        if self.config.max_batch < 1 or self.config.max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        # compaction belongs to the maintenance thread, not the request path:
        # demote the facade's in-band auto-merge while the service owns the
        # index (runtime policy, per §8 the config object on the instance
        # carries policy, structure is in ti); close() restores it so direct
        # use of the index afterwards keeps its original compaction policy
        self._saved_auto_merge = None
        if getattr(index, "config", None) is not None and \
                getattr(index.config, "auto_merge_threshold", None) is not None:
            self._saved_auto_merge = index.config.auto_merge_threshold
            index.config = dataclasses.replace(
                index.config, auto_merge_threshold=None)
        self._cv = threading.Condition()
        self._done_cv = threading.Condition()   # shared by every OpFuture
        self._queue: deque[_Pending] = deque()
        self._queued_ops = 0                    # ops (not groups) pending
        self._flush_asap = False
        self._closed = False
        # one lock serializes every touch of the backing index (flushes, the
        # begin/commit edges of epoch merges, stats reads of delta_fill).
        # The expensive middle of a merge runs OUTSIDE it (DESIGN.md §10).
        self._index_lock = threading.Lock()
        # serializes whole merges against each other (maintenance thread vs
        # an explicit compact() caller) without blocking the request path
        self._merge_mutex = threading.Lock()
        self._maint_wake = threading.Event()
        self._latencies: deque[float] = deque(maxlen=self.config.latency_window)
        self._submitted = 0
        self._completed = 0
        self._shed = 0
        self._flushes = 0
        self._max_flush = 0
        self._merges = 0
        self._merge_pause_ms = 0.0
        self._merge_pause_ms_max = 0.0
        self._merge_wall_ms = 0.0
        self._redrained = 0
        self._maintenance_errors = 0
        self._last_maintenance_error: Optional[str] = None
        self._logged_errors: set = set()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="lits-service-flusher", daemon=True)
        self._maintenance = threading.Thread(
            target=self._maintenance_loop, name="lits-service-maintenance",
            daemon=True)
        self._flusher.start()
        self._maintenance.start()

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def bulk_load(cls, tenants: Dict[str, Tuple[Sequence[bytes], np.ndarray]],
                  index_config: Optional[IndexConfig] = None,
                  config: Optional[ServiceConfig] = None) -> "IndexService":
        """Build a local :class:`StringIndex` from per-tenant corpora and
        front it with a service: ``{tenant: (keys, values)}`` in, running
        request plane out.  Keys are stored tenant-prefixed, so scans are
        isolated from the first request on."""
        enc_keys: List[bytes] = []
        enc_vals: List[int] = []
        for tenant, (keys, values) in sorted(tenants.items()):
            prefix = _tenant_prefix(tenant)
            vals = np.asarray(values, np.int64)
            if len(vals) != len(keys):
                raise ValueError(f"tenant {tenant!r}: {len(keys)} keys vs "
                                 f"{len(vals)} values")
            for k, v in zip(keys, vals.tolist()):
                enc_keys.append(prefix + k)
                enc_vals.append(v)
        order = np.argsort(np.array(enc_keys, dtype=object))
        enc_keys = [enc_keys[i] for i in order]
        vals = np.asarray(enc_vals, np.int64)[order]
        index = StringIndex.bulk_load(enc_keys, vals, index_config)
        return cls(index, config)

    def close(self, timeout: float = 5.0) -> None:
        """Drain the queue, stop both threads, restore the index's own
        compaction policy.  Idempotent."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._maint_wake.set()
        self._flusher.join(timeout)
        self._maintenance.join(timeout)
        if self._saved_auto_merge is not None:
            self.index.config = dataclasses.replace(
                self.index.config, auto_merge_threshold=self._saved_auto_merge)

    def __enter__(self) -> "IndexService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the async entry points --------------------------------------------

    def submit(self, req: Request, tenant: Optional[str] = None) -> OpFuture:
        """Enqueue one typed op; returns an :class:`OpFuture`.

        Admission control is data, not exceptions: past ``max_queue``
        pending ops the future resolves immediately to
        ``Status.OVERLOADED``.  Exceptions are reserved for malformed
        requests (bad tenant id, unknown op type), matching the facade.
        """
        enc = self._encode(req, tenant)
        fut = OpFuture(self._done_cv)
        with self._cv:
            if self._closed:
                raise RuntimeError("IndexService is closed")
            if self._queued_ops >= self.config.max_queue:
                self._shed += 1
                fut._set(OVERLOADED_RESULT)
                return fut
            self._queue.append(_Pending([enc], (req,), fut,
                                        time.monotonic(), True))
            self._queued_ops += 1
            self._submitted += 1
            self._cv.notify_all()
        return fut

    def submit_many(self, reqs: Sequence[Request],
                    tenant: Optional[str] = None) -> List[OpFuture]:
        """Enqueue a group of ops under ONE lock acquisition, one future each.

        Ops keep their relative order in the queue (FIFO), so a caller's
        get-after-put always lands in the same flush as (with puts planned
        first) or a later flush than its put.  Admission is still per-op:
        the ops past the queue bound resolve to ``Status.OVERLOADED``, the
        rest proceed.
        """
        encs = [self._encode(r, tenant) for r in reqs]
        cv = self._done_cv
        futs = [OpFuture(cv) for _ in reqs]
        now = time.monotonic()
        with self._cv:
            if self._closed:
                raise RuntimeError("IndexService is closed")
            for enc, raw, fut in zip(encs, reqs, futs):
                if self._queued_ops >= self.config.max_queue:
                    self._shed += 1
                    fut._set(OVERLOADED_RESULT)
                    continue
                self._queue.append(_Pending([enc], (raw,), fut, now, True))
                self._queued_ops += 1
                self._submitted += 1
            self._cv.notify_all()
        return futs

    def submit_batch(self, reqs: Sequence[Request],
                     tenant: Optional[str] = None) -> OpFuture:
        """The bulk path: enqueue the whole batch as ONE group with ONE
        future resolving to ``List[OpResult]`` (request order).

        Per-op futures cost a few µs each; a group costs that ONCE, so a
        naturally-batched caller (prefix-cache lookup, record-store dedup)
        keeps direct-``execute`` throughput while still riding the same
        coalescer as everyone else.  Groups are admitted whole: if the
        batch doesn't fit under ``max_queue``, every op sheds with
        ``Status.OVERLOADED`` (a half-admitted batch would be useless).
        Groups are never split across flushes (a flush may overshoot
        ``max_batch`` by at most one group).
        """
        encs = [self._encode(r, tenant) for r in reqs]
        fut = OpFuture(self._done_cv)
        with self._cv:
            if self._closed:
                raise RuntimeError("IndexService is closed")
            if self._queued_ops + len(encs) > self.config.max_queue:
                self._shed += len(encs)
                fut._set([OVERLOADED_RESULT] * len(encs))
                return fut
            self._queue.append(_Pending(encs, reqs, fut,
                                        time.monotonic(), False))
            self._queued_ops += len(encs)
            self._submitted += len(encs)
            self._cv.notify_all()
        return fut

    def flush(self) -> None:
        """Ask the flusher to drain the queue now (don't wait the deadline)."""
        with self._cv:
            self._flush_asap = True
            self._cv.notify_all()

    def execute(self, reqs: Sequence[Request], tenant: Optional[str] = None,
                timeout: float = 120.0) -> List[OpResult]:
        """Synchronous convenience over the bulk path: submit the batch as
        one group, flush, wait.

        Still coalesced — groups enqueued by other callers in the same
        window ride the same fused dispatch; this caller just doesn't wait
        for the deadline."""
        fut = self.submit_batch(reqs, tenant)
        self.flush()
        return fut.result(timeout=timeout)

    # -- streaming scans ----------------------------------------------------

    def scan_page(self, start: bytes = b"", page_size: Optional[int] = None,
                  tenant: Optional[str] = None,
                  cursor: Optional[str] = None) -> ScanPage:
        """One page of a tenant-scoped range scan, with a resumption token.

        The first call names ``start``; subsequent calls pass the returned
        ``cursor`` (an opaque string carrying position + page size; ``start``
        is ignored when it is given).  ``cursor is None`` in the result means
        the tenant's key range is exhausted.  Page concatenation reproduces
        exactly the one-shot scan (tests/test_torch_service.py).

        Pages read the LIVE index (read-your-writes, DESIGN.md §11):
        unmerged delta inserts appear in order and deleted keys are
        suppressed mid-stream.  Cursors embed the next KEY, not a rank or
        an epoch, so a background ``compact()`` between pages — which
        renames every entry id — cannot skip or duplicate entries;
        resumption is exact across merge epoch bumps (tested in
        tests/test_torch_service.py).

        Cursors are tenant-bound: the token embeds the tenant it was issued
        for, and a cursor presented by a different caller (the ``tenant``
        argument, defaulting to ``default_tenant``) is REFUSED with
        ``Status.FORBIDDEN`` as data — a forged or replayed token can never
        scan another tenant's namespace (§9 errors-as-data contract).
        """
        page = page_size or self.config.scan_page_size
        if cursor is not None:
            ctenant, start, page = _decode_cursor(cursor)
            caller = tenant if tenant is not None else self.config.default_tenant
            if ctenant != caller:
                return ScanPage(entries=(), cursor=None,
                                status=Status.FORBIDDEN)
            tenant = ctenant
        fut = self.submit(ScanRequest(start, page), tenant)
        self.flush()
        res = fut.result(timeout=120.0)
        if res.status != Status.OK:
            return ScanPage(entries=(), cursor=None, status=res.status)
        entries = res.entries or ()
        nxt = None
        if len(entries) == page:
            # a full page may have more behind it: resume just past the last
            # returned key (b"\x00" appended = smallest strictly-greater key)
            tname = tenant if tenant is not None else self.config.default_tenant
            nxt = _make_cursor(tname, entries[-1][0] + b"\x00", page)
        return ScanPage(entries=entries, cursor=nxt, status=Status.OK)

    # -- maintenance --------------------------------------------------------

    def maintenance_step(self) -> bool:
        """One synchronous maintenance pass: merge if the delta is past the
        fill threshold OR has latched an overflow (the byte pool / probe
        bound can reject while the entry count is still low).  The
        background thread calls this; tests/benchmarks can call it directly
        for deterministic compaction."""
        thr = self.config.merge_threshold
        if thr is None:
            return False
        if getattr(self.index, "delta_fill", 0.0) < thr and \
                not getattr(self.index, "delta_overflowed", False):
            return False
        return self.compact()

    def compact(self, blocking: bool = False) -> bool:
        """Force one compaction now, regardless of ``merge_threshold`` —
        the escape hatch for callers whose next op NEEDS delta space (e.g.
        an eviction path that just saw ``REJECTED_FULL``).  Returns whether
        a merge actually ran (False on read-only backends / empty delta).

        On backends with the epoch seams (``begin_merge``/``run_merge``/
        ``commit_merge``) the expensive replay+refreeze runs OFF the index
        lock: requests keep flushing against the old epoch, their mutations
        are journaled, and the commit swap re-drains the journal — the only
        request-path pause is that commit (bounded by concurrent write
        traffic, not index size).  ``blocking=True`` forces the legacy
        stop-the-world path (the merge holds the index lock end to end),
        which backends without the seams take too.
        """
        begin = getattr(self.index, "begin_merge", None)
        if begin is None or blocking:
            merge = getattr(self.index, "merge", None)
            if merge is None:
                return False
            with self._merge_mutex:
                t0 = time.monotonic()
                with self._index_lock:
                    if getattr(self.index, "delta_fill", 0.0) <= 0.0:
                        return False
                    merge()
                    pause_ms = wall_ms = (time.monotonic() - t0) * 1e3
                redrained = 0
        else:
            with self._merge_mutex:
                t0 = time.monotonic()
                with self._index_lock:
                    if getattr(self.index, "delta_fill", 0.0) <= 0.0:
                        return False
                    ticket = self.index.begin_merge()
                try:
                    new_ti = self.index.run_merge(ticket)   # OFF-lock: requests flow
                except BaseException:
                    with self._index_lock:
                        self.index.abort_merge(ticket)
                    raise
                tp = time.monotonic()
                with self._index_lock:
                    redrained = self.index.commit_merge(ticket, new_ti)
                t1 = time.monotonic()
                pause_ms = (t1 - tp) * 1e3
                wall_ms = (t1 - t0) * 1e3
        with self._cv:
            self._merges += 1
            self._merge_pause_ms = pause_ms
            self._merge_pause_ms_max = max(self._merge_pause_ms_max, pause_ms)
            self._merge_wall_ms = wall_ms
            self._redrained += redrained
        return True

    # -- metrics ------------------------------------------------------------

    def stats(self) -> ServiceStats:
        with self._cv:
            lat = np.asarray(self._latencies, np.float64)
            s = ServiceStats(
                submitted=self._submitted,
                completed=self._completed,
                shed=self._shed,
                flushes=self._flushes,
                queue_depth=self._queued_ops,
                max_flush=self._max_flush,
                coalescing_factor=(self._completed / self._flushes
                                   if self._flushes else 0.0),
                merges=self._merges,
                # host mirrors only — stats polling must NEVER sync the
                # device (delta_fill_fraction would; the facade mirror is
                # maintained by every mutating op)
                delta_fill=float(getattr(self.index, "delta_fill", 0.0)),
                epoch=int(getattr(self.index, "epoch", 0)),
                merge_pause_ms=self._merge_pause_ms,
                merge_pause_ms_max=self._merge_pause_ms_max,
                merge_wall_ms=self._merge_wall_ms,
                redrained_ops=self._redrained,
                maintenance_errors=self._maintenance_errors,
                last_maintenance_error=self._last_maintenance_error,
            )
        if lat.size:
            s.p50_ms = float(np.percentile(lat, 50))
            s.p99_ms = float(np.percentile(lat, 99))
        return s

    def reset_stats(self) -> None:
        """Zero the counters and the latency ring (e.g. after a warmup)."""
        with self._cv:
            self._submitted = self._completed = self._shed = 0
            self._flushes = self._max_flush = self._merges = 0
            self._merge_pause_ms = self._merge_pause_ms_max = 0.0
            self._merge_wall_ms = 0.0
            self._redrained = 0
            self._maintenance_errors = 0
            self._last_maintenance_error = None
            self._latencies.clear()

    @property
    def merge_count(self) -> int:
        return self._merges

    # -- tenancy ------------------------------------------------------------

    @staticmethod
    def encode_key(tenant: str, key: bytes) -> bytes:
        """The stored form of a tenant's key (exposed for tests/tools that
        bulk load a backing index out-of-band)."""
        return _tenant_prefix(tenant) + key

    def _encode(self, req: Request, tenant: Optional[str]) -> Request:
        prefix = _tenant_prefix(tenant if tenant is not None
                                else self.config.default_tenant)
        if isinstance(req, GetRequest):
            return GetRequest(prefix + req.key)
        if isinstance(req, PutRequest):
            return PutRequest(prefix + req.key, req.value)
        if isinstance(req, DeleteRequest):
            return DeleteRequest(prefix + req.key)
        if isinstance(req, ScanRequest):
            return ScanRequest(prefix + req.start, req.window)
        raise TypeError(f"unknown request type: {type(req).__name__}")

    # -- internals ----------------------------------------------------------

    def _flush_loop(self) -> None:
        cfg = self.config
        max_delay = cfg.max_delay_ms / 1e3
        while True:
            with self._cv:
                # idle: block until a submit/flush/close notifies — no
                # polling, so a quiet service costs nothing
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                # coalescing window: flush on max_batch OPS, explicit
                # flush(), close(), or the oldest op's deadline
                deadline = self._queue[0].t_submit + max_delay
                # every state this loop waits on (new submissions, flush(),
                # close()) notifies _cv, so sleep the full remaining window
                while (self._queued_ops < cfg.max_batch
                       and not self._flush_asap and not self._closed):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                # pop whole groups until the op budget is met (a flush may
                # overshoot max_batch by at most one group — groups are
                # atomic so a caller's batch resolves in one piece)
                items, ops = [], 0
                while self._queue and ops < cfg.max_batch:
                    p = self._queue.popleft()
                    items.append(p)
                    ops += len(p.reqs)
                self._queued_ops -= ops
                if not self._queue:  # sticky: flush() drains the WHOLE queue
                    self._flush_asap = False
            if items:
                self._run_flush(items, ops)

    def _run_flush(self, items: List[_Pending], n_ops: int) -> None:
        try:
            flat: List[Request] = []
            for p in items:
                flat.extend(p.reqs)
            with self._index_lock:
                res = self.index.execute(flat)
            now = time.monotonic()
            done: List = []
            lo = 0
            for p in items:
                group = res.results[lo: lo + len(p.reqs)]
                lo += len(p.reqs)
                out = [self._scope_scan(enc.start, r)
                       if type(raw) is ScanRequest else r
                       for enc, raw, r in zip(p.reqs, p.raws, group)]
                done.append((p, out[0] if p.single else out))
        except BaseException as e:  # resolve, don't strand the callers
            for p in items:
                p.future._set(None, e)
            with self._done_cv:
                self._done_cv.notify_all()
            return
        with self._cv:
            self._flushes += 1
            self._completed += n_ops
            self._max_flush = max(self._max_flush, n_ops)
            for p, _ in done:
                # one sample per submission (a batch waits as one request)
                self._latencies.append((now - p.t_submit) * 1e3)
        for p, r in done:
            p.future._set(r)
        with self._done_cv:     # ONE wakeup for the whole flush
            self._done_cv.notify_all()
        # let maintenance know the delta may have grown (or overflowed —
        # byte-pool/probe rejections can need compaction at low fill)
        thr = self.config.merge_threshold
        if thr is not None and (
                getattr(self.index, "delta_fill", 0.0) >= thr
                or getattr(self.index, "delta_overflowed", False)):
            self._maint_wake.set()

    def _scope_scan(self, enc_start: bytes, r: OpResult) -> OpResult:
        """Enforce tenant isolation on a scan result: keep only entries under
        the caller's prefix, and return tenant-local keys.  Tenants occupy
        contiguous key ranges, so the first foreign key marks the end of the
        tenant's range — everything after it is foreign too."""
        if r.status != Status.OK or not r.entries:
            return r
        prefix = enc_start[: enc_start.index(TENANT_SEP) + 1]
        plen = len(prefix)
        kept = []
        for k, v in r.entries:
            if not k.startswith(prefix):
                break
            kept.append((k[plen:], v))
        return OpResult(Status.OK, entries=tuple(kept))

    def _maintenance_loop(self) -> None:
        interval = self.config.maintenance_interval_ms / 1e3
        while True:
            self._maint_wake.wait(timeout=interval)
            self._maint_wake.clear()
            if self._closed:
                return
            try:
                self.maintenance_step()
            except Exception as e:
                # maintenance must never kill the service (the next request
                # that needs space surfaces REJECTED_FULL as data) — but a
                # persistently failing compaction must never be invisible
                # either: count it, surface the last error through stats(),
                # and log each DISTINCT error once (not once per retry)
                err = f"{type(e).__name__}: {e}"
                # dedup key is truncated so messages embedding varying state
                # (fill counts etc.) still collapse; the set is bounded so a
                # pathological error stream cannot grow it forever
                key = err[:160]
                with self._cv:
                    self._maintenance_errors += 1
                    self._last_maintenance_error = err
                    first = key not in self._logged_errors \
                        and len(self._logged_errors) < 64
                    if first:
                        self._logged_errors.add(key)
                if first:
                    _LOG.exception("IndexService maintenance step failed "
                                   "(suppressing repeats of this error): %s",
                                   err)


@lru_cache(maxsize=4096)
def _tenant_prefix(tenant: str) -> bytes:
    if not _TENANT_RE.match(tenant or ""):
        raise ValueError(
            f"invalid tenant id {tenant!r} (want [A-Za-z0-9_.-]{{1,64}})")
    return tenant.encode("ascii") + TENANT_SEP


def _make_cursor(tenant: str, start: bytes, page: int) -> str:
    payload = {"t": tenant, "k": base64.b64encode(start).decode("ascii"),
               "w": page}
    return base64.urlsafe_b64encode(
        json.dumps(payload, separators=(",", ":")).encode("ascii")).decode("ascii")


def _decode_cursor(cursor: str) -> Tuple[str, bytes, int]:
    try:
        payload = json.loads(base64.urlsafe_b64decode(cursor.encode("ascii")))
        return (str(payload["t"]), base64.b64decode(payload["k"]),
                int(payload["w"]))
    except Exception as e:
        raise ValueError(f"invalid scan cursor {cursor!r}") from e
