"""Spans and counters at the index path's layer boundaries.

Two levels:

* Always on: per-call aggregates.  The outermost :class:`span` on a thread
  opens a *call record*; every span inside it adds its duration and its
  self time (the duration less what its child spans cover) to the record's
  entry for its name.  The record also holds the call's counters and its
  launches of each custom kernel (the change in
  :data:`repro_torch.kernels._build.LAUNCHES` over the call, which counts
  every thread's launches).  A closed record goes into a bounded ring, read
  with :func:`calls`.
* Only while a ``torch.profiler`` runs: each span also opens
  ``record_function(name)``, so the spans sit on the profiler's timeline
  beside the device's kernels, with their start, end and parent.

Names are ``lits.<layer>.<what>``.  A span costs two ``perf_counter``
reads and one dict update with the profiler off; none is opened inside a
per-key, per-entry, per-op or per-node loop (a loop's count is added once,
with its length).
"""
from __future__ import annotations

import collections
import itertools
import threading
from time import perf_counter
from typing import Deque, Dict, List, Optional

import torch.autograd.profiler as _profiler

from repro_torch.kernels._build import LAUNCHES

RING_SIZE = 4096
# closed call records, oldest first
RING: Deque[dict] = collections.deque(maxlen=RING_SIZE)
_ids = itertools.count()


class _ThreadState(threading.local):
    def __init__(self):
        self.stack: List["span"] = []
        self.rec: Optional[dict] = None
        self.launches: Dict[str, int] = {}


_state = _ThreadState()


class span:
    """``with span(name, **counts):`` times a layer's work.  Each count adds
    to the open call's counter ``<name>.<count>``."""

    __slots__ = ("name", "counts", "t0", "child", "rf")

    def __init__(self, name: str, **counts: int):
        self.name = name
        self.counts = counts

    def __enter__(self) -> "span":
        st = _state
        stack = st.stack
        if not stack:
            st.rec = {"id": next(_ids), "name": self.name, "t0": 0.0, "t1": 0.0,
                      "thread": threading.get_ident(), "spans": {}, "counts": {},
                      "launches": {}}
            st.launches = dict(LAUNCHES)
        if self.counts:
            counts = st.rec["counts"]
            for k, n in self.counts.items():
                key = f"{self.name}.{k}"
                counts[key] = counts.get(key, 0) + n
        self.child = 0.0
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = perf_counter()
        st = _state
        stack = st.stack
        stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        dur = t1 - self.t0
        rec = st.rec
        agg = rec["spans"].get(self.name)
        if agg is None:
            agg = rec["spans"][self.name] = [0, 0.0, 0.0]
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - self.child
        if stack:
            stack[-1].child += dur
            return
        rec["t0"], rec["t1"] = self.t0, t1
        before = st.launches
        rec["launches"] = {k: n - before.get(k, 0) for k, n in LAUNCHES.items()
                           if n != before.get(k, 0)}
        st.rec = None
        RING.append(rec)


def add(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the call open on this thread (none
    open: nothing)."""
    rec = _state.rec
    if rec is not None:
        rec["counts"][name] = rec["counts"].get(name, 0) + n


def calls(t0: Optional[float] = None, t1: Optional[float] = None) -> List[dict]:
    """The closed call records that lie inside ``[t0, t1]`` (on
    ``time.perf_counter``; either end open when None), oldest first: where
    each recent batch spent its time.

    A record is ``{"id", "name", "t0", "t1", "thread", "spans", "counts",
    "launches"}``: ``name`` is the outermost span's, ``spans`` maps each
    span name to ``[calls, total_s, self_s]`` (the self times of a call sum
    to ``t1 - t0``), ``counts`` each counter to its sum, ``launches`` each
    custom kernel launched in the call to its launches.  The ring keeps the
    last :data:`RING_SIZE` calls of every thread."""
    lo = float("-inf") if t0 is None else t0
    hi = float("inf") if t1 is None else t1
    return [r for r in list(RING) if r["t0"] >= lo and r["t1"] <= hi]
