#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent]

Drives the port's paths (``repro_torch``, never ``repro`` or JAX) at a real
size on one 1,000,000-key synthetic URL index:

* the lookup path: bulk load on the card, then batched point lookups of
  65,536 queries;
* the range path: ``scan_batch`` (window 16) and ``rank_batch`` over 16
  batches of 65,536 start keys, with an empty delta and again with the live
  delta the write path leaves;
* the write path: four ``put_batch``/``delete_batch`` rounds of 1,024 ops,
  replayed on a CPU copy of the index;
* compaction: two more put rounds of never-stored keys, the second of which
  passes 75% of the delta's entries and merges by itself (epoch 1), then a
  mixed round and an explicit ``merge()`` (epoch 2), every op and merge
  replayed on the CPU copy, whose builder is a copy of the card's made
  before the first write; after each merge every field, the height bound,
  the sorted order and the lost keys equal, then lookups of every touched
  key and a range pass against the oracle; each merge's time on the card's
  clock, with its parts;
* ``execute``: one mixed batch of 65,536 typed requests (puts of
  never-stored keys, value updates, deletes, gets, scans at windows 16 and
  64) on the card's index and on its CPU copy, every result equal;
* the request plane: ``IndexService.bulk_load`` of two tenants (the 1M url
  keys and 250,000 email keys) on the card, eight client threads over
  disjoint key partitions submitting YCSB A, inserts and YCSB E in
  ``submit_batch`` groups of 256, every result against each client's
  oracle, background merges, then every key and a ``scan_page`` pass of
  both tenants against the oracle;
* snapshots: the service's index with a live delta saved, loaded on the
  card and on the CPU, and its gets and scans compared;
* ``ops.hpt_cdf(variant="onehot")``, the one-hot GetCDF, on the index's HPT
  and again on a copy with inf, -inf and NaN entries in columns the
  queries read and in columns they do not;
* K4, K5 and K6 on rows of 262,144 bytes, too wide for a block's shared
  memory, which they stage in device memory.

Every GetCDF (K2) and locate (K1) call of a second bulk load of the same
keys (so that the recorder stays out of the timed one) is recorded and
replayed afterwards, at its own shape, in one CUDA graph per kernel: the
kernels' time at the shapes the build gives them.

It builds every CUDA kernel from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the same inputs (exact equality),
checks that each path went through its kernels (launch counts set to 0
before the path and read after it), that the card-built and CPU-built pools
are equal and that the card's writes equal the CPU's, and that every lookup
and every scan window answers a host-side oracle; then it times each kernel
(CUDA events around 50 launches captured in one CUDA graph).
It exits non-zero on any failure, and when there is no CUDA device.

``--parent`` runs it on an older package (the parent tree of a
before/after run): the phases that package cannot pass are skipped, each
with a line that says so: the compaction phase, the check that the
GetCDF/locate kernels' float ops all flush subnormals, the K7 phase with
non-finite tables, the kernel-versus-plain checks on the underflow rows,
and the execute, service, snapshot and wide-row phases.
Without it every phase runs.

Output: one line per phase, then a JSON line of per-kernel numbers, then
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_KEYS = 1_000_000          # stored keys (url)
N_EXTRA = 250_000           # never-stored keys from the same generator
BATCH = 65_536              # queries per get_batch / scan_batch
N_SCAN_BATCHES = 16         # scan_batch and rank_batch batches per range pass
WINDOW = 16                 # the reference's scan_window
WRITE_BATCH = 1_024         # ops per put_batch / delete_batch
N_SUBSET = 100_000          # keys of the cuda-vs-cpu structure check
SEED = 0
DEVICE = "cuda"
WIDE_W = 262_144            # phase wide: a row past a block's shared memory
WIDE_ROWS = 64              # phase wide: query rows
EXEC_OPS = 65_536           # phase execute: ops of the one mixed batch
EXEC_SCANS = 1_024          # ... of which scans, half at window 16, half at 64
N_EMAIL = 250_000           # phase service: stored email keys
N_CLIENTS = 8               # phase service: client threads
SVC_LOST_SAMPLE = 512       # phase service: lost keys of a tenant walked on the host
SVC_GROUP = 256             # ops per submit_batch group
SVC_A_OPS = 5_000           # per client: YCSB A (zipf) ops
SVC_INSERTS = 1_000         # per client: inserts of never-stored keys
SVC_E_OPS = 1_000           # per client: YCSB E (zipf, scan_len 16) ops
SVC_MERGE_THRESHOLD = 0.6   # the service's background merge trigger
SNAP_GETS = 65_536          # phase snapshot: gets and scans on each copy
SNAP_SCANS = 16_384
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

# kernel name -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "hpt_locate": ("src/repro_torch/kernels/csrc/hpt_locate.cu",
                   "src/repro/kernels/hpt_locate.py:24"),
    "hpt_cdf": ("src/repro_torch/kernels/csrc/hpt_cdf.cu",
                "src/repro/kernels/hpt_cdf.py:36"),
    "cnode_probe": ("src/repro_torch/kernels/csrc/cnode_probe.cu",
                    "src/repro/kernels/cnode_probe.py:22"),
    "fused_search": ("src/repro_torch/kernels/csrc/traverse.cu",
                     "src/repro/kernels/traverse.py:44"),
    "rank": ("src/repro_torch/kernels/csrc/rank.cu", "src/repro/kernels/rank.py:34"),
    "scan": ("src/repro_torch/kernels/csrc/scan.cu", "src/repro/kernels/scan.py:35"),
    "hpt_cdf_onehot": ("src/repro_torch/kernels/csrc/hpt_cdf_onehot.cu",
                       "src/repro/kernels/hpt_cdf.py:68"),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float = 0.0):
    """Least time for the work: the larger of bytes over the memory rate and
    float32 operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sass_float_ops(lib) -> dict:
    """Counts of each form of FMUL, FADD and FFMA in a built library's SASS
    (``cuobjdump -sass``): the ``.FTZ`` forms flush subnormals."""
    from repro_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return dict(collections.Counter(re.findall(r"\b(F(?:MUL|ADD|FMA)(?:\.[A-Z0-9]+)*)\b", sass)))


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the finite outputs (a NaN or inf output must
    be one in both: ``_torch_cases.nan_equal``)."""
    def err(g, w):
        fin = torch.isfinite(g.double()) & torch.isfinite(w.double())
        return float((g.double() - w.double())[fin].abs().max()) if bool(fin.any()) else 0.0
    return max(err(g, w) for g, w in zip(got, want))


def join_values(lo, hi) -> np.ndarray:
    return (np.asarray(hi, np.int64) << 32) | np.asarray(lo, np.int32).view(np.uint32)


def make_data(rng):
    """The stored keys, the never-stored keys and the stored values."""
    from repro_torch.data import synthetic

    pool = synthetic.load("url", N_KEYS + N_EXTRA, seed=SEED)
    perm = rng.permutation(len(pool))
    keys = [pool[i] for i in perm[:N_KEYS]]
    absent = [pool[i] for i in perm[N_KEYS:]]
    values = rng.integers(-(1 << 62), 1 << 62, N_KEYS, dtype=np.int64)
    return keys, absent, values


class ModelCalls:
    """The model calls of bulk loads: the host seconds spent in
    ``LITSBuilder._query_rows``/``_values``/``_positions`` (the row copies,
    K2/K1 and the copy of each result to the host) and, with ``keep``, every
    GetCDF (K2) and locate (K1) call the builder makes through
    ``core.builder.get_cdf``/``positions``, with its arguments and the
    device output it got."""

    TIMED = ("_query_rows", "_values", "_positions")
    RECORDED = {"get_cdf": "hpt_cdf", "positions": "hpt_locate"}

    def __init__(self, keep: bool = True):
        self.calls = {"hpt_cdf": [], "hpt_locate": []}
        self.seconds = 0.0
        self.depth = 0
        self.keep = keep

    @contextlib.contextmanager
    def on(self, cls):
        """Time, and record if ``keep``, the calls of every ``cls`` builder
        inside the block."""
        mod = sys.modules[cls.__module__]
        saved = [(cls, name, getattr(cls, name)) for name in self.TIMED]
        if self.keep:
            saved += [(mod, name, getattr(mod, name)) for name in self.RECORDED]

        def timed(fn):  # outermost calls only: a builder may call one inside another
            def call(*args):
                self.depth += 1
                t0 = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    self.depth -= 1
                    if self.depth == 0:
                        self.seconds += time.perf_counter() - t0
            return call

        def recorded(fn, kernel):
            def call(*args):
                out = fn(*args)
                self.calls[kernel].append((args, out))
                return out
            return call

        for owner, name, fn in saved:
            setattr(owner, name, timed(fn) if owner is cls else recorded(fn, self.RECORDED[name]))
        try:
            yield self
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)


def graph_ms(calls, reps: int = 5):
    """Capture ``calls`` into one CUDA graph; mean milliseconds of a replay
    after a warm-up one, and the captured calls' outputs (those of the last
    replay)."""
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        outs = [call() for call in calls]
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, outs


def kernel_ms(fn, reps: int) -> float:
    """Mean milliseconds of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, so that no host time falls between the launches."""
    return graph_ms([fn] * reps)[0] / reps


def replay_args(calls, dev):
    """Per recorded call, the arguments of ``hpt_cdf_cuda``/``hpt_locate_cuda``
    as the dispatchers make them from the builder's scalars."""
    from repro_torch.kernels._build import as_rows
    from repro_torch.kernels.hpt_cdf import MAX_CDF_STEPS

    i32 = lambda v, B: as_rows(v, B, torch.int32, dev)
    f32 = lambda v, B: as_rows(v, B, torch.float32, dev)
    args = {"hpt_cdf": [], "hpt_locate": []}
    for (ct, pt, qb, ql, start), _ in calls["hpt_cdf"]:
        B = qb.shape[0]
        args["hpt_cdf"].append((qb, i32(ql, B), i32(start, B), ct, pt, MAX_CDF_STEPS))
    for (ct, pt, qb, ql, start, alpha, beta, m), _ in calls["hpt_locate"]:
        B = qb.shape[0]
        args["hpt_locate"].append((qb, i32(ql, B), i32(start, B), f32(alpha, B), f32(beta, B),
                                   i32(m, B), ct, pt, MAX_CDF_STEPS))
    return args


def cdf_work(name, B, W, n_steps, table_bytes):
    """Bytes and float ops a K2 (``hpt_cdf``) or K1 (``hpt_locate``) launch
    must move and do: the rows, the per-query words and the output once,
    8 bytes of table per active step (at most both tables whole), 3 float
    ops per active step and K1's locate, 2 per row."""
    if name == "hpt_cdf":
        return B * (W + 12) + min(8 * n_steps, table_bytes), 3.0 * n_steps
    return B * (W + 24) + min(8 * n_steps, table_bytes), 3.0 * n_steps + 2.0 * B


def replay_bound_ms(name, args):
    """Sum over the launches of each one's bound (:func:`cdf_work`)."""
    table_bytes = 2 * args[0][-3].numel() * 4
    act = torch.stack([(a[1].long() - a[2].long()).clamp(0, min(a[-1], a[0].shape[1])).sum()
                       for a in args]).cpu().tolist()
    return sum(bound_ms(*cdf_work(name, *a[0].shape, n_steps, table_bytes))[0]
               for a, n_steps in zip(args, act))


def plain_over_calls(plain, arglist, chunk: int = 1 << 18) -> torch.Tensor:
    """``plain`` over the rows of every call in ``arglist`` (the ``*_cuda``
    signature) at once, in chunks of rows: the calls of one build share
    the tables and the step count (the last three arguments), and a row's
    result depends on its own arguments only.  The outputs in call order."""
    tail = arglist[0][-3:]
    if any(a[-3] is not tail[0] or a[-2] is not tail[1] or a[-1] != tail[2] for a in arglist):
        fail("the recorded calls do not share their tables and step count")
    cols = [torch.cat([a[i] for a in arglist]) for i in range(len(arglist[0]) - 3)]
    return torch.cat([plain(*(c[i: i + chunk] for c in cols), *tail)
                      for i in range(0, cols[0].shape[0], chunk)])


def replay_bulk_load(rec, kernels, plains, dev):
    """Launch every recorded K2/K1 call again through ``kernels[name]`` (the
    ``*_cuda`` signature), in one CUDA graph per kernel, timed by CUDA events
    around the whole replay.  Each replayed output must equal what the build
    got from that call, and every call's output the plain version's on the
    same arguments (:func:`plain_over_calls`).  Returns per kernel its
    numbers."""
    args = replay_args(rec.calls, dev)
    out = {}
    for name, arglist in args.items():
        n = len(arglist)
        rows = np.array([a[0].shape[0] for a in arglist], np.int64)
        ms, outs = graph_ms([lambda a=a: kernels[name](*a) for a in arglist])
        tick = torch.zeros(1, device=dev)
        floor_ms, _ = graph_ms([lambda: tick.add_(1.0)] * n)
        got = torch.cat(outs)
        used = torch.cat([o for _, o in rec.calls[name]])
        out[name] = {"launches": n, "rows": int(rows.sum()), "median_rows": float(np.median(rows)),
                     "p90_rows": float(np.percentile(rows, 90)), "max_rows": int(rows.max()),
                     "ms": ms, "ms_per_launch": ms / n, "floor_ms": floor_ms,
                     "bound_ms": replay_bound_ms(name, arglist),
                     "equal_to_build": bool(torch.equal(got, used)),
                     "equal_to_plain": bool(torch.equal(plain_over_calls(plains[name], arglist),
                                                        used))}
    return out


class PoolReads:
    """The least bytes that searches must read from one sorted order and its
    pools, tallied from the plain version's trace: each entry's order word
    once, its (off, len) record once where its key is compared, its key up to
    the byte that decides its deepest compare, and its tombstone flag once
    where a merge takes it."""

    def __init__(self, srt, off, ln, pool):
        self.srt, self.off, self.ln, self.pool = srt, off, ln, pool
        n, dev = off.shape[0], off.device
        self.word = torch.zeros(n, dtype=torch.bool, device=dev)
        self.rec = torch.zeros(n, dtype=torch.bool, device=dev)
        self.flag = torch.zeros(n, dtype=torch.bool, device=dev)
        self.key = torch.zeros(n, dtype=torch.int64, device=dev)

    def rows(self, e, width):
        """(B, width) key bytes of entries ``e``, masked past their lengths."""
        from repro_torch.kernels.strops import gather_bytes, take

        ln = take(self.ln, e)
        cols = torch.arange(width, device=e.device)[None, :]
        return torch.where(cols < ln[:, None],
                           gather_bytes(self.pool, take(self.off, e), width).int(), 0), ln

    def read(self, e, m, key_bytes=None, flag=False):
        e = e[m].long()
        self.word[e] = True
        if flag:
            self.flag[e] = True
        if key_bytes is not None:
            self.rec[e] = True
            self.key.scatter_reduce_(0, e, key_bytes[m].long(), "amax")

    def ranked(self, qb, ql, steps):
        """Tally a ``rank_sorted`` trace of queries (qb, ql)."""
        for e, m in steps:
            kv, kl = self.rows(e, qb.shape[1])
            self.read(e, m, decided_at(qb.int(), kv, ql, kl)[1])

    def total(self) -> int:
        return int(4 * self.word.sum() + 8 * self.rec.sum() + self.flag.sum() + self.key.sum())


def decided_at(va, vb, la, lb):
    """Bytes of each side that a compare of masked rows ``va``, ``vb`` must
    read: up to and including the first differing byte, at most its length."""
    neq = va != vb
    d = torch.where(neq.any(dim=1), neq.int().argmax(dim=1), va.shape[1])
    return torch.minimum(la.long(), d + 1), torch.minimum(lb.long(), d + 1)


class Oracle:
    """The expected scan order, and per entry its rank there: the live keys
    in Python ``bytes`` order, and with ``stale`` ({key: (entry id, value)})
    entries a merge leaves in the sorted order though no walk reaches them
    (the reference's lost keys): after their key's live entry, if any."""

    def __init__(self, live: dict, ti, stale=None):
        stale = stale or {}
        items = sorted([(k, 0, v) for k, v in live.items()]
                       + [(k, 1, v) for k, (_, v) in stale.items()])
        self.keys = [k for k, _, _ in items]
        self.vals = np.array([v for _, _, v in items], np.int64)
        pos = {}
        for i, k in enumerate(self.keys):
            pos.setdefault(k, i)
        second = {e: k for k, (e, _) in stale.items() if k in live}
        pool = ti.key_bytes.cpu().numpy()
        off, ln = ti.ent_off.cpu().numpy(), ti.ent_len.cpu().numpy()
        self.base_pos = np.full(off.shape[0], -1, np.int64)
        for e in ti.ent_sorted.cpu().numpy().tolist():
            k = pool[off[e]: off[e] + ln[e]].tobytes()
            self.base_pos[e] = pos.get(k, -1) + (second.get(e) == k)
        dpool = ti.db_bytes.cpu().numpy()
        doff, dln = ti.de_off.cpu().numpy(), ti.de_len.cpu().numpy()
        self.delta_pos = np.full(doff.shape[0], -1, np.int64)
        for d in range(int(ti.de_count)):
            self.delta_pos[d] = pos.get(dpool[doff[d]: doff[d] + dln[d]].tobytes(), -1)

    def bad_windows(self, starts, eids, valid, isd, lo, hi) -> int:
        """Rows whose window is not the next live keys >= the start, with
        their values."""
        lb = np.array([bisect.bisect_left(self.keys, s) for s in starts], np.int64)
        want = lb[:, None] + np.arange(eids.shape[1])[None, :]
        want_ok = want < len(self.keys)
        e = np.maximum(eids, 0)
        got = np.where(isd, self.delta_pos[np.minimum(e, self.delta_pos.shape[0] - 1)],
                       self.base_pos[np.minimum(e, self.base_pos.shape[0] - 1)])
        vals = join_values(lo, hi)
        want_v = self.vals[np.minimum(want, len(self.keys) - 1)] if self.keys else vals
        row_ok = ((valid == want_ok) & (~valid | ((got == want) & (vals == want_v)))).all(axis=1)
        return int((~row_ok).sum())


def range_pass(index, batches, oracle, label, with_rank):
    """scan_batch (and rank_batch) over every batch, then each window against
    the oracle.  Returns (launches, scans/s, ranks of the first batch)."""
    from repro_torch.core.tensor_index import lookup_values, rank_batch
    from repro_torch.kernels import _build

    _build.reset_launches()
    sync()
    t = time.time()
    outs = []
    for starts in batches:
        eids, valid, isd = index.scan_batch(starts, WINDOW)
        outs.append((eids, valid, isd, *lookup_values(index.ti, eids, isd)))
    sync()
    scan_s = time.time() - t
    ranks = []
    if with_rank:
        for starts in batches:
            ranks.append(rank_batch(index.ti, *index._queries(starts)))
        sync()
    launches = dict(_build.LAUNCHES)
    n = sum(len(s) for s in batches)
    bad = sum(oracle.bad_windows(s, *(x.cpu().numpy() for x in o))
              for s, o in zip(batches, outs))
    say(f"phase range ({label}): scan_batch of {n} starts in {len(batches)} batches, "
        f"window {WINDOW}: {scan_s:.2f} s = {n / scan_s:.0f} scans/s; windows differing "
        f"from the oracle {bad}; launches rank {launches['rank']} scan {launches['scan']}")
    if bad:
        fail(f"{bad} scan windows ({label}) differ from the oracle")
    if launches["scan"] == 0 or (with_rank and launches["rank"] == 0):
        fail(f"the range path ({label}) never launched its kernels: {launches}")
    return launches, n / scan_s, ranks[0] if ranks else None


def write_rounds(rng, keys, absent, found_keys, missed, key0, W):
    """Four rounds of WRITE_BATCH ops: puts of never-stored keys, value
    updates, deletes of stored and of delta-only keys, re-puts of deleted
    keys, over-width keys and duplicates; the first round puts entry 0's key
    ahead of other ops, the third puts it last."""
    base = [k for k in (keys[i] for i in rng.permutation(len(keys))) if k in found_keys
            and k != key0]
    p = rng.permutation(len(absent))
    new = [absent[i] for i in p[:1200]]
    never = [absent[i] for i in p[1200:1600]]
    over = [k + b"/" * (W + 1 - len(k) + j % 7) for j, k in enumerate(base[-64:])]
    miss = sorted(missed)[:64]
    n = WRITE_BATCH
    r1 = [key0] + new[:511] + base[:256] + miss + over + new[:64] + new[511:575]
    r1 += new[959: 959 + n - len(r1)]            # where fewer than 64 keys were missed
    r2 = base[256:768] + new[:256] + never[:128] + over + base[256:320]
    r3 = base[256:512] + new[:128] + new[575:959] + base[768:960] + over[:63] + [key0]
    r4 = base[256:512] + new[575:831] + base[960:1216] + never[128:384]
    rounds = [("put", r1), ("delete", r2), ("put", r3), ("delete", r4)]
    for kind, ops in rounds:
        if len(ops) != n:
            fail(f"a {kind} round has {len(ops)} ops, not {n}")
    return [(kind, ops, rng.integers(-(1 << 62), 1 << 62, n) if kind == "put" else None)
            for kind, ops in rounds]


class MergeClock:
    """Each merge's time on the card's clock (CUDA events recorded on the
    stream, read after a sync), with its parts: the replay
    (``LITSBuilder.delete_many``/``insert_many``); within it the model calls
    (``_positions``/``_values``: row copies, K1/K2 and the results to the
    host), the sorted order's searches (``_rank_in``) and the height
    bound's folds (``_update_height_bound``); the refreeze
    (``tensor_index.freeze``) and within it the upload of the pools
    (``tensor_index_from_arrays``); and the K1/K2 launches of each merge."""

    PARTS = (("merge", "StringIndex", "merge"), ("replay", "LITSBuilder", "delete_many"),
             ("replay", "LITSBuilder", "insert_many"), ("model", "LITSBuilder", "_positions"),
             ("model", "LITSBuilder", "_values"), ("rank", "LITSBuilder", "_rank_in"),
             ("heights", "LITSBuilder", "_update_height_bound"),
             ("refreeze", "tensor_index", "freeze"),
             ("upload", "tensor_index", "tensor_index_from_arrays"))

    def __init__(self):
        self.events = []      # per merge: {part: [(start, end), ...]}
        self.launches = []    # per merge: {kernel: launches}
        self.entries = []     # per merge: the delta entries it replays
        self.merged = None    # the index the latest merge replayed

    @contextlib.contextmanager
    def on(self, owners):
        """Time the calls of ``owners`` ({name: class or module}) inside the block."""
        from repro_torch.kernels import _build

        saved = [(owners[o], name, getattr(owners[o], name), part)
                 for part, o, name in self.PARTS]

        def timed(fn, part):
            def call(*args, **kw):
                if part == "merge":
                    self.events.append({})
                    self.merged = args[0].ti
                    self.entries.append(int(args[0].ti.de_count))
                    before = dict(_build.LAUNCHES)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                try:
                    return fn(*args, **kw)
                finally:
                    end.record()
                    self.events[-1].setdefault(part, []).append((start, end))
                    if part == "merge":
                        self.launches.append({k: _build.LAUNCHES[k] - before[k]
                                              for k in ("hpt_locate", "hpt_cdf")})
            return call

        for owner, name, fn, part in saved:
            setattr(owner, name, timed(fn, part))
        try:
            yield self
        finally:
            for owner, name, fn, _ in saved:
                setattr(owner, name, fn)

    def ms(self, i: int) -> dict:
        """Milliseconds of merge ``i`` by part (calls of a part summed)."""
        torch.cuda.synchronize()
        return {part: sum(a.elapsed_time(b) for a, b in pairs)
                for part, pairs in self.events[i].items()}


def cpu_builder(builder):
    """A copy of ``builder`` that computes on the CPU: the same pools, HPT,
    caches and random state, so that it merges in lockstep with the card's.
    The card's builder is only read (its device tables are left out of the
    copy through the memo), so a thread of a service may copy it."""
    out = copy.deepcopy(builder, {id(builder._tables): None})
    out.device = torch.device("cpu")
    return out


def cpu_copy(ti):
    """``ti`` with every data field on the CPU."""
    from repro_torch.core.tensor_index import DATA_FIELDS

    return dataclasses.replace(ti, **{f: getattr(ti, f).cpu() for f in DATA_FIELDS})


class FirstMerge:
    """The first merge a service runs on ``index``, kept to replay on the
    CPU: as ``run_merge`` starts (in the maintenance thread, off the index
    lock, while flushes go on) a CPU copy of the builder and of the
    ticket's index; as it ends, the card's merged index, height bound and
    sorted order.  Later merges pass through."""

    def __init__(self, index):
        self.index, self.kept = index, None
        self._run = index.run_merge
        index.run_merge = self.run  # the service calls index.run_merge

    def close(self):
        del self.index.run_merge

    def run(self, ticket):
        if self.kept is not None:
            return self._run(ticket)
        t = time.perf_counter()
        kept = {"builder": cpu_builder(self.index._builder), "ti": cpu_copy(ticket.ti),
                "fresh": ticket.builder_fresh}
        kept["copy_s"] = time.perf_counter() - t
        new_ti = self._run(ticket)
        b = self.index._builder
        kept.update(card=cpu_copy(new_ti), height_bound=copy.deepcopy(b.height_bound()),
                    sorted=b.sorted_eids().copy())
        self.kept = kept
        return new_ti

    def replay(self):
        """The merge again on the CPU copy: ``(fields, static fields and
        builder caches that differ from the card's, delta entries, seconds)``."""
        from repro_torch.core.tensor_index import DATA_FIELDS, STATIC_FIELDS, merge_delta

        k = self.kept
        t = time.perf_counter()
        got = merge_delta(k["builder"], k["ti"], sync_base_values=not k["fresh"])
        s_ = time.perf_counter() - t
        diff = [f for f in DATA_FIELDS if not torch.equal(getattr(got, f), getattr(k["card"], f))]
        diff += [f for f in STATIC_FIELDS if getattr(got, f) != getattr(k["card"], f)]
        if k["builder"].height_bound() != k["height_bound"]:
            diff.append("height_bound()")
        if not np.array_equal(k["builder"].sorted_eids(), k["sorted"]):
            diff.append("sorted_eids()")
        return diff, int(k["ti"].de_count), s_


def merge_rounds(rng, absent, used, found_keys, W):
    """The merge phase's rounds of WRITE_BATCH ops over keys no other phase
    writes: two rounds of never-stored puts, then a mixed round of puts
    (never-stored keys, keys the first two rounds put, bulk-loaded keys) and
    deletes (keys of the second round, bulk-loaded keys, delta-only keys of
    this round, never-stored keys)."""
    fresh = [k for k in (absent[i] for i in rng.permutation(len(absent))) if k not in used]
    pool = sorted(found_keys - used)
    base = [pool[i] for i in rng.choice(len(pool), WRITE_BATCH // 2, replace=False)]
    n = WRITE_BATCH
    r5, r6, new7 = fresh[:n], fresh[n: 2 * n], fresh[2 * n: 2 * n + n // 2]
    never = fresh[2 * n + n // 2: 2 * n + n // 2 + n // 4]
    puts7 = new7 + r5[: n // 4] + base[: n // 4]
    dels7 = r6[: n // 4] + base[n // 4: n // 2] + new7[: n // 4] + never
    rounds = [("put", r5), ("put", r6), ("put", puts7), ("delete", dels7)]
    for kind, ops in rounds:
        if len(ops) != n:
            fail(f"a merge-phase {kind} round has {len(ops)} ops, not {n}")
    return [(kind, ops, rng.integers(-(1 << 62), 1 << 62, n) if kind == "put" else None)
            for kind, ops in rounds]


def refusal_explained(ti, cnt0, used0, ops_, i, W) -> bool:
    """Whether op ``i`` of a batch found the delta full, read from the delta
    state ``ti`` the batch left (before any merge) and the entry count
    ``cnt0`` and bytes ``used0`` it started from.  The batch's fresh entries
    were claimed in op order, so those claimed before op ``i`` are the
    leading ones whose keys match ops before it.  Then either the entry or
    the byte pool was full, or every slot of the key's probe chain held an
    entry of another key claimed before op ``i`` (a slot, once claimed, is
    never freed within a batch)."""
    from repro_torch.core.tensor_index import pad_queries
    from repro_torch.kernels.strops import hash32

    cnt = int(ti.de_count)
    db = ti.db_bytes.cpu().numpy()
    off, ln = ti.de_off[:cnt].cpu().numpy(), ti.de_len[:cnt].cpu().numpy()
    key_of = lambda e: db[off[e]: off[e] + ln[e]].tobytes()
    claimed, t = [key_of(e) for e in range(cnt0, cnt)], 0
    for k in ops_[:i]:
        t += t < len(claimed) and k == claimed[t]
    limit, used, k = cnt0 + t, used0 + sum(map(len, claimed[:t])), ops_[i]
    if limit >= ti.de_off.shape[0] or used + len(k) > ti.db_bytes.shape[0]:
        return True
    qb, ql = pad_queries([k], W)
    h = int(hash32(torch.from_numpy(qb), torch.from_numpy(ql))[0])
    hcap = ti.dh_slot.shape[0]
    chain = ti.dh_slot.cpu().numpy()[(h + np.arange(ti.delta_probes)) & (hcap - 1)]
    return all(0 <= e < limit and key_of(e) != k for e in chain.tolist())


def same_state(a, b) -> list:
    """The fields, static fields and builder caches of two indexes that
    differ (``b`` on the CPU)."""
    from repro_torch.core.tensor_index import DATA_FIELDS, STATIC_FIELDS

    diff = [f for f in DATA_FIELDS if not torch.equal(getattr(a.ti, f).cpu(), getattr(b.ti, f))]
    diff += [f for f in STATIC_FIELDS if getattr(a.ti, f) != getattr(b.ti, f)]
    if a._builder.height_bound() != b._builder.height_bound():
        diff.append("height_bound()")
    if not np.array_equal(a._builder.sorted_eids(), b._builder.sorted_eids()):
        diff.append("sorted_eids()")
    return diff


def merge_phase(index, cpu_index, rounds, live, absent, found_keys, stored, missed, keys,
                val_of, scan_batches, smi, W):
    """The compaction phase (step 9 of ``main``): returns each merge's K1/K2
    launches."""
    from repro_torch.core.builder import LITSBuilder
    from repro_torch.core.tensor_index import freeze
    from repro_torch.index import StringIndex
    from repro_torch.kernels import _build

    clock = MergeClock()
    owners = {"StringIndex": StringIndex, "LITSBuilder": LITSBuilder,
              "tensor_index": sys.modules[freeze.__module__]}
    rng = np.random.default_rng(SEED + 2)
    touched = {k for _, ops_, _ in rounds for k in ops_}
    m_rounds = merge_rounds(rng, absent, touched, found_keys, W)
    m_ms, m_cpu_s, m_bad, refused, merged_at, fills = [], 0.0, [], [], [], []
    # entries the merges leave in the sorted order though no walk reaches
    # them: the bulk load's lost keys (entry ids in key order)
    sorted_keys = sorted(keys)
    stale = {k: (bisect.bisect_left(sorted_keys, k), val_of[k]) for k in missed}
    del sorted_keys

    def check(kind, k, got, want, explained) -> bool:
        """An op's masks against the oracle's; whether the op took effect.
        An op that needed a delta slot is refused (both masks False for a
        put, ``rejected`` for a delete) only where ``explained()`` finds
        its probe chain or the pools full, as the reference refuses it."""
        if got == want:
            return True
        if (want == (True, False) and got == ((False, False) if kind == "put" else (False, True))
                and explained()):
            refused.append(k)
            return False
        m_bad.append((kind, k, got, want))
        return True

    _build.reset_launches()
    for step, (kind, ops_, vals) in enumerate(m_rounds + [("merge", None, None)]):
        cnt0, used0 = (int(x) for x in (index.ti.de_count, index.ti.db_used))
        sync()
        t = time.perf_counter()
        with clock.on(owners):
            if kind == "merge":
                index.merge()
                out = (None, None, True)
            else:
                out = (index.put_batch(ops_, vals) if kind == "put" else index.delete_batch(ops_))
        sync()
        m_ms.append((kind, (time.perf_counter() - t) * 1e3))
        t = time.perf_counter()
        if kind == "merge":
            cpu_index.merge()
            cpu_out = (None, None, True)
        else:
            cpu_out = (cpu_index.put_batch(ops_, vals) if kind == "put"
                       else cpu_index.delete_batch(ops_))
        m_cpu_s += time.perf_counter() - t
        if out[2] != cpu_out[2] or not all(np.array_equal(a, b) for a, b in zip(out[:2],
                                                                                cpu_out[:2])):
            fail(f"merge phase: {kind} masks or merged flags differ between the card and the CPU")
        fills.append(index.delta_fill)
        # the delta state this batch left: the one its merge replayed, if any
        delta_ti = clock.merged if out[2] else index.ti
        clock.merged = None
        if out[2]:
            merged_at.append(step)
            diff = same_state(index, cpu_index)
            if diff:
                fail(f"merge {len(merged_at)}: the card and the CPU differ in {diff}")
        if kind in ("put", "delete"):
            for i, k in enumerate(ops_):
                fits = len(k) <= W
                want = ((fits and k not in live, fits and k in live) if kind == "put"
                        else (fits and k in live, False))
                ok = check(kind, k, (bool(out[0][i]), bool(out[1][i])), want,
                           lambda: refusal_explained(delta_ti, cnt0, used0, ops_, i, W))
                if ok and fits and kind == "put":
                    live[k] = int(vals[i])
                elif ok and kind == "delete":
                    live.pop(k, None)
        del delta_ti
    sync()
    merge_launches = clock.launches
    if merged_at != [1, 4] or index.epoch != 2 or m_bad:
        fail(f"merge phase: merged after steps {merged_at} (want [1, 4]: the second put round "
             f"by itself, then the explicit merge), epoch {index.epoch}, masks differing from "
             f"the oracle {len(m_bad)}: {m_bad[:4]}")
    # every stored and every touched key against the oracle; a live key that
    # misses must be one the bulk load lost (no walk of the builder reaches
    # it either), and the CPU copy must miss the same ones.  The reference's
    # rebuilds can lose keys as its bulk load does, but this seed's merges
    # lose none, so a key lost here is a fault to compare with the reference
    touched |= {k for _, ops_, _ in m_rounds for k in ops_}
    probe = keys + sorted(touched - stored)
    m_wrong, lost_now = 0, []
    for b in range(0, len(probe), BATCH):
        q = probe[b: b + BATCH]
        found, vals = index.get_batch(q)
        for k, f, v in zip(q, found.tolist(), vals.tolist()):
            if f and (k not in live or v != live[k]):
                m_wrong += 1
            elif not f and (k in live or k in missed):
                lost_now.append(k)
    reachable = sum(index._builder.host_search(k)[0] for k in lost_now)
    sample = lost_now + [keys[i] for i in rng.choice(N_KEYS, 4096, replace=False)]
    cpu_found, _ = cpu_index.get_batch(sample)
    card_found, _ = index.get_batch(sample)
    merge_lost = sorted(set(lost_now) - missed)
    say(f"stored_keys_missed={len(lost_now)} after the merges ({len(merge_lost)} not lost by "
        f"the bulk load: {merge_lost[:8]}; {reachable} of them reachable by the builder's walk)")
    if m_wrong or reachable or merge_lost or not np.array_equal(cpu_found, card_found):
        fail(f"after the merges: wrong answers {m_wrong}, missed keys the builder reaches "
             f"{reachable}, keys a merge lost {len(merge_lost)}, card and CPU answers equal "
             f"{np.array_equal(cpu_found, card_found)}")
    for i in range(len(merged_at)):
        ms = clock.ms(i)
        say(f"phase merge {i + 1} ({'put_batch, by itself' if i == 0 else 'merge()'}) of "
            f"{clock.entries[i]} delta entries: {ms['merge']:.1f} ms on the card's clock "
            f"({smi}): replay {ms.get('replay', 0):.1f} ms, of it model calls "
            f"{ms.get('model', 0):.1f} ms, sorted-order searches {ms.get('rank', 0):.1f} ms, "
            f"height-bound folds {ms.get('heights', 0):.1f} ms; refreeze "
            f"{ms.get('refreeze', 0):.1f} ms, of it upload {ms.get('upload', 0):.1f} ms; "
            f"launches {merge_launches[i]}")
        if merge_launches[i]["hpt_locate"] == 0:
            fail(f"merge {i + 1} launched no K1: it did not place keys on the card")
    say("phase merge: " + ", ".join(f"{k} {ms:.1f} ms" for k, ms in m_ms)
        + f"; delta fill after each {', '.join(f'{x:.3f}' for x in fills)}; CPU replay "
        f"{m_cpu_s:.1f} s, every field, height bound and sorted order equal after each merge; "
        f"epoch {index.epoch}; ops refused for a full probe chain or pool {len(refused)} "
        f"{refused}; "
        f"wrong answers over {len(probe)} stored and touched keys 0")
    # a range pass over the merged index: the entries of lost keys stay in
    # the sorted order, after a live entry of the same key
    range_pass(index, scan_batches, Oracle(live, index.ti, stale), "after the merges",
               with_rank=False)
    return merge_launches


def wide_phase(dev):
    """Phase wide: K4, K5 and K6 against their plain versions on a small index
    whose rows (``WIDE_W`` bytes) pass the shared memory a block can have, so
    that the kernels read them in place from the wrapper's padded matrix in
    device memory; with an empty and a live delta.  Returns each kernel's
    time on those rows, its plain version's and its bound."""
    from _torch_cases import WORD_WINDOW, wide_edge_case, word_edge_indexes, word_rows
    from repro_torch.core.builder import LITSConfig
    from repro_torch.core.tensor_index import pad_queries
    from repro_torch.index import IndexConfig, StringIndex
    from repro_torch.kernels import _build, rank, scan, traverse

    t = time.time()
    empty, live = word_edge_indexes(StringIndex, IndexConfig, LITSConfig, WIDE_W,
                                    wide_edge_case, device=DEVICE)
    sync()
    build_s = time.time() - t
    _, _, queries, _ = wide_edge_case(WIDE_W)
    qb, ql = (torch.from_numpy(a).to(dev)
              for a in pad_queries(word_rows(queries, WIDE_ROWS), WIDE_W))
    padded, (_, rows) = _build.wide_rows(qb, 1)
    if padded is None:
        fail(f"width {WIDE_W} stages in shared memory: the device-memory path is not taken")
    calls = {
        "fused_search": (lambda ti: traverse.fused_search_cuda(ti, qb, ql),
                         lambda ti: traverse.fused_search_plain(ti, qb, ql), 12),
        "rank": (lambda ti: (rank.fused_rank_cuda(ti, qb, ql),),
                 lambda ti: (rank.fused_rank_plain(ti, qb, ql),), 4),
        "scan": (lambda ti: scan.fused_scan_cuda(ti, qb, ql, window=WORD_WINDOW),
                 lambda ti: scan.fused_scan_plain(ti, qb, ql, window=WORD_WINDOW),
                 6 * WORD_WINDOW),
    }
    out = {}
    for name, (kern, plain, out_bytes) in calls.items():
        same = all(torch.equal(a, b) for ti in (empty, live)
                   for a, b in zip(kern(ti), plain(ti)))
        sync()
        if not same:
            fail(f"{name} differs from its plain version on rows of {WIDE_W} bytes")
        # the least bytes: the query rows and lengths in, the outputs out
        b_ms, b_by = bound_ms(WIDE_ROWS * (WIDE_W + 4 + out_bytes))
        out[name] = {"W": WIDE_W, "rows": WIDE_ROWS, "ms": kernel_ms(lambda: kern(live), 10),
                     "plain_ms": time_cuda(lambda: plain(live), reps=1, warmup=0),
                     "bound_ms": b_ms, "bound_by": b_by}
    say(f"phase wide: {WIDE_ROWS} rows of {WIDE_W} bytes (a staged row of "
        f"{4 * (((WIDE_W + 3) // 4) | 1)} bytes; a block's shared memory "
        f"{torch.cuda.get_device_properties(dev).shared_memory_per_block_optin}), read in "
        f"place from the padded matrix, {rows} row(s) a block; K4, K5 and K6 == plain with an "
        f"empty and a live delta: True; " + ", ".join(
            f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.5f} ms "
            f"by {v['bound_by']})" for k, v in out.items())
        + f"; index built in {build_s:.1f} s, phase {time.time() - t:.1f} s")
    return out


def execute_phase(index, cpu_index, keys, absent, rng):
    """Phase execute: one mixed ``execute`` batch of EXEC_OPS ops on the card's
    index and on its CPU copy (the same builder lineage): a quarter puts of
    keys the phase data never stored, a quarter value updates, a sixteenth
    deletes, EXEC_SCANS scans at windows 16 and 64, the rest gets.  Every
    OpResult, the batch's effects and then every field must be equal.
    Returns the phase's kernel launches."""
    from repro_torch.index import DeleteRequest, GetRequest, PutRequest, ScanRequest
    from repro_torch.kernels import _build

    q, nd = EXEC_OPS // 4, EXEC_OPS // 16
    new = [absent[i] for i in rng.choice(len(absent), q, replace=False)]
    pick = rng.choice(len(keys), q + nd, replace=False)
    upd, dels = [keys[i] for i in pick[:q]], [keys[i] for i in pick[q:]]
    vals = rng.integers(-(1 << 62), 1 << 62, 2 * q).tolist()
    n_get = EXEC_OPS - 2 * q - nd - EXEC_SCANS
    written = new + upd + dels
    gets = ([keys[i] for i in rng.integers(0, len(keys), n_get // 2)]
            + [absent[i] for i in rng.integers(0, len(absent), n_get // 4)])
    gets += [written[i] for i in rng.integers(0, len(written), n_get - len(gets))]
    starts = [keys[i][: int(n)] for i, n in zip(rng.integers(0, len(keys), EXEC_SCANS),
                                                rng.integers(1, 40, EXEC_SCANS))]
    batch = ([PutRequest(k, v) for k, v in zip(new + upd, vals)]
             + [DeleteRequest(k) for k in dels] + [GetRequest(k) for k in gets]
             + [ScanRequest(k, 16 if j % 2 else 64) for j, k in enumerate(starts)])
    batch = [batch[i] for i in rng.permutation(len(batch))]
    _build.reset_launches()
    sync()
    t = time.perf_counter()
    card = index.execute(batch)
    sync()
    card_ms = (time.perf_counter() - t) * 1e3
    launches = dict(_build.LAUNCHES)
    t = time.perf_counter()
    cpu = cpu_index.execute(batch)
    cpu_s = time.perf_counter() - t
    differ = sum(a != b for a, b in zip(card.results, cpu.results))
    effects = [(r.n_get, r.n_put, r.n_scan, r.n_delete, r.merged, r.delta_fill)
               for r in (card, cpu)]
    diff = same_state(index, cpu_index)
    hist = collections.Counter(f"{type(r).__name__[:-7].lower()} {res.status.name}"
                               for r, res in zip(batch, card.results))
    say(f"phase execute: one batch of {len(batch)} ops ({q} puts of never-stored keys, {q} "
        f"updates, {nd} deletes, {n_get} gets, {EXEC_SCANS} scans at windows 16 and 64) on "
        f"the 1M-key url index: {card_ms:.1f} ms on the card, {cpu_s:.1f} s on the CPU copy; "
        f"OpResults differing {differ}; effects (n_get, n_put, n_scan, n_delete, merged, "
        f"delta_fill) card {effects[0]} cpu {effects[1]}; fields differing after it "
        f"{diff or 'none'}; statuses {dict(sorted(hist.items()))}; launches {launches}")
    if differ or len(card.results) != len(cpu.results) or effects[0] != effects[1] or diff:
        fail("execute answers differently on the card and on the CPU")
    for name in ("fused_search", "scan"):
        if launches[name] == 0:
            fail(f"the execute path never launched {name}")
    return launches, card_ms


def _service_workload(c, parts, fresh_parts, seed):
    """Client ``c``'s groups of SVC_GROUP requests, ``[(tenant, requests)]``:
    YCSB A (zipf) ops, then inserts of never-stored keys, then YCSB E (zipf,
    scan_len 16) ops, each tenant's share of each in proportion to its keys,
    the tenants' groups taken in turn."""
    from repro_torch.data import ycsb
    from repro_torch.index import GetRequest, PutRequest, ScanRequest

    total = sum(len(p) for p in parts.values())
    rng = np.random.default_rng(seed)
    stages = []
    for stage in ("A", "insert", "E"):
        per_tenant = []
        for t, part in parts.items():
            share = len(part) / total
            fresh = fresh_parts[t]
            n_ins = int(SVC_INSERTS * share)
            if stage == "A":
                ops = ycsb.generate("A", part, [], int(SVC_A_OPS * share), dist="zipf",
                                    seed=seed * 7 + len(t))
            elif stage == "insert":
                ops = [ycsb.Op("insert", k, int(v)) for k, v in zip(
                    fresh[:n_ins], rng.integers(0, 1 << 62, n_ins))]
            else:
                ops = ycsb.generate("E", part, fresh[n_ins:], int(SVC_E_OPS * share),
                                    dist="zipf", seed=seed * 11 + len(t), scan_len=16)
            reqs = [GetRequest(o.key) if o.kind == "read" else
                    ScanRequest(o.key, o.scan_len) if o.kind == "scan" else
                    PutRequest(o.key, o.value) for o in ops]
            per_tenant.append([(t, reqs[i: i + SVC_GROUP])
                               for i in range(0, len(reqs), SVC_GROUP)])
        for i in range(max(len(g) for g in per_tenant)):
            stages += [g[i] for g in per_tenant if i < len(g)]
    return stages


class ServiceOracle:
    """One client's model of ``execute``'s planning over its own keys, group
    by group: puts in order (a put of a live key updates, of an absent one
    inserts; an insert may find the delta full), then gets.  Scans cross
    every client's keys, so a scan is held to what any client could have
    made: strictly ascending keys from the start on, inside the tenant, and
    each value one its key held (bulk loaded or put)."""

    def __init__(self, state, bulk, put_values):
        self.state, self.bulk, self.put_values = state, bulk, put_values
        self.bad, self.refused, self.scans, self.scan_entries = [], 0, 0, 0

    def check(self, tenant, reqs, results):
        from repro_torch.index import GetRequest, PutRequest, Status

        st = self.state[tenant]
        for r, res in zip(reqs, results):
            if isinstance(r, PutRequest):
                cur = st.get(r.key)
                if res.status == Status.OK and res.updated == (cur is not None):
                    st[r.key] = r.value
                elif res.status == Status.REJECTED_FULL and cur is None:
                    self.refused += 1
                else:
                    self.bad.append(("put", tenant, r.key, res, cur))
        for r, res in zip(reqs, results):
            if isinstance(r, GetRequest):
                cur = st.get(r.key)
                if (res.status, res.value) != ((Status.OK, cur) if cur is not None
                                               else (Status.NOT_FOUND, None)):
                    self.bad.append(("get", tenant, r.key, res, cur))
            elif not isinstance(r, PutRequest):
                self.scans += 1
                self.scan_entries += len(res.entries or ())
                prev = None
                for k, v in res.entries or ():
                    if ((prev is not None and k <= prev) or k < r.start or b"\x1f" in k
                            or (v != self.bulk[tenant].get(k)
                                and v not in self.put_values.get((tenant, k), ()))):
                        self.bad.append(("scan", tenant, r.start, k, v))
                        break
                    prev = k


def service_phase(keys, absent, values, smi):
    """Phase service: ``IndexService.bulk_load`` of two tenants on the card
    (url: the phase data's stored keys; email: N_EMAIL keys), N_CLIENTS client
    threads over disjoint key partitions of both, each submitting its
    workload (:func:`_service_workload`) in ``submit_batch`` groups and
    waiting on each, every result held to the client's oracle; then every
    key of both tenants through the service and a ``scan_page`` pass over
    each tenant against the oracle.  A stored key may miss only if the bulk
    load lost it: one pass right after the load finds those, none of a
    sample of them may be reachable by the builder's host walk, and every
    K2/K1 call of the load, recorded, must equal its plain version
    (:func:`replay_bulk_load`), so the card built what the CPU builds.  The
    first background merge is replayed on a CPU copy (:class:`FirstMerge`)
    and must leave the same index; a key a merge loses fails the run.
    Returns the service's index (closed service), the tenants' keys, the
    phase's kernel launches and its numbers."""
    import threading

    from repro_torch.core.builder import LITSBuilder
    from repro_torch.data import synthetic
    from repro_torch.index import GetRequest, IndexConfig, Status
    from repro_torch.kernels import _build, hpt_cdf, hpt_locate
    from repro_torch.serve import IndexService, ServiceConfig

    rng = np.random.default_rng(SEED + 3)
    t = time.time()
    emails = synthetic.load("email", 2 * N_EMAIL, seed=SEED)
    perm = rng.permutation(len(emails))
    tenants = {"url": (keys, values),
               "email": ([emails[i] for i in perm[:N_EMAIL]],
                         rng.integers(-(1 << 62), 1 << 62, N_EMAIL))}
    fresh = {"url": absent, "email": [emails[i] for i in perm[N_EMAIL:]]}
    del emails
    data_s = time.time() - t
    _build.reset_launches()
    load_calls = ModelCalls()
    sync()
    t = time.time()
    # the queue bound admits one BATCH of the final pass's gets at once
    with load_calls.on(LITSBuilder):
        svc = IndexService.bulk_load(tenants, IndexConfig(device=DEVICE), ServiceConfig(
            max_batch=SVC_GROUP, merge_threshold=SVC_MERGE_THRESHOLD, max_queue=2 * BATCH))
    first = FirstMerge(svc.index)
    try:
        sync()
        load_s = time.time() - t
        load_launches = dict(_build.LAUNCHES)
        index = svc.index
        bulk = {tn: dict(zip(k, v.tolist())) for tn, (k, v) in tenants.items()}
        lost, wrong = {}, 0
        for tn, (tkeys, _) in tenants.items():
            lost[tn] = set()
            enc = [IndexService.encode_key(tn, k) for k in tkeys]
            for b in range(0, len(enc), BATCH):
                found, got = index.get_batch(enc[b: b + BATCH])
                for k, f, v in zip(tkeys[b: b + BATCH], found.tolist(), got.tolist()):
                    if not f:
                        lost[tn].add(k)
                    elif v != bulk[tn][k]:
                        wrong += 1
        # a key the walk misses must be one the builder's host walk misses too
        t1 = time.time()
        lost_sample = [IndexService.encode_key(tn, k) for tn in tenants
                       for k in sorted(lost[tn])[:SVC_LOST_SAMPLE]]
        before = dict(_build.LAUNCHES)
        reachable = sum(index._builder.host_search(k)[0] for k in lost_sample)
        check_launches = {k: _build.LAUNCHES[k] - before[k] for k in before}  # not the path's
        say(f"phase service: data {data_s:.1f} s; bulk_load of tenants url "
            f"({len(tenants['url'][0])} keys) and email ({N_EMAIL}) on the card {load_s:.1f} s; "
            f"keys the bulk load lost: url {len(lost['url'])}, email {len(lost['email'])}, "
            f"{reachable} of {len(lost_sample)} of them reachable by the builder's host walk "
            f"({time.time() - t1:.1f} s); wrong values {wrong}; launches {load_launches}")
        if wrong or reachable:
            fail(f"the service's bulk load answers wrong values ({wrong}) or misses keys its "
                 f"builder reaches ({reachable})")
        # entry 0's key stays out of the clients' writes: a put to it is lost
        # when a later op of its batch is not a base put, as in the reference
        t0, k0 = index._builder.key_at(0).split(IndexService.encode_key("x", b"")[1:], 1)
        pinned = {tn: {k0} if tn.encode() == t0 else set() for tn in tenants}
        # client partitions of the keys the load kept, and of the fresh keys
        parts = [{tn: [k for k in tenants[tn][0] if k not in lost[tn] and k not in pinned[tn]]
                  [c::N_CLIENTS] for tn in tenants} for c in range(N_CLIENTS)]
        fresh_parts = [{tn: fresh[tn][c::N_CLIENTS] for tn in tenants}
                       for c in range(N_CLIENTS)]
        work = [_service_workload(c, parts[c], fresh_parts[c], SEED * 1000 + c)
                for c in range(N_CLIENTS)]
        put_values = {}
        oracles = [ServiceOracle({tn: {k: bulk[tn][k] for k in parts[c][tn]} for tn in tenants},
                                 bulk, put_values) for c in range(N_CLIENTS)]
        n_ops = sum(len(r) for w in work for _, r in w)
        errors = []
        barrier = threading.Barrier(N_CLIENTS + 1, timeout=600)

        def client(c):
            try:
                barrier.wait()
                for tn, reqs in work[c]:
                    for r in reqs:
                        if hasattr(r, "value"):  # known before the put can land
                            put_values.setdefault((tn, r.key), set()).add(r.value)
                    oracles[c].check(tn, reqs, svc.submit_batch(reqs, tn).result(timeout=600))
            except BaseException as e:  # reported by the main thread
                errors.append(f"client {c}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
        for th in threads:
            th.start()
        barrier.wait()
        t = time.perf_counter()
        for th in threads:
            th.join(900)
        traffic_s = time.perf_counter() - t
        if any(th.is_alive() for th in threads) or errors:
            fail(f"service clients did not finish: {errors[:4]}")
        st = svc.stats()
        bad = [b for o in oracles for b in o.bad]
        refused = sum(o.refused for o in oracles)
        say(f"phase service: {N_CLIENTS} clients, {n_ops} ops in groups of {SVC_GROUP} "
            f"(per client {SVC_A_OPS} YCSB A zipf, {SVC_INSERTS} inserts, {SVC_E_OPS} YCSB E "
            f"zipf scan_len 16) in {traffic_s:.1f} s = {n_ops / traffic_s:.0f} ops/s "
            f"({smi}); p50 {st.p50_ms:.1f} ms p99 {st.p99_ms:.1f} ms per group; "
            f"coalescing factor {st.coalescing_factor:.1f} ops a flush over {st.flushes} "
            f"flushes; background merges {st.merges}, merge_pause_ms_max "
            f"{st.merge_pause_ms_max:.1f}, merge_wall_ms {st.merge_wall_ms:.1f} (last), "
            f"redrained_ops {st.redrained_ops}, maintenance_errors {st.maintenance_errors}; "
            f"scans {sum(o.scans for o in oracles)} returning "
            f"{sum(o.scan_entries for o in oracles)} entries; inserts refused for a full "
            f"delta {refused}; results differing from the oracle {len(bad)} {bad[:3]}")
        if bad:
            fail("service results differ from the clients' oracle")
        if st.merges < 2 or st.maintenance_errors or first.kept is None:
            fail(f"service: {st.merges} background merges (want >= 2), "
                 f"{st.maintenance_errors} maintenance errors: {st.last_maintenance_error}")
        # every key of both tenants through the service, then a cursor pass
        t = time.time()
        final = {tn: {k: bulk[tn][k] for k in pinned[tn]} for tn in tenants}
        for o in oracles:
            for tn in tenants:
                final[tn].update(o.state[tn])
        n_wrong, n_keys, n_scanned = 0, 0, 0
        for tn in tenants:
            probe = list(tenants[tn][0]) + [k for k in fresh[tn] if k in final[tn]]
            n_keys += len(probe)
            for b in range(0, len(probe), BATCH):
                chunk = probe[b: b + BATCH]
                res = svc.execute([GetRequest(k) for k in chunk], tenant=tn, timeout=600)
                for k, r in zip(chunk, res):
                    want = final[tn].get(k)
                    n_wrong += (r.status, r.value) != ((Status.OK, want) if want is not None
                                                       else (Status.NOT_FOUND, None))
            want_scan = sorted([(k, v) for k, v in final[tn].items() if v is not None]
                               + [(k, bulk[tn][k]) for k in lost[tn]])
            got_scan, page = [], svc.scan_page(b"", 16_384, tenant=tn)
            while True:
                got_scan.extend(page.entries)
                if page.cursor is None:
                    break
                page = svc.scan_page(cursor=page.cursor, tenant=tn)
            n_scanned += len(got_scan)
            if got_scan != want_scan:
                i = next((j for j, (a, b) in enumerate(zip(got_scan, want_scan)) if a != b),
                         min(len(got_scan), len(want_scan)))
                fail(f"service: the {tn} cursor pass differs from the oracle at entry {i} "
                     f"(got {got_scan[i: i + 2]}, want {want_scan[i: i + 2]}; "
                     f"{len(got_scan)} against {len(want_scan)} entries)")
        launches = {k: n - check_launches[k] for k, n in _build.LAUNCHES.items()}
        say(f"phase service: after the traffic, {n_keys} keys through the service, answers "
            f"differing from the oracle {n_wrong}; scan_page pass of {n_scanned} entries "
            f"equal to the oracle (the bulk load's lost keys included); {time.time() - t:.1f} s; "
            f"launches {launches}")
        if n_wrong:
            fail(f"service: {n_wrong} keys answer differently from the oracle after the traffic")
        for name in ("hpt_cdf", "hpt_locate", "fused_search", "scan"):
            if launches[name] == 0:
                fail(f"the service path never launched {name}")
        diff, merge_entries, merge_cpu_s = first.replay()
        say(f"phase service: the first background merge ({merge_entries} delta entries; the "
            f"CPU copy taken as it started in {first.kept['copy_s']:.1f} s) replayed on the "
            f"CPU in {merge_cpu_s:.1f} s: fields, height bound and sorted order differing from "
            f"the card's {diff or 'none'}")
        if diff:
            fail(f"the service's first merge differs between the card and the CPU in {diff}")
        numbers = {"ops_per_s": n_ops / traffic_s, "p50_ms": st.p50_ms, "p99_ms": st.p99_ms,
                   "coalescing_factor": st.coalescing_factor, "merges": st.merges,
                   "merge_pause_ms_max": st.merge_pause_ms_max,
                   "merge_wall_ms": st.merge_wall_ms, "redrained_ops": st.redrained_ops}
    finally:
        svc.close()
        first.close()
    # every K2/K1 call of the bulk load against the build's outputs and the
    # plain version (after the close: no service thread runs while the
    # replay captures its CUDA graphs)
    replay = replay_bulk_load(
        load_calls, {"hpt_cdf": hpt_cdf.hpt_cdf_cuda, "hpt_locate": hpt_locate.hpt_locate_cuda},
        {"hpt_cdf": hpt_cdf.hpt_cdf_plain, "hpt_locate": hpt_locate.hpt_locate_plain},
        torch.device(DEVICE))
    del load_calls
    say("phase service: the bulk load's calls replayed: " + "; ".join(
        f"{name} {r['launches']} launches (counted {load_launches[name]}) over {r['rows']} "
        f"rows, outputs equal to the build's {r['equal_to_build']}, to the plain version on "
        f"every launch {r['equal_to_plain']}" for name, r in replay.items()))
    for name, r in replay.items():
        if not (r["equal_to_build"] and r["equal_to_plain"]) or r["launches"] != load_launches[name]:
            fail(f"the service's bulk load: its {name} calls replay differently or were "
                 "miscounted")
    return index, tenants, fresh, launches, numbers


def snapshot_phase(index, tenants, fresh, rng):
    """Phase snapshot: the service's index, with a live delta holding fresh
    keys and tombstones, saved, then loaded on the card and on the CPU;
    every field equal, and SNAP_GETS gets and SNAP_SCANS scans answer as the
    live index does on both."""
    from repro_torch.core.tensor_index import DATA_FIELDS, lookup_values
    from repro_torch.index import IndexConfig, StringIndex
    from repro_torch.serve import IndexService

    enc = {tn: [IndexService.encode_key(tn, k) for k in tenants[tn][0][:200_000]]
           for tn in tenants}
    stored = enc["url"] + enc["email"]
    extra = [IndexService.encode_key("email", k) for k in fresh["email"][-64:]]
    # a live delta with fresh keys and tombstones, which no merge folds away
    if index.delta_overflowed or index.delta_fill > 0.5:
        index.merge()
    index.config = dataclasses.replace(index.config, auto_merge_threshold=None)
    index.put_batch(extra, np.arange(64))
    index.delete_batch([stored[i] for i in rng.choice(len(stored), 64, replace=False)])
    path = os.path.join(ROOT, "build", "chip_smoke_snapshot.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        sync()
        t = time.time()
        index.save(path)
        save_s = time.time() - t
        mb = os.path.getsize(path) / 1e6
        t = time.time()
        card = StringIndex.load(path, IndexConfig(device=DEVICE))
        sync()
        card_s = time.time() - t
        t = time.time()
        cpu = StringIndex.load(path, IndexConfig(device="cpu"))
        cpu_s = time.time() - t
    finally:
        if os.path.exists(path):
            os.remove(path)
    diff = [f for f in DATA_FIELDS if not torch.equal(getattr(index.ti, f).cpu(),
                                                      getattr(card.ti, f).cpu())
            or not torch.equal(getattr(index.ti, f).cpu(), getattr(cpu.ti, f))]
    q = [stored[i] for i in rng.integers(0, len(stored), SNAP_GETS - 128)] + extra + extra
    starts = [stored[i][: int(n)] for i, n in zip(rng.integers(0, len(stored), SNAP_SCANS),
                                                  rng.integers(1, 60, SNAP_SCANS))]
    gets = [ix.get_batch(q) for ix in (index, card, cpu)]
    same_gets = all(np.array_equal(a, b) for g in gets[1:] for a, b in zip(gets[0], g))
    scans = []
    for ix in (index, card, cpu):
        eids, valid, isd = ix.scan_batch(starts, WINDOW)
        scans.append([x.cpu() for x in (eids, valid, isd, *lookup_values(ix.ti, eids, isd))])
    same_scans = all(torch.equal(a, b) for g in scans[1:] for a, b in zip(scans[0], g))
    say(f"phase snapshot: the service's index ({int(index.ti.de_count)} live delta entries, "
        f"{int(index.ti.de_tomb.sum())} tombstones, epoch {index.epoch}) saved in {save_s:.1f} s "
        f"to {mb:.1f} MB; loaded on the card in {card_s:.1f} s and on the CPU in {cpu_s:.1f} s; "
        f"fields differing {diff or 'none'}; {len(q)} gets equal on all three "
        f"{same_gets}; {len(starts)} scans (window {WINDOW}) equal {same_scans}")
    if diff or not (same_gets and same_scans):
        fail("a loaded snapshot answers differently from the live index")
    return {"mb": mb, "save_s": save_s, "load_card_s": card_s, "load_cpu_s": cpu_s}


def main(parent: bool = False) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.builder import LITSBuilder
    from repro_torch.core.hpt import uniform_hpt
    from repro_torch.core.strings import StringSet
    from repro_torch.core.tensor_index import (
        DATA_FIELDS, _delta_lookup, freeze, lookup_values, pad_queries)
    from repro_torch.core.walk import delta_rank_iters
    from repro_torch.index import IndexConfig, StringIndex
    from repro_torch.kernels import (
        _build, cnode_probe, hpt_cdf, hpt_locate, ops, rank, scan, traverse)
    from repro_torch.kernels.strops import hash16

    t_all = time.time()
    dev = torch.device(DEVICE)

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    say(smi)
    say(f"phase card: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build; the GetCDF/locate kernels' float ops must all flush subnormals
    t = time.time()
    _build.build_all()
    say(f"phase build: {len(_build.SOURCES)} libraries in {time.time() - t:.1f} s")
    if not parent:
        ops_by_lib = {name: sass_float_ops(_build._lib_path(name))
                      for name in ("hpt_cdf", "hpt_cdf_onehot", "hpt_locate", "traverse")}
        say(f"phase build: float32 FMUL/FADD/FFMA in the SASS: {ops_by_lib}")
        if any("FTZ" not in op.split(".") for ops_ in ops_by_lib.values() for op in ops_):
            fail("a GetCDF or locate kernel has a float op that keeps subnormals")
    else:
        say("phase build: flush check skipped (--parent: the package predates the .ftz ops)")

    # 3. data
    t = time.time()
    rng = np.random.default_rng(SEED)
    keys, absent, values = make_data(rng)
    say(f"phase data: url {len(keys)} stored + {len(absent)} never stored keys "
        f"in {time.time() - t:.1f} s")

    # 4. lookup path: bulk load, then get_batch; launch counts around it
    stored = set(keys)
    _build.reset_launches()
    sync()
    t = time.time()
    index = StringIndex.bulk_load(keys, values, IndexConfig(device=DEVICE))
    sync()
    build_s = time.time() - t
    ti = index.ti
    W = ti.width
    order = rng.permutation(N_KEYS)
    n_stored, n_absent = BATCH // 2, BATCH // 4
    n_prefix = BATCH - n_stored - n_absent

    def mixed_batch(b):
        """Half stored keys, a quarter never stored, a quarter prefixes and
        over-width keys."""
        q = [keys[i] for i in order[b: b + n_stored]]
        q += [absent[(b // 2 + j) % len(absent)] for j in range(n_absent)]
        src = [keys[i] for i in rng.integers(0, N_KEYS, n_prefix)]
        q += [k[: max(1, len(k) // 2)] for k in src[: n_prefix // 2]]
        q += [k + b"/" * (W + 1 - len(k) + j % 7) for j, k in enumerate(src[n_prefix // 2:])]
        return q

    batches = [mixed_batch(b) for b in range(0, N_KEYS, n_stored)]
    answers = []
    t = time.time()
    for q in batches:
        answers.append(index.get_batch(q))
    sync()
    get_s = time.time() - t
    main_launches = dict(_build.LAUNCHES)
    n_lookups = sum(len(q) for q in batches)
    pool_bytes = ti.nbytes()
    say(f"phase main: bulk_load {build_s:.2f} s, width {W}, max_iters {ti.max_iters}, "
        f"cdf_steps {ti.cdf_steps}, rank_iters {ti.rank_iters}, pools {pool_bytes} bytes; "
        f"get_batch {n_lookups} lookups in {len(batches)} batches of {BATCH}: {get_s:.2f} s "
        f"= {n_lookups / get_s:.0f} lookups/s; launches {main_launches}")
    for name in ("hpt_cdf", "hpt_locate", "fused_search"):
        if main_launches[name] == 0:
            fail(f"the main path never launched {name}")

    # 5. ground truth, on the main path's answers
    missed, wrong, false_hits = set(), 0, 0
    val_of = dict(zip(keys, values.tolist()))
    for q, (found, vals) in zip(batches, answers):
        for k, f, v in zip(q, found.tolist(), vals.tolist()):
            if k in stored:
                if not f:
                    missed.add(k)
                elif v != val_of[k]:
                    wrong += 1
            elif f:
                false_hits += 1
    # stored keys the bulk load left unreachable: the reference's build loses
    # the same ones (float32 positions that step back in a model node)
    say(f"stored_keys_missed={len(missed)} (of {N_KEYS}); scans still show them")
    say(f"phase truth: wrong values {wrong}, hits on keys never stored {false_hits}")
    if wrong or false_hits:
        fail("lookups answered wrong")
    del answers

    # 6. range path, empty delta: scan_batch + rank_batch against the oracle.
    # The lost keys stay in the frozen sorted order (the reference's too), so
    # scans show them though gets miss them, until a write reaches them.
    live = {k: v for k, v in val_of.items() if k not in missed}

    def scan_view(written=()):
        view = dict(live)
        view.update((k, val_of[k]) for k in missed if k not in written)
        return view

    scan_batches = batches[:N_SCAN_BATCHES]
    range_launches, scans_empty, ranks0 = range_pass(
        index, scan_batches, Oracle(scan_view(), ti), "empty delta", with_rank=True)
    first = scan_batches[0]
    live_sorted = sorted(scan_view())
    want_rank = np.array([bisect.bisect_left(live_sorted, s) for s in first[::32]], np.int32)
    del live_sorted
    ti0 = index.ti                       # the index before any write

    # 7. write path: four rounds, each answer against the oracle's masks;
    #    the same ops replayed on a CPU copy; gets of every touched key
    key0 = index._builder.key_at(0)
    if key0 in missed:
        fail("the key of entry 0 is not reachable")
    found_keys = stored - missed
    # the CPU copy merges with a copy of the card's builder, in lockstep
    cpu_index = StringIndex(cpu_builder(index._builder), cpu_copy(ti0), IndexConfig(device="cpu"))
    rounds = write_rounds(np.random.default_rng(SEED + 1), keys, absent, found_keys, missed,
                          key0, W)
    base0, lost, bad_masks, write_ms, replay_s = val_of[key0], 0, 0, [], 0.0
    in_delta = set()
    _build.reset_launches()
    for kind, ops_, vals in rounds:
        sync()
        t = time.perf_counter()
        out = (index.put_batch(ops_, vals) if kind == "put" else index.delete_batch(ops_))
        write_ms.append((kind, (time.perf_counter() - t) * 1e3))
        t = time.perf_counter()
        cpu_out = (cpu_index.put_batch(ops_, vals) if kind == "put"
                   else cpu_index.delete_batch(ops_))
        replay_s += time.perf_counter() - t
        for a, b in zip(out, cpu_out):
            if not np.array_equal(a, b):
                fail(f"{kind}_batch masks differ between the card and the CPU")
        diff = [f for f in DATA_FIELDS
                if not torch.equal(getattr(index.ti, f).cpu(), getattr(cpu_index.ti, f))]
        if diff:
            fail(f"{kind}_batch leaves fields differing between the card and the CPU: {diff}")
        # the oracle, op by op; the reference's base-value scatter lets the
        # last op of a batch that is not a base put overwrite entry 0's value
        if kind == "put":
            last0 = max((i for i, k in enumerate(ops_) if k == key0), default=-1)
            last_other = max((i for i, k in enumerate(ops_) if k not in found_keys), default=-1)
            for i, k in enumerate(ops_):
                fits = len(k) <= W
                want = (fits and k not in live, fits and k in live)
                bad_masks += (bool(out[0][i]), bool(out[1][i])) != want
                if fits:
                    live[k] = int(vals[i])
                    if k not in found_keys:
                        in_delta.add(k)
            if last0 >= 0:
                if last_other > last0:
                    lost += 1
                else:
                    base0 = int(vals[last0])
                if key0 not in in_delta:
                    live[key0] = base0
        else:
            for i, k in enumerate(ops_):
                fits = len(k) <= W
                bad_masks += (bool(out[0][i]), bool(out[1][i])) != (fits and k in live, False)
                if fits and k in live:
                    live.pop(k)
                    in_delta.add(k)
    sync()
    write_launches = dict(_build.LAUNCHES)
    touched = sorted({k for _, ops_, _ in rounds for k in ops_})
    found, vals = index.get_batch(touched)
    w_wrong = sum(1 for k, f, v in zip(touched, found.tolist(), vals.tolist())
                  if f != (k in live) or (f and v != live[k]))
    say("phase write: " + ", ".join(f"{k}_batch {ms:.1f} ms" for k, ms in write_ms)
        + f" per {WRITE_BATCH} ops; CPU replay {replay_s:.1f} s, every field equal; "
        f"claimed {int(index.ti.de_count)} of {index.ti.de_off.shape[0]} delta entries, "
        f"{int(index.ti.db_used)} bytes, overflowed {index.delta_overflowed}; "
        f"launches fused_search {write_launches['fused_search']}")
    say(f"base_puts_lost={lost}")
    say(f"phase write truth: {len(touched)} touched keys, wrong answers {w_wrong}, "
        f"masks differing from the oracle {bad_masks}")
    if w_wrong or bad_masks:
        fail("the write path answered wrong")
    if write_launches["fused_search"] == 0 or index.delta_overflowed:
        fail(f"write path: launches {write_launches}, overflow {index.delta_overflowed}")

    # 8. range path, live delta
    launches_live, scans_live, _ = range_pass(
        index, scan_batches, Oracle(scan_view(set(touched)), index.ti), "live delta",
        with_rank=False)
    scan_empty_launches = range_launches["scan"]
    range_launches["scan"] += launches_live["scan"]
    # K7 on the entry points' paths: no entry point selects variant="onehot"
    onehot_path_launches = sum(d["hpt_cdf_onehot"] for d in (
        main_launches, write_launches, range_launches, launches_live))
    ti_live = index.ti                   # the index with the write rounds' delta

    # 9. compaction: rounds of never-stored keys until a put_batch merges by
    #    itself, a mixed round and an explicit merge; every op and merge on
    #    the CPU copy too, the states equal after each merge
    if parent:
        say("phase merge: skipped (--parent: the package predates compaction)")
        merge_launches = []
    else:
        merge_launches = merge_phase(index, cpu_index, rounds, live, absent, found_keys,
                                     stored, missed, keys, val_of, scan_batches, smi, W)
    no_launches = {k: 0 for k in _build.LAUNCHES}
    if parent:
        say("phase execute, service, snapshot: skipped (--parent: the package predates them)")
        exec_launches = svc_launches = no_launches
    else:
        # 9b. one mixed execute batch on the card's index and its CPU copy
        exec_launches, _ = execute_phase(index, cpu_index, keys, absent,
                                         np.random.default_rng(SEED + 4))
    del cpu_index
    if not parent:
        # 9c. the request plane: two tenants, eight clients, background
        #     merges; 9d. a snapshot of its index, loaded on the card and CPU
        svc_index, tenants, fresh, svc_launches, _ = service_phase(keys, absent, values, smi)
        snapshot_phase(svc_index, tenants, fresh, np.random.default_rng(SEED + 5))
        del svc_index, tenants, fresh

    # 10. one-hot GetCDF path: ops.hpt_cdf(variant="onehot") launches K7, never K2
    qb_np, ql_np = pad_queries(batches[0], W)
    qb, ql = torch.from_numpy(qb_np).to(dev), torch.from_numpy(ql_np).to(dev)
    B = qb.shape[0]
    steps = min(64, W)  # the builder's GetCDF walk (MAX_CDF_STEPS)
    start = torch.from_numpy(rng.integers(0, 8, B).astype(np.int32)).to(dev)
    _build.reset_launches()
    onehot_out = ops.hpt_cdf(qb, ql, start, cdf_tab=ti.cdf_tab, prob_tab=ti.prob_tab,
                             variant="onehot", max_steps=steps)
    sync()
    onehot_launches = dict(_build.LAUNCHES)
    say(f"phase onehot: ops.hpt_cdf(variant='onehot') on {B} rows: launches "
        f"hpt_cdf_onehot {onehot_launches['hpt_cdf_onehot']} hpt_cdf {onehot_launches['hpt_cdf']}")
    if onehot_launches["hpt_cdf_onehot"] != 1 or onehot_launches["hpt_cdf"] != 0:
        fail("variant='onehot' did not go through K7 alone")
    # the same on tables with non-finite entries: a step's value is NaN where
    # its column holds a non-finite entry in another row (the reference's
    # true float32 contraction); entries in other columns do not reach it
    if parent:
        say("phase onehot non-finite: skipped (--parent: the package predates the rule)")
    else:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from _torch_cases import nan_equal, nonfinite_tables

        host = [t.cpu().numpy() for t in (qb, ql, start, ti.cdf_tab, ti.prob_tab)]
        bad_ct, bad_pt = (torch.from_numpy(t).to(dev)
                          for t in nonfinite_tables(*host, max_steps=steps))
        n_bad = {k: int(f(bad_ct).sum() + f(bad_pt).sum()) for k, f in (
            ("inf", torch.isposinf), ("-inf", torch.isneginf), ("NaN", torch.isnan))}
        if min(n_bad.values()) == 0:
            fail(f"non-finite tables hold {n_bad}: one kind is missing")
        got = hpt_cdf.hpt_cdf_onehot_cuda(qb, ql, start, bad_ct, bad_pt, steps)
        want = hpt_cdf.hpt_cdf_onehot_plain(qb, ql, start, bad_ct, bad_pt, steps)
        sync()
        same = nan_equal(got.cpu().numpy(), want.cpu().numpy())
        n_nan = int(got.isnan().sum())
        say(f"phase onehot non-finite: {B} rows on the {tuple(ti.cdf_tab.shape)} tables with "
            f"entries {n_bad} (at the entry read least, in another row of the column read "
            f"least, in unread columns): {n_nan} outputs NaN, {int(torch.isinf(got).sum())} "
            f"inf; kernel == plain (NaN equal): {same}")
        if not same:
            fail("K7 differs from its plain version on tables with non-finite entries")
        if not 0 < n_nan < B:
            fail(f"{n_nan} of {B} outputs NaN: the non-finite columns were not read as planned")

    # 11. each kernel against its plain version at its path's shapes
    results, inputs = {}, {}
    got = traverse.fused_search_cuda(ti, qb, ql)
    results["fused_search"] = (got, traverse.fused_search_plain(ti, qb, ql))
    inputs["fused_search"] = ((ti, qb, ql), traverse.fused_search_cuda,
                              traverse.fused_search_plain)

    args = (qb, ql, start, ti.cdf_tab, ti.prob_tab, steps)
    results["hpt_cdf"] = ((hpt_cdf.hpt_cdf_cuda(*args),), (hpt_cdf.hpt_cdf_plain(*args),))
    inputs["hpt_cdf"] = (args, hpt_cdf.hpt_cdf_cuda, hpt_cdf.hpt_cdf_plain)
    k7 = hpt_cdf.hpt_cdf_onehot_cuda(*args)
    results["hpt_cdf_onehot"] = ((k7,), (hpt_cdf.hpt_cdf_onehot_plain(*args),))
    inputs["hpt_cdf_onehot"] = (args, hpt_cdf.hpt_cdf_onehot_cuda, hpt_cdf.hpt_cdf_onehot_plain)
    results["onehot == gather (K7 vs K2)"] = ((k7, onehot_out), (results["hpt_cdf"][0][0],) * 2)
    # K2 with a one-row table, whose every read hits L1: the walk's own cost
    one = uniform_hpt(1, 128)
    one_row = (qb, ql, start, torch.from_numpy(one.cdf_tab).to(dev),
               torch.from_numpy(one.prob_tab).to(dev), steps)
    results["hpt_cdf, one-row table"] = ((hpt_cdf.hpt_cdf_cuda(*one_row),),
                                         (hpt_cdf.hpt_cdf_plain(*one_row),))

    nid = torch.from_numpy(rng.integers(0, ti.mn_slot_base.shape[0], B)).to(dev)
    args = (qb, ql, start, ti.mn_alpha[nid].contiguous(), ti.mn_beta[nid].contiguous(),
            ti.mn_slot_cnt[nid].contiguous(), ti.cdf_tab, ti.prob_tab, steps)
    results["hpt_locate"] = ((hpt_locate.hpt_locate_cuda(*args),),
                             (hpt_locate.hpt_locate_plain(*args),))
    inputs["hpt_locate"] = (args, hpt_locate.hpt_locate_cuda, hpt_locate.hpt_locate_plain)

    K = ti.cnode_cap
    cid = torch.from_numpy(rng.integers(0, ti.cn_base.shape[0], B)).to(dev)
    slots = (ti.cn_base[cid].long()[:, None] + torch.arange(K, device=dev)[None, :])
    hashes = ti.ch_hash[slots.clamp(max=ti.ch_hash.shape[0] - 1)].contiguous()
    cnt = ti.cn_cnt[cid].contiguous()
    pick = torch.from_numpy(rng.integers(0, 1 << 16, B)).to(dev) % cnt.clamp(min=1)
    qhash = torch.where(torch.from_numpy(rng.random(B) < 0.7).to(dev),
                        hashes.gather(1, pick[:, None])[:, 0], hash16(qb, ql)).contiguous()
    frm = torch.from_numpy(rng.integers(0, 3, B).astype(np.int32)).to(dev)
    args = (hashes, qhash, cnt, frm)
    results["cnode_probe"] = ((cnode_probe.cnode_probe_cuda(*args),),
                              (cnode_probe.cnode_probe_plain(*args),))
    inputs["cnode_probe"] = (args, cnode_probe.cnode_probe_cuda, cnode_probe.cnode_probe_plain)

    # K2, K1 and K7 on rows whose prob underflows, and K4 over an index of
    # keys whose GetCDF underflows (tests/_torch_cases.py), checked only
    if not parent:
        from _torch_cases import edge_cdf_rows, underflow_keys, underflow_table

        for table in ("underflow", "underflow_hpt"):
            uqb, uql, ust, uct, upt, ua, ub, um = (torch.from_numpy(a).to(dev)
                                                   for a in edge_cdf_rows(W, table))
            args = (uqb, uql, ust, uct, upt, steps)
            for name, kern, plain in (
                    ("hpt_cdf", hpt_cdf.hpt_cdf_cuda, hpt_cdf.hpt_cdf_plain),
                    ("hpt_cdf_onehot", hpt_cdf.hpt_cdf_onehot_cuda, hpt_cdf.hpt_cdf_onehot_plain)):
                results[f"{name}, {table} rows"] = ((kern(*args),), (plain(*args),))
            args = (uqb, uql, ust, ua, ub, um, uct, upt, steps)
            results[f"hpt_locate, {table} rows"] = ((hpt_locate.hpt_locate_cuda(*args),),
                                                    (hpt_locate.hpt_locate_plain(*args),))
        from repro_torch.core.hpt import HPT

        ukeys = underflow_keys(SEED, 20_000)
        ubuild = LITSBuilder(hpt=HPT(*underflow_table()), device=DEVICE)
        ubuild.bulkload(StringSet.from_list(ukeys))
        uti = freeze(ubuild)
        uq = ukeys + [k + b"a" for k in ukeys[::3]] + [k[:-1] for k in ukeys[::5]]
        uqb, uql = (torch.from_numpy(a).to(dev) for a in pad_queries(uq, uti.width))
        results["fused_search, keys whose GetCDF underflows"] = (
            traverse.fused_search_cuda(uti, uqb, uql), traverse.fused_search_plain(uti, uqb, uql))
    else:
        say("phase kernels: underflow rows skipped (--parent: the package predates the flush)")

    # K4, K5 and K6 on rows too wide for a block's shared memory
    wide = {} if parent else wide_phase(dev)
    if parent:
        say("phase wide: skipped (--parent: the package refuses rows too wide to stage)")

    sqb, sql = index._queries(first)
    k5 = rank.fused_rank_cuda(ti0, sqb, sql)
    rank_trace, scan_trace, scan_empty_trace = [], {}, {}
    results["rank"] = ((k5,), (rank.fused_rank_plain(ti0, sqb, sql, trace=rank_trace),))
    results["rank (range path) == bisect"] = (
        (ranks0[::32].cpu(), k5[::32].cpu()), (torch.from_numpy(want_rank),) * 2)
    inputs["rank"] = ((ti0, sqb, sql), rank.fused_rank_cuda, rank.fused_rank_plain)
    for label, t_i, tr in (("scan, empty delta", ti0, scan_empty_trace),
                           ("scan", ti_live, scan_trace)):
        results[label] = (scan.fused_scan_cuda(t_i, sqb, sql, window=WINDOW),
                          scan.fused_scan_plain(t_i, sqb, sql, window=WINDOW, trace=tr))
    inputs["scan"] = ((ti_live, sqb, sql), lambda *a: scan.fused_scan_cuda(*a, window=WINDOW),
                      lambda *a: scan.fused_scan_plain(*a, window=WINDOW))
    sync()
    for name, (g, w) in results.items():
        same = all(torch.equal(a, b) for a, b in zip(g, w))
        say(f"phase kernels: {name} kernel == plain on {g[0].shape[0]} rows: {same}")
        if not same:
            fail(f"{name} differs from its plain version")

    # 12. the bulk load's K2/K1 calls, recorded in a second build of the same
    #     keys and replayed at their own shapes, one CUDA graph per kernel;
    #     each output against the build's and the plain version
    model_calls = ModelCalls()
    sync()
    t = time.time()
    with model_calls.on(LITSBuilder):
        StringIndex.bulk_load(keys, values, IndexConfig(device=DEVICE))
    sync()
    say(f"phase replay: recording bulk_load {time.time() - t:.2f} s, {model_calls.seconds:.2f} s "
        "of it in _query_rows/_values/_positions (row copies, K2/K1, results to the host)")
    replay = replay_bulk_load(
        model_calls,
        {"hpt_cdf": hpt_cdf.hpt_cdf_cuda, "hpt_locate": hpt_locate.hpt_locate_cuda},
        {"hpt_cdf": hpt_cdf.hpt_cdf_plain, "hpt_locate": hpt_locate.hpt_locate_plain}, dev)
    del model_calls
    for name, r in replay.items():
        say(f"phase replay: {name}: {r['launches']} launches (main path {main_launches[name]}) "
            f"over {r['rows']} rows, median {r['median_rows']:.0f}, 90th percentile "
            f"{r['p90_rows']:.0f}, largest {r['max_rows']}; {r['ms']:.4f} ms in all = "
            f"{r['ms_per_launch'] * 1e3:.3f} us a launch (graph of as many 1-element adds: "
            f"{r['floor_ms']:.4f} ms); bound {r['bound_ms']:.5f} ms; outputs equal to the "
            f"build's {r['equal_to_build']}, to the plain version on every launch "
            f"{r['equal_to_plain']}")
        if not (r["equal_to_build"] and r["equal_to_plain"]):
            fail(f"the bulk load's {name} calls replay differently")
        if r["launches"] != main_launches[name]:
            fail(f"{r['launches']} {name} calls recorded, {main_launches[name]} launched "
                 "on the main path")

    # 13. structure: the card's build (K1/K2) equals the CPU's (plain), array for array
    sub = [keys[i] for i in np.sort(rng.choice(N_KEYS, N_SUBSET, replace=False))]
    ss = StringSet.from_list(sub)
    t = time.time()
    bg = LITSBuilder(device=DEVICE)
    with ModelCalls(keep=False).on(LITSBuilder) as sub_calls:
        bg.bulkload(ss, values[:N_SUBSET])
    tg_s = time.time() - t
    t = time.time()
    bc = LITSBuilder(device="cpu")
    bc.bulkload(ss, values[:N_SUBSET])
    tc_s = time.time() - t
    fg, fc = freeze(bg), freeze(bc)
    diff = [f for f in DATA_FIELDS if not torch.equal(getattr(fg, f).cpu(), getattr(fc, f))]
    say(f"phase structure: {N_SUBSET} keys built on cuda ({tg_s:.1f} s, of which "
        f"{sub_calls.seconds:.2f} s in _query_rows/_values/_positions) and cpu "
        f"({tc_s:.1f} s): pools differ in {diff or 'no field'}")
    if diff or bg.root_item != bc.root_item:
        fail(f"cuda and cpu builds differ: {diff}")

    # 14. times at each path's shapes; bytes and operations this run's data needs
    levels = results["fused_search"][0][2]
    hit = results["fused_search"][0][0]
    nbytes = {
        # query rows + lengths, 3 outputs, one item word per level walked
        # (at most the item pool once), key bytes + entry record of each hit
        "fused_search": B * (W + 4) + 12 * B
        + 4 * min(int(levels.sum()), ti.items.shape[0])
        + int((ql[hit].long() + 8).sum()),
    }
    active = (torch.minimum(ql.long(), start.long() + steps) - start.long()).clamp(0, steps)
    n_steps = int(active.sum())
    table_bytes = 2 * ti.cdf_tab.numel() * 4
    nbytes["hpt_cdf"], cdf_flops = cdf_work("hpt_cdf", B, W, n_steps, table_bytes)
    nbytes["hpt_cdf_onehot"] = nbytes["hpt_cdf"] + 2 * 4 * ti.cdf_tab.shape[1]  # + the counts
    nbytes["hpt_locate"], locate_flops = cdf_work("hpt_locate", B, W, n_steps, table_bytes)
    nbytes["cnode_probe"] = B * (K * 4 + 16)
    # rank: query rows in, ranks out, and what the searches must read of the
    # order and its pools (PoolReads, from the plain version's trace)
    lt = ti_live
    base = PoolReads(ti0.ent_sorted, ti0.ent_off, ti0.ent_len, ti0.key_bytes)
    base.ranked(sqb, sql, rank_trace)
    nbytes["rank"] = B * (W + 8) + base.total()
    # scan (live delta): query rows in, windows out, and what both ranks and
    # the merge must read: a compare reads both heads up to the deciding byte,
    # a lone stream's head only its order word (and a delta's tombstone flag)
    base = PoolReads(lt.ent_sorted, lt.ent_off, lt.ent_len, lt.key_bytes)
    delta = PoolReads(lt.ds_order, lt.de_off, lt.de_len, lt.db_bytes)
    base.ranked(sqb, sql, scan_trace["base"])
    delta.ranked(sqb, sql, scan_trace["delta"])
    for be, de, b_read, d_read, took in scan_trace["merge"]:
        both = b_read & d_read
        (dv, dl), (bv, bl) = delta.rows(de, W), base.rows(be, W)
        d_need, b_need = decided_at(dv, bv, dl, bl)
        base.read(be, both, b_need)
        base.read(be, b_read & ~d_read)
        delta.read(de, both, d_need, flag=False)
        delta.read(de, took, flag=True)
    nbytes["scan"] = B * (W + 4) + B * WINDOW * 6 + base.total() + delta.total()
    # scan, empty delta: query rows in, windows out, what the frozen rank
    # must read, and the order word of each entry the window gathers
    base = PoolReads(ti0.ent_sorted, ti0.ent_off, ti0.ent_len, ti0.key_bytes)
    base.ranked(sqb, sql, scan_empty_trace["base"])
    empty_eids, empty_valid, _ = results["scan, empty delta"][0]
    base.read(empty_eids.flatten(), empty_valid.flatten())
    scan_empty_bytes = B * (W + 4) + B * WINDOW * 6 + base.total()
    # K7 computes K2's function (on finite tables): its bound is K2's work and
    # the two per-column count tables; a one-hot product over the table's
    # rows is how the TPU kernel worked, not what the function needs
    flops = {"fused_search": 0.0, "hpt_cdf": cdf_flops, "hpt_locate": locate_flops,
             "cnode_probe": 0.0, "hpt_cdf_onehot": cdf_flops, "rank": 0.0, "scan": 0.0}
    # `launches` is the main path's count (the range pass's for K5 and K6);
    # every path's own count is in `launches_by_path`
    launches = dict(main_launches)
    launches.update(rank=range_launches["rank"], scan=range_launches["scan"],
                    hpt_cdf_onehot=onehot_path_launches)
    by_path = {k: {"main": main_launches[k], "write": write_launches[k],
                   "range": range_launches[k] if k in ("rank", "scan") else 0,
                   "merge": sum(m.get(k, 0) for m in merge_launches),
                   "execute": exec_launches[k], "service": svc_launches[k]} for k in launches}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        args, kern, plain = inputs[name]
        ms = kernel_ms(lambda: kern(*args), 50)
        plain_ms = time_cuda(lambda: plain(*args), reps=3, warmup=1)
        b_ms, b_by = bound_ms(nbytes[name], flops[name])
        g, w = results[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": max_abs_err(g, w),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None, "launches_by_path": by_path[name]})
        if name in wide:
            rows[-1]["wide_rows"] = wide[name]
        if name in replay:  # K2/K1 at the bulk load's own launch shapes
            rows[-1]["bulk_load_replay"] = {k: replay[name][k] for k in (
                "launches", "rows", "median_rows", "ms", "ms_per_launch", "floor_ms",
                "bound_ms")}
            rows[-1]["merge_launches"] = [m[name] for m in merge_launches]
        say(f"phase times: {name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound {b_ms:.5f} ms "
            f"by {b_by}, {nbytes[name]} bytes, {flops[name]:.0f} float ops), "
            f"main path launches {launches[name]}, by path {by_path[name]}")
    if main_launches["cnode_probe"] == 0:
        say("phase times: cnode_probe runs inline in every fused_search launch "
            f"({main_launches['fused_search']} on the main path); its own entry is "
            "launched only here, against its plain version")
    one_row_ms = kernel_ms(lambda: hpt_cdf.hpt_cdf_cuda(*one_row), 50)
    next(r for r in rows if r["name"] == "hpt_cdf")["one_row_table_ms"] = one_row_ms
    say(f"phase times: hpt_cdf with a one-row table (every table read from L1) {one_row_ms:.4f} ms")
    onehot_row = next(r for r in rows if r["name"] == "hpt_cdf_onehot")
    onehot_row["script_launches"] = onehot_launches["hpt_cdf_onehot"]
    say(f"phase times: hpt_cdf_onehot: {onehot_path_launches} launches from the entry points "
        f"(none selects variant='onehot'); the onehot phase's "
        f"{onehot_launches['hpt_cdf_onehot']} is this script's own call of ops.hpt_cdf")
    scan_empty_ms = kernel_ms(lambda: scan.fused_scan_cuda(ti0, sqb, sql, window=WINDOW), 50)
    scan_empty_plain_ms = time_cuda(
        lambda: scan.fused_scan_plain(ti0, sqb, sql, window=WINDOW), reps=3, warmup=1)
    se_ms, se_by = bound_ms(scan_empty_bytes)
    next(r for r in rows if r["name"] == "scan")["scan_empty"] = {
        "launches": scan_empty_launches, "ms": scan_empty_ms, "plain_ms": scan_empty_plain_ms,
        "bound_ms": se_ms, "bound_by": se_by,
        "max_abs_err": max_abs_err(*results["scan, empty delta"])}
    say(f"phase times: scan with an empty delta {scan_empty_ms:.4f} ms (plain "
        f"{scan_empty_plain_ms:.2f} ms, bound {se_ms:.5f} ms by {se_by}, {scan_empty_bytes} "
        f"bytes), path launches {scan_empty_launches}; the scan row above is the live delta's; "
        f"scan_batch {scans_empty:.0f} scans/s (empty delta), {scans_live:.0f} scans/s "
        "(live delta)")

    # 15. where one get_batch's time goes: each stage alone, a sync after it
    q = batches[1]
    split = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[name] = split.get(name, 0.0) + (time.perf_counter() - t0) * 1e3 / 3
        return out

    for _ in range(3):
        qn, ln = stage("pad_queries", lambda: pad_queries(q, W))
        qd, ld = stage("to_device", lambda: (torch.from_numpy(qn).to(dev),
                                             torch.from_numpy(ln).to(dev)))
        dfound, did = stage("delta_probe", lambda: _delta_lookup(ti, qd, ld))
        f, e, _ = stage("fused_search", lambda: traverse.fused_search_cuda(ti, qd, ld))
        lo, hi = stage("lookup_values", lambda: lookup_values(ti, e, dfound))
        stage("to_host", lambda: (f.cpu().numpy(), lo.cpu().numpy(), hi.cpu().numpy()))
    say("phase split: get_batch of %d queries, ms per stage: %s" % (
        len(q), ", ".join(f"{k} {v:.3f}" for k, v in split.items())))
    say(f"phase done in {time.time() - t_all:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="store_true",
                    help="skip the phases an older package cannot pass: compaction, the "
                         "flush check of the float ops, K7's non-finite tables, the "
                         "underflow rows, execute, the service, snapshots and wide rows")
    sys.exit(main(ap.parse_args().parent))
