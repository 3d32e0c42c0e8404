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
* ``execute``: one mixed batch of 16,384 typed requests (puts of
  never-stored keys, value updates, deletes, gets, scans at windows 16 and
  64) on the card's index and on its CPU copy, every result equal;
* the request plane: ``IndexService.bulk_load`` of two tenants (250,000 of
  the url keys and 100,000 email keys) on the card, eight client threads over
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
  memory, which they stage in device memory;
* the distributed index: ``build_sharded`` of the 1M url keys into 4
  CDF-range shards on the card, 16 lookup batches of the main mix through
  the in-process routed ``get_batch``, a batch at a capacity that must
  overflow, ``scan_entries`` with starts just below every shard's end, an
  ``IndexService`` over a sharded index of tenant-encoded keys with 8
  clients, and the process-group form with one NCCL rank; every answer
  against the host's reckoning, which counts the reference's lost keys,
  routing misses (no ε recheck at the boundaries) and padded-order scan
  windows;
* the LM serving path at the full width of deepseek-7b (30 layers, d_model
  4096, float32 weights from a generator seeded 0): ``ServeEngine`` serves 8
  request batches of 4 prompts of 48 tokens, 32 generated tokens each, with
  its prefix cache's index on the card (K4 walks every lookup, admission
  and LRU eviction); the cache's counts against a host replay, cached
  batches' tokens against their first serve, prefill and decode against
  ``forward``, layer 0 and the head against the port on the CPU, every
  reduced arch on the card against the CPU port, the index's slots
  against the cache's host dict, and every K4 call of the traffic against
  the plain walk;
* LM training at the full width of deepseek-7b, cut to 15 layers so that
  float32 weights, gradients and AdamW moments fit one card: 6
  steps of 2 rows of 4,096 tokens (2 microbatches) through
  ``train_loop.train``; remat off/none/dots bit-identical, a 1-layer cut's
  gradients against the CPU port, every reduced arch's train step on the
  card against the CPU, crash and resume bit for bit, a checkpoint from
  the card restored on the CPU, and ``launch/train.py``.  No TPU kernel
  lies on this path: it launches none of K1-K7;
* the device mesh at the full width of llama4-scout-17b-a16e (16 experts,
  top-1), cut to 1 of 48 layers, on a one-rank NCCL ``("data", "model")``
  mesh, where every collective is the identity, so every mesh result must
  equal its no-mesh result bit for bit: 2 steps of 2 rows of 2,048 tokens
  through ``train_loop.train`` under the mesh (DTensor parameters, moments
  and gradients; the expert-parallel MoE) and without; one MoE block in
  ``ag`` and ``ws``, and a prefill with decode steps; the int8-compressed
  data-parallel step at deepseek-7b's full width (4 layers) against the
  plain update on the round-tripped gradient; ``launch/train.py
  --use-mesh``; dense tensor parallelism's compute pieces and its sums over
  the one-rank ``model`` group (NCCL all-reduces) under those checks.  No
  TPU kernel lies on this path either;
* bf16 parameters: deepseek-7b at full width cast from phase lm's float32
  model (then freed) serves two request batches, its greedy tokens and
  first decode step held to the float32 model's;
* the dry-run and roofline tools on the card's host CPU over torch's fake
  process group: deepseek-7b's train, prefill and decode cells on the
  (16, 16) mesh, the LITS query-service cell, and phase train's own
  configuration on a (1, 1) mesh, its predicted memory beside the measured
  peak and its analytic compute term beside the measured step time.

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
(CUDA events around 50 launches captured in one CUDA graph).  Phase probe
counts the main batch's queries that end at a compact leaf, the live slots
their probes scan and the false 16-bit matches they meet (K4's bound counts
those reads), holds K3 to its plain version on tiles past one pass of 16
slots and on one 4 bytes past a 16-byte boundary, and K4 on an index whose
compact leaves hold equal codes; phase times reads K3's and K4's
registers and the blocks an SM holds from the card's runtime.
It exits non-zero on any failure, and when there is no CUDA device.

``--parent`` runs it on an older package (the parent tree of a
before/after run): the phases that package cannot pass are skipped, each
with a line that says so: the compaction phase, the check that the
GetCDF/locate kernels' float ops all flush subnormals, the K7 phase with
non-finite tables, the kernel-versus-plain checks on the underflow rows,
and the probe, execute, service, snapshot, wide-row, distributed, lm,
train, mesh and dryrun phases.  Without it every phase runs.

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
N_COLLIDE = 4_000           # stored keys of the index whose compact leaves hold equal codes
SEED = 0
DEVICE = "cuda"
WIDE_W = 262_144            # phase wide: a row past a block's shared memory
# the execute, service and wide phases run at these depths so that the whole
# script, the distributed phase included, stays well inside its time limit
WIDE_ROWS = 64              # phase wide: query rows
EXEC_OPS = 16_384           # phase execute: ops of the one mixed batch
EXEC_SCANS = 256            # ... of which scans, half at window 16, half at 64
SVC_URL_KEYS = 250_000      # phase service: stored url keys (the first of the phase data's)
N_EMAIL = 100_000           # phase service: stored email keys
N_CLIENTS = 8               # phase service: client threads
SVC_LOST_SAMPLE = 512       # phase service: lost keys of a tenant walked on the host
SVC_GROUP = 256             # ops per submit_batch group
SVC_A_OPS = 2_500           # per client: YCSB A (zipf) ops
SVC_INSERTS = 1_000         # per client: inserts of never-stored keys
SVC_E_OPS = 500             # per client: YCSB E (zipf, scan_len 16) ops
SVC_MERGE_THRESHOLD = 0.6   # the service's background merge trigger
SNAP_GETS = 65_536          # phase snapshot: gets and scans on each copy
SNAP_SCANS = 16_384
DIST_SHARDS = 4             # phase distributed: shards of the url keys
DIST_BATCHES = 16           # ... get_batch batches of BATCH queries (the main mix)
DIST_CAPACITY = 8_192       # ... per_dest_capacity: twice the mean rows a (sender, owner)
DIST_TIGHT = 2_048          # ... the capacity of the batch that must overflow
DIST_SCANS = 16_384         # ... starts a scan_entries batch, two batches
DIST_SVC_KEYS = 100_000     # ... url keys, tenant-encoded, of the service's sharded index
DIST_CLIENTS = 8            # ... service client threads
DIST_SVC_GETS = 2_048       # ... YCSB C (zipf) gets a client, in groups of SVC_GROUP
DIST_NCCL_KEYS = 100_000    # ... keys of the one-rank NCCL check
LM_ARCH = "deepseek-7b"     # phase lm: the arch served at its published width
LM_REDUCED = False          # ... True only to rehearse the phase on the CPU
LM_REQUESTS = 8             # ... request batches
LM_BATCH = 4                # ... prompts a batch
LM_PROMPT = 48              # ... tokens a prompt (a key of 197 bytes: cached)
LM_GEN = 32                 # ... generated tokens a prompt
LM_REPEAT = 0.5             # ... share of repeated batches (launch/serve.py's draw)
LM_CAPACITY = 12            # ... prefix-cache slots (16 prompts drawn: the LRU evicts
                            #     through DELETE)
LM_MAX_LEN = 512            # ... the engine's KV window bound
LM_BF16_BATCHES = 2         # ... (f) request batches served with bf16 parameters
TRAIN_ARCH = "deepseek-7b"  # phase train: the arch trained at its published width
TRAIN_LAYERS = 15           # ... its depth, cut so that training fits one card (PERF.md §4)
TRAIN_REDUCED = False       # ... True only to rehearse the phase on the CPU
TRAIN_SEQ = 4096            # ... tokens a row: train_4k's sequence length
TRAIN_BATCH = 2             # ... rows a step
TRAIN_ACCUM = 2             # ... microbatches a step (1 row each)
TRAIN_STEPS = 6             # ... steps through train_loop.train
TRAIN_CPU_TOKENS = 64       # ... check (c): one row of this many tokens, 1 layer
TRAIN_PEAK_GB = 72.0        # ... the run's peak device memory must stay under this
TRAIN_REMAT_LAYERS = 2      # ... check (b)'s depth
MESH_ARCH = "llama4-scout-17b-a16e"  # phase mesh: the MoE arch trained at its published width
MESH_LAYERS = 1             # ... its depth: 4.166 B parameters, 12 B each with bf16 moments
MESH_REDUCED = False        # ... True only to rehearse the phase on the CPU
MESH_SEQ = 2048             # ... tokens a row
MESH_BATCH = 2              # ... rows a step
MESH_ACCUM = 2              # ... microbatches a step (1 row each)
MESH_STEPS = 2              # ... steps through train_loop.train, under the mesh and without
MESH_PEAK_GB = 72.0         # ... either run's peak device memory must stay under this
MESH_SERVE = (4, 48, 4)     # ... (b) prefill rows, prompt tokens, decode steps
MESH_DP_ARCH = "deepseek-7b"  # ... (c) the compressed data-parallel step's arch, full width
MESH_DP_LAYERS = 4          # ... its depth: 1.649 B parameters, 16 B each with the error state
DRYRUN_ARCH = "deepseek-7b"  # phase dryrun: the arch dry-run on the (16, 16) mesh
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")  # ... its cells
DRYRUN_TIMEOUT = 400        # ... seconds for all its subprocesses
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


# K4's and K3's launch resources, read on the card: each kernel's source
# compiled once more, with the flags its library has, beside one C entry
# point that asks the CUDA runtime for the kernel's registers and static
# shared memory and for the blocks an SM holds at the block size and stage
# that the source's own launcher gives it (K4 at width W).
OCCUPANCY = {
    "fused_search": ("traverse", "fused_search_kernel<false>",
                     "const lits::StageLaunch l = lits::stage_launch(k, 1, W, 1, 0);\n"
                     "  if (l.err != cudaSuccess) return static_cast<int>(l.err);\n"
                     "  *threads = l.rows;\n"
                     "  *stage = static_cast<int>(l.bytes);"),
    "cnode_probe": ("cnode_probe", "cnode_probe_kernel",
                    "*threads = lits::kBlock;\n"
                    "  *stage = 0;"),
}
OCCUPANCY_TU = """#include "{source}.cu"

extern "C" int lits_occupancy(int W, int* regs, int* shared, int* threads, int* stage,
                              int* blocks) {{
  auto* k = {kernel};
  {launch}
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *shared = static_cast<int>(a.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, *threads, *stage));
}}
"""


def start_occupancy_builds() -> dict:
    """One nvcc per entry of :data:`OCCUPANCY`, all started at once:
    ``{name: (library, process)}``, the libraries under the build directory."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (source, kernel, launch) in OCCUPANCY.items():
        tu = _build.BUILD_DIR / f"occupancy_{source}.cu"
        tu.write_text(OCCUPANCY_TU.format(source=source, kernel=kernel, launch=launch))
        lib = tu.with_suffix(".so")
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
             str(tu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return jobs


def occupancy(jobs: dict, W: int) -> dict:
    """Per kernel of ``jobs``: registers a thread, static shared bytes,
    threads a block, stage bytes and the blocks an SM holds, from the card."""
    import ctypes

    out = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            fail(f"nvcc failed for {lib.stem}:\n{log}")
        vals = [ctypes.c_int() for _ in range(5)]
        err = ctypes.CDLL(str(lib)).lits_occupancy(ctypes.c_int(W), *map(ctypes.byref, vals))
        if err:
            fail(f"{lib.stem}: CUDA error {err}")
        out[name] = dict(zip(("regs", "shared", "threads", "stage_bytes", "blocks_per_sm"),
                             (v.value for v in vals)))
    return out


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


def probe_tile_ms(dev) -> float:
    """K3 on a random (BATCH, 16) tile (``tests/_torch_cases.py``'s
    probe_tile, seeded 0): its time on inputs that do not depend on an
    index, by :func:`kernel_ms`."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_cases import probe_tile
    from repro_torch.kernels import cnode_probe

    tile = [torch.from_numpy(a).to(dev) for a in probe_tile(np.random.default_rng(0), BATCH, 16)]
    return kernel_ms(lambda: cnode_probe.cnode_probe_cuda(*tile), 50)


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
    signature), each run of calls that share the tables and the step count
    (the last three arguments: the calls of one builder) at once, in chunks
    of rows: a row's result depends on its own arguments only.  The outputs
    in call order."""
    out, i = [], 0
    while i < len(arglist):
        tail = arglist[i][-3:]
        j = i + 1
        while j < len(arglist) and arglist[j][-3] is tail[0] and arglist[j][-2] is tail[1] \
                and arglist[j][-1] == tail[2]:
            j += 1
        cols = [torch.cat([a[k] for a in arglist[i:j]]) for k in range(len(arglist[i]) - 3)]
        out += [plain(*(c[r: r + chunk] for c in cols), *tail)
                for r in range(0, cols[0].shape[0], chunk)]
        i = j
    return torch.cat(out)


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
        # the plain version's time is that of its call on the live delta
        # below (one call, no warm-up): K4's takes ≈25 s on these rows
        plains = {}
        for ti in (empty, live):
            sync()
            t0 = time.perf_counter()
            plains[id(ti)] = plain(ti)
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
        same = all(torch.equal(a, b) for ti in (empty, live)
                   for a, b in zip(kern(ti), plains[id(ti)]))
        sync()
        if not same:
            fail(f"{name} differs from its plain version on rows of {WIDE_W} bytes")
        # the least bytes: the query rows and lengths in, the outputs out
        b_ms, b_by = bound_ms(WIDE_ROWS * (WIDE_W + 4 + out_bytes))
        out[name] = {"W": WIDE_W, "rows": WIDE_ROWS, "ms": kernel_ms(lambda: kern(live), 10),
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
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
    (url: SVC_URL_KEYS of the phase data's stored keys; email: N_EMAIL
    keys), N_CLIENTS client threads over disjoint key partitions of both,
    each submitting its
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
    tenants = {"url": (keys[:SVC_URL_KEYS], values[:SVC_URL_KEYS]),
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


@contextlib.contextmanager
def recorded_calls(owner, name, n=None):
    """The arguments and the output of the first ``n`` calls (all, where
    ``n`` is None) of ``owner.name`` inside the block, from any thread."""
    calls, fn = [], getattr(owner, name)

    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        if n is None or len(calls) < n:
            calls.append((args, out))
        return out

    setattr(owner, name, call)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


@contextlib.contextmanager
def bulk_loads(cls):
    """Each ``cls.bulkload`` inside the block: (builder, seconds to a sync)."""
    loads, fn = [], cls.bulkload

    def call(self, *args, **kwargs):
        t = time.time()
        out = fn(self, *args, **kwargs)
        sync()
        loads.append((self, time.time() - t))
        return out

    cls.bulkload = call
    try:
        yield loads
    finally:
        cls.bulkload = fn


@contextlib.contextmanager
def stage_clock(owner, names, split):
    """Card time of each call of ``owner``'s functions ``names`` inside the
    block, a sync before and after each, summed into ``split`` by name."""
    saved = {name: getattr(owner, name) for name in names}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[name] = split.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return call

    for name, fn in saved.items():
        setattr(owner, name, timed(name, fn))
    try:
        yield split
    finally:
        for name, fn in saved.items():
            setattr(owner, name, fn)


def padded_search(r: int, m: int, N: int, pad_below: bool, iters: int) -> int:
    """The reference's rank over a shard's sorted order of ``m`` keys padded
    to ``N`` rows with its smallest key: its binary search, ``iters`` steps,
    goes right at a row below the true rank ``r`` and at a pad row whose key
    is below the start (``pad_below``)."""
    lo, hi = 0, N
    for _ in range(iters):
        mid = (lo + hi) // 2
        if lo < hi and (mid < r if mid < m else pad_below):
            lo = mid + 1
        elif lo < hi:
            hi = mid
    return lo


def scan_oracle(shard_keys, val_of, N: int, iters: int, starts, window: int):
    """What the reference's ``scan_entries`` answers, from the host's key
    lists alone: each shard's window over its sorted keys, padded to ``N``
    rows with its smallest key (``padded_search``), concatenated in shard
    order; and how many of those windows differ from the plain sorted order
    of all keys (``everything``)."""
    out = []
    for s in starts:
        win = []
        for ks in shard_keys:
            if len(win) >= window or not ks:
                continue
            m = len(ks)
            r = bisect.bisect_left(ks, s)
            lo = r if m == N else padded_search(r, m, N, ks[0] < s, iters)
            for p in range(lo, min(lo + window, N)):
                if len(win) >= window:
                    break
                k = ks[p] if p < m else ks[0]
                win.append((k, val_of[k]))
        out.append(win)
    return out


def distributed_phase(keys, values, batches, smi, dev):
    """Phase distributed: ``build_sharded`` of the phase data's url keys into
    DIST_SHARDS shards on the card; DIST_BATCHES of the main phase's lookup
    batches through the in-process ``get_batch``; one batch at DIST_TIGHT that
    must overflow; two ``scan_entries`` batches with starts just below every
    boundary; an ``IndexService`` over the index with DIST_CLIENTS clients;
    a one-rank NCCL group.  Every answer is held to the host's reckoning
    (lost keys, routing misses and padded-order windows included), and K1,
    K2, K4 and K6 to their plain versions on the phase's own inputs.
    Returns the phase's kernel launches and its numbers."""
    import threading

    import torch.distributed as dist

    from repro_torch.core.builder import LITSBuilder
    from repro_torch.core.hpt import HPT, MAX_CDF_STEPS, get_cdf_np64
    from repro_torch.core.strings import StringSet
    from repro_torch.core.tensor_index import pad_queries
    from repro_torch.data import ycsb
    from repro_torch.distributed import (
        DistributedStringIndex, RoutingOverflowError, build_sharded, index_service)
    from repro_torch.index import GetRequest, IndexConfig, PutRequest, Status
    from repro_torch.kernels import _build, hpt_cdf, hpt_locate, scan, traverse
    from repro_torch.kernels._build import as_rows
    from repro_torch.serve import IndexService, ServiceConfig

    cfg = IndexConfig(device=DEVICE)
    _build.reset_launches()
    sync()
    t = time.time()
    with ModelCalls().on(LITSBuilder) as calls, bulk_loads(LITSBuilder) as loads:
        sidx = build_sharded(keys, values, DIST_SHARDS, device=DEVICE)
        dsi = DistributedStringIndex(sidx, per_dest_capacity=DIST_CAPACITY, config=cfg)
    sync()
    build_s = time.time() - t
    probe_s, shard_s = loads[0][1], [sec for _, sec in loads[1:]]
    builders = [b for b, _ in loads[1:]]
    n, W = DIST_SHARDS, sidx.width
    say(f"phase distributed: build_sharded of {len(keys)} url keys into {n} shards on the card "
        f"in {build_s:.2f} s (probe bulk load {probe_s:.2f} s, shard bulk loads "
        f"{', '.join(f'{x:.2f}' for x in shard_s)} s); boundaries {sidx.boundaries.tolist()}; "
        f"sorted entries per shard {list(sidx.sorted_lens)}; width {W}; max_iters "
        f"{sidx.stacked.max_iters}, rank_iters {sidx.stacked.rank_iters}")
    say(f"distributed_build_s={build_s:.2f}")

    # the host's reckoning: each stored key's build shard (host float64
    # GetCDF cast to float32, as build_sharded partitions) and each shard's
    # lost keys (entries its builder's tree no longer reaches)
    t = time.time()
    hpt = HPT(sidx.stacked.cdf_tab[0].cpu().numpy(), sidx.stacked.prob_tab[0].cpu().numpy())
    skeys = sorted(keys)
    cdfs = get_cdf_np64(hpt, StringSet.from_list(skeys)).astype(np.float32)
    shard_of = dict(zip(skeys, np.searchsorted(sidx.boundaries, cdfs, side="right").tolist()))
    at_boundary = [int((cdfs == b).sum()) for b in sidx.boundaries]
    del cdfs
    shard_keys = [[] for _ in range(n)]
    for k in skeys:
        shard_keys[shard_of[k]].append(k)
    lost = []
    for b in builders:
        reach = set(b.iter_subtree(b.root_item))
        lost.append({b.key_at(e) for e in range(b.ent_off.n) if e not in reach})
    sample = [k for s in lost for k in sorted(s)[:SVC_LOST_SAMPLE // n]]
    reachable = sum(builders[shard_of[k]].host_search(k)[0] for k in sample)
    if [len(ks) for ks in shard_keys] != list(sidx.sorted_lens) or reachable:
        fail(f"distributed: the host's partition {[len(ks) for ks in shard_keys]} is not the "
             f"build's {list(sidx.sorted_lens)}, or {reachable} lost keys are reachable")
    reckon_s = time.time() - t

    # lookups: the main phase's batches, routed
    val_of = dict(zip(keys, values.tolist()))
    lookups = batches[:DIST_BATCHES]
    with recorded_calls(index_service, "base_search", 1) as k4_calls, \
            recorded_calls(index_service, "get_cdf", 1) as k2_calls:
        sync()
        t = time.time()
        answers = [dsi.get_batch(q) for q in lookups]
        get_s = time.time() - t
    lookup_launches = dict(_build.LAUNCHES)
    n_q = sum(len(q) for q in lookups)
    say(f"distributed_lookups_per_s={n_q / get_s:.0f}")
    # each query's owner by the plain GetCDF (run on the card), against the
    # build shard and the answers
    ct, pt = sidx.stacked.cdf_tab[0].contiguous(), sidx.stacked.prob_tab[0].contiguous()
    bnd = torch.from_numpy(sidx.boundaries).to(dev)
    owners = []
    for q in lookups:
        qb, ql = (torch.from_numpy(a).to(dev) for a in pad_queries(q, W))
        plain = hpt_cdf.hpt_cdf_plain(qb, as_rows(ql, len(q), torch.int32, dev),
                                      as_rows(0, len(q), torch.int32, dev), ct, pt, MAX_CDF_STEPS)
        owners.append(torch.searchsorted(bnd, plain, right=True).cpu().numpy())
    wrong = false_hits = unexplained = 0
    miss_lost, miss_routed, routed_away = set(), set(), set()
    for q, (found, got), own in zip(lookups, answers, owners):
        for k, f, v, o in zip(q, found.tolist(), got.tolist(), own.tolist()):
            home = shard_of.get(k)
            if home is None:
                false_hits += f
            elif o != home:
                routed_away.add(k)
                if f:
                    unexplained += 1
                else:
                    miss_routed.add(k)
            elif f:
                wrong += v != val_of[k]
            elif k in lost[home]:
                miss_lost.add(k)
            else:
                unexplained += 1
    want_lost = {k for q in lookups for k in q if k in shard_of and k in lost[shard_of[k]]
                 and k not in routed_away}
    say(f"phase distributed: get_batch of {n_q} queries in {len(lookups)} batches of {BATCH} "
        f"(the main mix) at per_dest_capacity {DIST_CAPACITY}: {get_s:.2f} s = "
        f"{n_q / get_s:.0f} lookups/s ({smi}); wrong values {wrong}, hits on keys never stored "
        f"{false_hits}, misses not explained {unexplained}; launches {lookup_launches}; host "
        f"reckoning {reckon_s:.1f} s")
    say(f"distributed_lost_keys={len(miss_lost)} (queried; the shard builds lose "
        f"{[len(x) for x in lost]}, host reckoning {len(want_lost)})")
    say(f"distributed_routing_misses={len(miss_routed)} (stored keys whose router CDF "
        f"buckets away from their build shard; host reckoning {len(routed_away)}; stored keys "
        f"whose host float32 CDF equals a boundary: {at_boundary})")
    if (wrong or false_hits or unexplained or miss_lost != want_lost
            or miss_routed != routed_away):
        fail("distributed lookups differ from the host's reckoning")

    # overflow: one batch at a capacity its owner histogram passes
    q = lookups[0]
    per_sender = owners[0].reshape(n, -1)
    dropped = sum(int(np.maximum(np.bincount(o, minlength=n) - DIST_TIGHT, 0).sum())
                  for o in per_sender)
    tight = DistributedStringIndex(sidx, per_dest_capacity=DIST_TIGHT, config=cfg)
    try:
        tight.get_batch(q)
        raised = None
    except RoutingOverflowError as e:
        raised = str(e)
    statuses = collections.Counter(r.status.name for r in tight.execute(
        [GetRequest(k) for k in q]).results)
    say(f"phase distributed: one batch at per_dest_capacity {DIST_TIGHT}: raised {raised!r}; "
        f"the host reckons {dropped} dropped rows; execute statuses {dict(statuses)}")
    if not raised or not raised.startswith(f"{dropped} queries exceeded") or \
            statuses != {"ROUTING_OVERFLOW": len(q)}:
        fail("the overflow batch did not overflow as the host reckons")

    # scans: starts just below every boundary, and the main mix's keys
    rng = np.random.default_rng(SEED + 6)
    cuts = np.cumsum([len(ks) for ks in shard_keys])
    near = [skeys[min(max(c - 1 - j, 0), len(skeys) - 1)] for c in cuts
            for j in range(DIST_SCANS // (2 * n))]
    scan_sets = [near + [k[: int(m)] for k, m in zip(lookups[i][: DIST_SCANS - len(near)],
                                                       rng.integers(1, 40, DIST_SCANS))]
                 for i in range(2)]
    before = dict(_build.LAUNCHES)
    with recorded_calls(index_service, "scan_batch", 1) as k6_calls:
        sync()
        t = time.time()
        windows = [dsi.scan_entries(st, WINDOW) for st in scan_sets]
        scan_s = time.time() - t
    scan_launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    t = time.time()
    want = [scan_oracle(shard_keys, val_of, max(sidx.sorted_lens), sidx.stacked.rank_iters,
                        st, WINDOW) for st in scan_sets]
    bad = sum(g != w for gs, ws in zip(windows, want) for g, w in zip(gs, ws))
    padded_windows = 0
    for st, ws in zip(scan_sets, want):
        for s, w in zip(st, ws):
            i = bisect.bisect_left(skeys, s)
            padded_windows += w != [(k, val_of[k]) for k in skeys[i: i + WINDOW]]
    n_s = sum(len(st) for st in scan_sets)
    say(f"distributed_scans_per_s={n_s / scan_s:.0f}")
    say(f"phase distributed: scan_entries of {n_s} starts in 2 batches, window {WINDOW} "
        f"({len(near)} just below the {n} shard ends): {scan_s:.2f} s = {n_s / scan_s:.0f} "
        f"scans/s; windows differing from the host's {bad}; of them the reference's padded "
        f"order changes {padded_windows} ({time.time() - t:.1f} s); launches {scan_launches}")
    if bad:
        fail(f"{bad} distributed scan windows differ from the host's")

    # the request plane over a distributed index of tenant-encoded keys (the
    # service stores every key under its tenant's prefix): YCSB C and puts
    svc_launches = dict(_build.LAUNCHES)
    t = time.time()
    sub = keys[:DIST_SVC_KEYS]
    sdsi = DistributedStringIndex.build([IndexService.encode_key("url", k) for k in sub],
                                        values[:DIST_SVC_KEYS], n, config=cfg,
                                        per_dest_capacity=DIST_CAPACITY)
    svc_build_s = time.time() - t
    svc = IndexService(sdsi, ServiceConfig(max_batch=SVC_GROUP, default_tenant="url",
                                           merge_threshold=None, max_queue=4 * BATCH))
    try:
        work = []
        for c in range(DIST_CLIENTS):
            ops = ycsb.generate("C", sub[c::DIST_CLIENTS], [], DIST_SVC_GETS, dist="zipf",
                                seed=SEED * 100 + c)
            reqs = [GetRequest(o.key) for o in ops]
            reqs[::64] = [PutRequest(o.key, 1) for o in ops[::64]]
            work.append([reqs[i: i + SVC_GROUP] for i in range(0, len(reqs), SVC_GROUP)])
        got, errors = [None] * DIST_CLIENTS, []
        barrier = threading.Barrier(DIST_CLIENTS + 1, timeout=600)

        def client(c):
            try:
                barrier.wait()
                got[c] = [svc.submit_batch(g, None).result(timeout=600) for g in work[c]]
            except BaseException as e:  # reported by the main thread
                errors.append(f"client {c}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,)) for c in range(DIST_CLIENTS)]
        for th in threads:
            th.start()
        barrier.wait()
        t = time.perf_counter()
        for th in threads:
            th.join(900)
        svc_s = time.perf_counter() - t
        if any(th.is_alive() for th in threads) or errors:
            fail(f"distributed service clients did not finish: {errors[:4]}")
        st = svc.stats()
    finally:
        svc.close()
    launches = dict(_build.LAUNCHES)
    svc_launches = {k: v - svc_launches[k] for k, v in launches.items()}
    differ, n_ops, hist = 0, 0, collections.Counter()
    for c in range(DIST_CLIENTS):
        for g, res in zip(work[c], got[c]):
            direct = sdsi.execute([svc._encode(r, None) for r in g]).results
            differ += sum((a.status, a.value) != (b.status, b.value) for a, b in zip(res, direct))
            hist.update(f"{type(r).__name__[:-7].lower()} {a.status.name}"
                        for r, a in zip(g, res))
            n_ops += len(g)
    say(f"phase distributed: IndexService over {len(sub)} tenant-encoded url keys in {n} "
        f"shards (built in {svc_build_s:.1f} s), {DIST_CLIENTS} clients, {n_ops} ops (YCSB C "
        f"zipf gets, every 64th a put) in groups of {SVC_GROUP}: {svc_s:.2f} s = "
        f"{n_ops / svc_s:.0f} ops/s; p50 {st.p50_ms:.1f} ms p99 {st.p99_ms:.1f} ms; coalescing "
        f"{st.coalescing_factor:.1f}; results differing from a direct execute {differ}; "
        f"statuses {dict(sorted(hist.items()))}; launches {svc_launches}")
    if differ or any(k.startswith("put") and k != "put UNSUPPORTED" for k in hist):
        fail("the service over the distributed index answers differently from execute")
    for name in ("hpt_locate", "hpt_cdf", "fused_search", "scan"):
        if launches[name] == 0:
            fail(f"the distributed path never launched {name}")

    # each kernel against its plain version on the phase's own inputs
    checks = {}
    (ti, rq, rl), _ = k4_calls[0]
    checks["fused_search, one shard's received rows"] = (
        traverse.fused_search_cuda(ti, rq, rl), traverse.fused_search_plain(ti, rq, rl))
    (ct2, pt2, qb, ql, start), _ = k2_calls[0]
    args = (qb, as_rows(ql, qb.shape[0], torch.int32, dev),
            as_rows(start, qb.shape[0], torch.int32, dev), ct2, pt2, MAX_CDF_STEPS)
    checks["hpt_cdf, the router's rows"] = ((hpt_cdf.hpt_cdf_cuda(*args),),
                                            (hpt_cdf.hpt_cdf_plain(*args),))
    (sti, sqb, sql, swin), _ = k6_calls[0]
    checks["scan, one shard's starts"] = (scan.fused_scan_cuda(sti, sqb, sql, window=swin),
                                          scan.fused_scan_plain(sti, sqb, sql, window=swin))
    for name, (g, w) in checks.items():
        same = all(torch.equal(a, b) for a, b in zip(g, w))
        say(f"phase distributed: {name}: kernel == plain on {g[0].shape[0]} rows: {same}")
        if not same:
            fail(f"distributed: {name} differs from its plain version")
    replay = replay_bulk_load(
        calls, {"hpt_cdf": hpt_cdf.hpt_cdf_cuda, "hpt_locate": hpt_locate.hpt_locate_cuda},
        {"hpt_cdf": hpt_cdf.hpt_cdf_plain, "hpt_locate": hpt_locate.hpt_locate_plain}, dev)
    del calls
    say("phase distributed: the builds' calls replayed: " + "; ".join(
        f"{name} {r['launches']} launches over {r['rows']} rows, outputs equal to the build's "
        f"{r['equal_to_build']}, to the plain version {r['equal_to_plain']}"
        for name, r in replay.items()))
    for name, r in replay.items():
        if not (r["equal_to_build"] and r["equal_to_plain"]):
            fail(f"distributed: the builds' {name} calls replay differently")

    # where one routed get_batch's time goes, and K4/K6 at this path's shapes
    split = {}
    with stage_clock(index_service, ("pad_queries", "get_cdf", "_exchange", "base_search",
                                     "lookup_values"), split):
        for q in lookups[1:4]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dsi.get_batch(q)
            split["get_batch"] = split.get("get_batch", 0.0) + (time.perf_counter() - t0) * 1e3
    split = {k: v / 3 for k, v in split.items()}
    split["pack, unpack, copies"] = split["get_batch"] - sum(
        v for k, v in split.items() if k != "get_batch")
    times = {"fused_search": {"rows": rq.shape[0],
                              "ms": kernel_ms(lambda: traverse.fused_search_cuda(ti, rq, rl), 50),
                              "plain_ms": time_cuda(lambda: traverse.fused_search_plain(
                                  ti, rq, rl), reps=3, warmup=1)},
             "scan": {"rows": sqb.shape[0],
                      "ms": kernel_ms(lambda: scan.fused_scan_cuda(sti, sqb, sql, window=swin), 50),
                      "plain_ms": time_cuda(lambda: scan.fused_scan_plain(
                          sti, sqb, sql, window=swin), reps=3, warmup=1)}}
    say(f"phase distributed: get_batch of {BATCH} queries, ms per stage (a sync around each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + "; " + ", ".join(
            f"{k} at {v['rows']} rows {v['ms']:.4f} ms (plain {v['plain_ms']:.2f} ms)"
            for k, v in times.items()))

    # the process-group form on the card: one NCCL rank holds the one shard
    t = time.time()
    sub = keys[:DIST_NCCL_KEYS]
    one = build_sharded(sub, values[:DIST_NCCL_KEYS], 1, device=DEVICE)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0)
    try:
        q = lookups[1][:BATCH // 4]
        qb, ql = (torch.from_numpy(a).to(dev) for a in pad_queries(q, one.width))
        same = True
        for cap in (BATCH, DIST_TIGHT):
            pg = DistributedStringIndex(one, group=dist.group.WORLD, per_dest_capacity=cap,
                                        config=cfg)
            here = DistributedStringIndex(one, per_dest_capacity=cap, config=cfg)
            a, b = pg._fn(qb, ql), here._fn(qb, ql)
            same &= all(torch.equal(x, y) for x, y in zip(a, b))
            overflow = int(a[3].sum())
        same &= (pg.execute([GetRequest(k) for k in q[:DIST_TIGHT]]).results
                 == here.execute([GetRequest(k) for k in q[:DIST_TIGHT]]).results)
    finally:
        dist.destroy_process_group()
    say(f"phase distributed: one-rank NCCL group over {len(sub)} keys: the process-group form "
        f"(all_to_all_single on the card) == the in-process form on {len(q)} rows at capacities "
        f"{BATCH} and {DIST_TIGHT} (dropped {overflow}) and on an execute: {same}; "
        f"{time.time() - t:.1f} s")
    if not same or not overflow:
        fail("the NCCL process-group form differs from the in-process form")
    numbers = {"lookups_per_s": n_q / get_s, "scans_per_s": n_s / scan_s, "build_s": build_s,
               "probe_s": probe_s, "shard_s": shard_s, "service_ops_per_s": n_ops / svc_s,
               "split_ms": split, "times": times, "lost": len(miss_lost),
               "routing_misses": len(miss_routed), "padded_windows": padded_windows}
    return launches, numbers


def lru_replay(plan_keys, capacity: int):
    """The prefix cache's counts for a request plan, replayed on the host by
    the reference's rule: hits refresh recency in key order; a batch with a
    miss admits its misses after evicting the least recently used past
    ``capacity``.  Returns (hits, misses, inserts, evictions, the keys held
    at the end, per batch whether it was served from the cache)."""
    lru = collections.OrderedDict()
    hits = misses = inserts = evictions = 0
    from_cache = []
    for keys in plan_keys:
        hit = [k in lru for k in keys]
        for k, h in zip(keys, hit):
            if h:
                lru.move_to_end(k)
        hits += sum(hit)
        misses += len(keys) - sum(hit)
        from_cache.append(all(hit))
        if not all(hit):
            new = list(dict.fromkeys(k for k, h in zip(keys, hit) if not h))
            for _ in range(min(max(len(lru) + len(new) - capacity, 0), len(lru))):
                lru.popitem(last=False)
                evictions += 1
            for k in new:
                lru[k] = True
                inserts += 1
    return hits, misses, inserts, evictions, set(lru), from_cache


def lm_plan(vocab: int):
    """``launch/serve.py``'s request draw: a base batch first, then per
    request a repeat of it (probability LM_REPEAT, never the first) or a
    fresh batch, from ``np.random.default_rng(0)``.  Returns the batches and
    each one's id (``-1``: the base)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, size=(LM_BATCH, LM_PROMPT)).astype(np.int32)
    plan = []
    for r in range(LM_REQUESTS):
        if rng.random() < LM_REPEAT and r > 0:
            plan.append((-1, base))
        else:
            plan.append((r, rng.integers(0, vocab, size=(LM_BATCH, LM_PROMPT)).astype(np.int32)))
    return plan


def lm_close(name: str, got, want, tol: float) -> float:
    """Fail unless ``got`` (on any device) is within rtol = atol = ``tol`` of
    ``want``; returns the largest absolute difference."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
        fail(f"phase lm: {name}: a non-finite value")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f"phase lm: {name}: max |diff| {err:.4g} outside rtol = atol = {tol}")
    return err


def lm_reduced_archs(dev) -> dict:
    """Check (e): every reduced arch on the card against the port on the CPU
    with the same weights (``tests/_torch_cases.py``'s ``lm_card_vs_cpu``:
    prefill and two decode steps; hubert, encoder-only: its forward).
    Returns each arch's largest logit difference."""
    from repro_torch.configs.registry import ARCHS

    from _torch_cases import LM_CARD_TOL, lm_card_vs_cpu

    def errs(name):
        return lm_card_vs_cpu(name, dev, lambda what, got, want: lm_close(
            f"{name} {what}", got, want, LM_CARD_TOL))

    return {name: max(errs(name)) for name in ARCHS}


def lm_phase(smi, dev):
    """Phase lm: the LM serving path at the full width of LM_ARCH on the card
    (``LMModel`` from a generator seeded 0, ``ServeEngine`` with its prefix
    cache's index on the card), then checks (a)-(g):

    (a) the cache's hits, misses, inserts and evictions equal a host replay
        of the request plan, and every batch served from the cache generates
        its first serve's tokens, bit for bit;
    (b) at full width, ``prefill``'s last logits equal ``forward``'s within
        rtol = atol = 2e-2, and the first ``decode_step``'s equal
        ``forward``'s on S+1 tokens within 6e-2 over the first 2 layers (the
        reference's test's depth) and within LM_DEPTH_TOL over all 30;
    (c) layer 0 and the head at full width on one prompt row, the card
        against the port on the CPU with the same weights, within LM_CARD_TOL;
    (d) no non-finite logit anywhere;
    (e) every reduced arch on the card against the CPU port (``lm_reduced_archs``);
    (f) every slot the cache's index returns equals the cache's host dict;
    (g) every K4 call the served traffic made (the cache's lookups and the
        base walks of its admissions and evictions) equals the plain
        version's on the same rows and index, on every output;
    (f) the same weights as bf16 parameters (``LMModel(param_dtype=
        torch.bfloat16)``, cast from this model, which is then freed):
        ``lm_bf16_phase``.

    Returns the index kernels' launches during the served traffic and the
    phase's numbers."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import tensor_index
    from repro_torch.kernels import _build, traverse
    from repro_torch.models import LMModel
    from repro_torch.serve import ServeEngine

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_cases import LM_CARD_TOL, LM_DEPTH_TOL

    t_phase = time.time()
    cfg = get_arch(LM_ARCH)
    if LM_REDUCED:
        cfg = cfg.reduced()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = LMModel(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    sync()
    init_s = time.time() - t
    weight_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    peak = (lambda: torch.cuda.max_memory_allocated() / 1e9) if DEVICE == "cuda" else (lambda: 0.0)
    say(f"phase lm: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}): "
        f"{model.cfg.param_count()} float32 parameters = {weight_gb:.2f} GB, initialised on "
        f"{dev} in {init_s:.1f} s; max_memory_allocated {peak():.2f} GB")

    # (d) every logit the engine sees is finite: a device flag, read once
    bad = torch.zeros((), dtype=torch.bool, device=dev)

    def finite_checked(fn):
        def call(*args, **kw):
            cache, logits = fn(*args, **kw)
            bad.logical_or_(~torch.isfinite(logits).all())
            return cache, logits
        return call

    model.prefill = finite_checked(model.prefill)
    model.decode_step = finite_checked(model.decode_step)

    # the served traffic; launch counts around it
    plan = lm_plan(cfg.vocab)
    eng = ServeEngine(model, cache_capacity=LM_CAPACITY, max_len=LM_MAX_LEN)
    try:
        need = LM_PROMPT + LM_GEN + 1
        plan_keys = [[ServeEngine._prompt_key(p[i], need) for i in range(LM_BATCH)]
                     for _, p in plan]
        _build.reset_launches()
        sync()
        first_out, walls = {}, []
        t = time.time()
        with recorded_calls(tensor_index, "fused_search") as k4_calls:
            for (bid, prompts), keys in zip(plan, plan_keys):
                cached_before = eng.stats.cached_prefills
                sync()
                t0 = time.perf_counter()
                out = eng.generate(prompts, n_steps=LM_GEN)["generated"]
                sync()
                walls.append(((time.perf_counter() - t0) * 1e3,
                              eng.stats.cached_prefills > cached_before))
                if bid in first_out:
                    if not walls[-1][1]:
                        fail(f"phase lm: batch {bid} served again but not from the cache")
                    if not np.array_equal(out, first_out[bid]):
                        fail(f"phase lm: batch {bid} from the cache generated other tokens")
                else:
                    first_out[bid] = out
        serve_s = time.time() - t
        launches = dict(_build.LAUNCHES)
        pc, svc = eng.prefix_cache.stats, eng.prefix_cache.service.stats()
        counts = (pc.hits, pc.misses, pc.inserts, pc.evictions)
        # (a) the cache's counts and the served-from-cache batches
        want = lru_replay(plan_keys, LM_CAPACITY)
        if counts != want[:4] or [c for _, c in walls] != want[5]:
            fail(f"phase lm: cache counts (hits, misses, inserts, evictions) {counts}, "
                 f"batches from the cache {[c for _, c in walls]}; the host replay gives "
                 f"{want[:4]}, {want[5]}")
        if launches["fused_search"] == 0:
            fail("phase lm: the served traffic never launched fused_search")
        # (f) every key's slot in the index equals the cache's host dict; the
        #     keys the replay evicted miss
        distinct = list(dict.fromkeys(k for keys in plan_keys for k in keys))
        with recorded_calls(tensor_index, "fused_search") as k4_lookup:
            hit, slots = eng.prefix_cache.lookup(distinct)
        held = want[4]
        for k, h, s in zip(distinct, hit.tolist(), slots.tolist()):
            if h != (k in held) or (h and (s != eng.prefix_cache._key_slot[k]
                                           or eng.prefix_cache.get_state(s) is None)):
                fail(f"phase lm: the index answers ({h}, {s}) for a key the host holds "
                     f"{k in held}, slot {eng.prefix_cache._key_slot.get(k)}")
        # (g) K4 at the path's own shapes: every call of the served traffic
        #     and the lookup of (f), against the plain version on the same
        #     rows and the same index (a write or a merge makes a new
        #     TensorIndex, so each recorded one is the index its call walked)
        k4_err = 0.0
        for (ti, qb, ql), got in k4_calls + k4_lookup:
            plain = traverse.fused_search_plain(ti, qb, ql)
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                fail(f"phase lm: fused_search differs from its plain version on a call of "
                     f"{qb.shape[0]} rows of width {qb.shape[1]}")
            k4_err = max(k4_err, max_abs_err(got, plain))
        k4_rows = [qb.shape[0] for (_, qb, _), _ in k4_calls]
        if sum(n > 0 for n in k4_rows) != launches["fused_search"]:
            fail(f"phase lm: {len(k4_calls)} fused_search calls recorded against "
                 f"{launches['fused_search']} launches")
        cached_ms = [w for w, c in walls if c]
        uncached_ms = [w for w, c in walls if not c]
        n_tok = LM_REQUESTS * LM_BATCH * LM_GEN
        say(f"phase lm: {LM_REQUESTS} request batches of {LM_BATCH} prompts x {LM_PROMPT} "
            f"tokens + {LM_GEN} generated (keys of {len(plan_keys[0][0])} bytes) in "
            f"{serve_s:.2f} s = {n_tok / serve_s:.1f} generated tokens/s ({smi}); wall ms a "
            f"batch: from the cache {[round(w, 1) for w in cached_ms]}, prefilled "
            f"{[round(w, 1) for w in uncached_ms]}; prefills {eng.stats.prefills} "
            f"cached_prefills {eng.stats.cached_prefills} decode_steps "
            f"{eng.stats.decode_steps}")
        hit_rate = counts[0] / (counts[0] + counts[1])
        say(f"phase lm: prefix cache hit_rate {hit_rate:.3f} hits {counts[0]} misses "
            f"{counts[1]} inserts {counts[2]} evictions {counts[3]} merges {pc.merges} "
            f"(host replay {want[:4]}: equal); {len(distinct)} distinct prompts, slots equal "
            f"to the host dict; service p50 {svc.p50_ms:.2f} ms p99 {svc.p99_ms:.2f} ms, "
            f"flushes {svc.flushes}; index kernel launches {launches}")
        say(f"phase lm: (g) fused_search == plain on every output of the served traffic's "
            f"{len(k4_calls)} calls (rows a call {k4_rows}, width {k4_calls[0][0][1].shape[1]}) "
            f"and the {len(k4_lookup)} of (f)'s lookup of {len(distinct)} keys: max_abs_err "
            f"{k4_err}")
    finally:
        eng.prefix_cache.close()
    del model.prefill, model.decode_step

    # timings at the served shapes: prefill of a batch, one decode step
    prompts = torch.from_numpy(plan[0][1]).to(dev)
    prefill_ms = time_cuda(lambda: model.prefill({"tokens": prompts}, max_len=need), reps=5)
    cache, logits = model.prefill({"tokens": prompts}, max_len=need)
    tok = torch.argmax(logits[:, : cfg.vocab], -1).to(torch.int32)
    decode_ms = time_cuda(lambda: model.decode_step(cache, tok, LM_PROMPT), reps=10)
    with torch.no_grad():
        f32_dec = model.decode_step(cache, tok, LM_PROMPT)[1].float().cpu()   # for (f)
    say(f"phase lm: prefill of {LM_BATCH} x {LM_PROMPT} tokens {prefill_ms:.2f} ms; decode "
        f"step of {LM_BATCH} rows {decode_ms:.2f} ms = {LM_BATCH / decode_ms * 1e3:.1f} "
        f"tokens/s; max_memory_allocated {peak():.2f} GB ({smi})")

    # where a decode step's time goes: one step under the profiler
    dev_ms, n_kernels, top = decode_profile(model, cache, tok)
    say(f"phase lm: one profiled decode step: {dev_ms:.2f} ms of kernel time against the "
        f"{decode_ms:.2f} ms step (idle share {max(0.0, 1 - dev_ms / decode_ms):.2f}), "
        f"{n_kernels} kernel launches; by kernel: {top}")

    # (b) prefill and decode against forward, at full width: prefill to the
    #     reference's 2e-2; decode to its 6e-2 at its test's depth (the first
    #     2 layers of the full-width model) and to LM_DEPTH_TOL through all
    #     layers, where bf16 rounding differences between the one-token and
    #     the whole-sequence products grow with depth
    def decode_vs_forward(n_layers, tol):
        model.cfg = dc.replace(cfg, n_layers=n_layers)
        try:
            with torch.no_grad():
                c, last_ = model.prefill({"tokens": prompts}, max_len=need)
                nxt_ = torch.argmax(last_[:, : cfg.vocab], -1).to(torch.int32)
                _, dec_ = model.decode_step(c, nxt_, LM_PROMPT)
                fwd = model.forward({"tokens": torch.cat([prompts, nxt_[:, None]], 1)})[:, -1]
                name = f"decode_step vs forward, {n_layers} layers"
                return lm_close(name, dec_, fwd, tol), float((dec_ - fwd).abs().mean())
        finally:
            model.cfg = cfg

    with torch.no_grad():
        full = model.forward({"tokens": prompts})
        _, last = model.prefill({"tokens": prompts}, max_len=need)
        err_prefill = lm_close("prefill vs forward", last, full[:, -1], 2e-2)
        del full
    err_decode2 = decode_vs_forward(2, 6e-2)
    err_decode = decode_vs_forward(cfg.n_layers, LM_DEPTH_TOL)
    # (c) layer 0 and the head on one prompt row: the card against the CPU port
    one = dc.replace(cfg, n_layers=1)
    cpu1 = LMModel(one, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in cpu1.top.items():
            p.copy_(model.top[name])
        for name, p in cpu1.blocks.items():
            p.copy_(model.blocks[name][:1])
        row = {"tokens": prompts[:1]}
        x, pos, _ = model._embed_inputs(row)
        x1, _ = model._block(model.layer(0), x, pos)
        card_logits = model._head(x1)
        xc, posc, _ = cpu1._embed_inputs({"tokens": prompts[:1].cpu()})
        xc1, _ = cpu1._block(cpu1.layer(0), xc, posc)
        err_layer0 = lm_close("layer 0, card vs cpu", x1, xc1, LM_CARD_TOL)
        err_head = lm_close("layer 0 + head, card vs cpu", card_logits, cpu1._head(xc1),
                            LM_CARD_TOL)
    del cpu1
    if bool(bad):   # (d)
        fail("phase lm: a non-finite logit on the served path")
    peak_gb = peak()
    # (f) the same weights as bf16 parameters, cast from this model, which
    #     is then freed
    with torch.no_grad():
        bf16 = LMModel(cfg, device=dev, param_dtype=torch.bfloat16, init=False)
        for q, p in zip(bf16.parameters(), model.parameters()):
            q.copy_(p)
    del model, eng, prompts, cache, logits, tok, last, x, x1, card_logits
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    bf16_numbers = lm_bf16_phase(bf16, plan, first_out, f32_dec, need, smi, dev)
    del bf16
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    say(f"phase lm: checks (b) prefill vs forward max |diff| {err_prefill:.4g} (tol 2e-2); "
        f"decode_step vs forward max / mean |diff| {err_decode2[0]:.4g} / {err_decode2[1]:.4g} "
        f"at 2 layers (tol 6e-2), {err_decode[0]:.4g} / {err_decode[1]:.4g} at "
        f"{cfg.n_layers} (tol {LM_DEPTH_TOL}); (c) card vs cpu on one row: "
        f"layer 0 {err_layer0:.4g}, logits {err_head:.4g} (tol {LM_CARD_TOL}); (d) all logits "
        "finite")
    t = time.time()
    reduced_errs = lm_reduced_archs(dev)
    say(f"phase lm: (e) reduced archs, card vs cpu, max |logit diff| (tol {LM_CARD_TOL}): "
        + ", ".join(f"{k} {v:.4g}" for k, v in reduced_errs.items())
        + f" in {time.time() - t:.1f} s; phase {time.time() - t_phase:.1f} s")
    numbers = {"arch": cfg.name, "weight_gb": weight_gb, "peak_gb": peak_gb,
               "prefill_ms": prefill_ms, "decode_ms": decode_ms,
               "profiled_decode_step_device_ms": dev_ms,
               "decode_vs_forward": {"2_layers": err_decode2, "all_layers": err_decode},
               "decode_tokens_per_s": LM_BATCH / decode_ms * 1e3,
               "served_tokens_per_s": n_tok / serve_s, "cached_batch_ms": cached_ms,
               "prefilled_batch_ms": uncached_ms, "hit_rate": hit_rate,
               "inserts": counts[2], "evictions": counts[3], "merges": pc.merges,
               "k4_calls_checked": len(k4_calls) + len(k4_lookup), "k4_rows": k4_rows,
               "k4_max_abs_err": k4_err,
               "service_p50_ms": svc.p50_ms, "service_p99_ms": svc.p99_ms,
               "reduced_arch_max_err": reduced_errs, "bf16": bf16_numbers}
    return launches, numbers


def decode_profile(model, cache, tok):
    """One ``decode_step`` under the profiler: (kernel ms, kernel launches,
    the 8 largest kernels by time, as text)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    sync()
    with profile(activities=acts) as prof:
        model.decode_step(cache, tok, LM_PROMPT)
        sync()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:   # kernel names are C++ templates: their heads and functors
        head = re.sub(r"^void |<.*$|\(.*$", "", e.name).replace("at::native::", "")[:40]
        functor = re.search(r"(\w+)_kernel_cuda", e.name)
        slot = by_name[head + (f"[{functor.group(1)}]" if functor else "")]
        slot[0] += e.time_range.elapsed_us() / 1e3
        slot[1] += 1
    top = ", ".join(f"{k} {ms:.2f} ms x{n}" for k, (ms, n) in sorted(
        by_name.items(), key=lambda kv: -kv[1][0])[:8])
    return sum(ms for ms, _ in by_name.values()), len(kernels), top


def lm_bf16_phase(model, plan, first_out, f32_dec, need: int, smi, dev) -> dict:
    """Check (f) of phase lm: ``model`` holds the phase's weights as bf16
    parameters (the float32 model they were cast from is freed).  A new
    ``ServeEngine`` serves the first LM_BF16_BATCHES request batches of the
    phase's plan: their greedy tokens must equal the float32 model's, and
    the first decode step's logits on the first batch must be within
    LM_CARD_TOL of the float32 model's (the products see the same bf16
    weights either way: the float32 model casts each layer to bf16 as it
    runs).  Prints ms a decode step and a prefill, one profiled decode
    step's kernels, and the peak memory, against the float32 model's in the
    phase's lines above."""
    from repro_torch.serve import ServeEngine

    from _torch_cases import LM_CARD_TOL

    t = time.time()
    cuda = DEVICE == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    weight_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    eng = ServeEngine(model, cache_capacity=LM_CAPACITY, max_len=LM_MAX_LEN)
    try:
        for bid, prompts in plan[:LM_BF16_BATCHES]:
            out = eng.generate(prompts, n_steps=LM_GEN)["generated"]
            if not np.array_equal(out, first_out[bid]):
                fail(f"phase lm: (f) bf16 parameters generated other tokens for batch {bid}")
    finally:
        eng.prefix_cache.close()
    prompts = torch.from_numpy(plan[0][1]).to(dev)
    cache, logits = model.prefill({"tokens": prompts}, max_len=need)
    tok = torch.argmax(logits[:, : model.cfg.vocab], -1).to(torch.int32)
    with torch.no_grad():
        err = lm_close("(f) bf16 vs float32 parameters, first decode step",
                       model.decode_step(cache, tok, LM_PROMPT)[1], f32_dec, LM_CARD_TOL)
    prefill_ms = time_cuda(lambda: model.prefill({"tokens": prompts}, max_len=need), reps=5)
    decode_ms = time_cuda(lambda: model.decode_step(cache, tok, LM_PROMPT), reps=10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    dev_ms, n_kernels, top = decode_profile(model, cache, tok)
    say(f"phase lm: (f) one profiled bf16 decode step: {dev_ms:.2f} ms of kernel time against "
        f"the {decode_ms:.2f} ms step (idle share {max(0.0, 1 - dev_ms / decode_ms):.2f}), "
        f"{n_kernels} kernel launches; by kernel: {top}")
    say(f"phase lm: (f) bf16 parameters ({weight_gb:.2f} GB, cast from the float32 model, "
        f"which is freed): {LM_BF16_BATCHES} request batches' greedy tokens equal the float32 "
        f"model's; first decode step max |logit diff| {err:.4g} (tol {LM_CARD_TOL}); prefill of "
        f"{LM_BATCH} x {LM_PROMPT} tokens {prefill_ms:.2f} ms; decode step of {LM_BATCH} rows "
        f"{decode_ms:.2f} ms; max_memory_allocated {peak_gb:.2f} GB ({smi}; "
        f"{time.time() - t:.1f} s)")
    return {"weight_gb": weight_gb, "peak_gb": peak_gb, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "first_decode_max_err": err,
            "profiled_decode_step_device_ms": dev_ms, "profiled_decode_step_kernels": n_kernels}


def fwd_bwd_ms(model, batch, policy: str) -> tuple:
    """One ``loss`` forward and backward under remat ``policy`` (``off`` or a
    ``REPRO_REMAT_POLICY``), after a warm-up pass: (host ms ending in a sync,
    the pass's peak device memory in GB)."""
    from repro_torch.launch.steps import zero_grads

    from _torch_cases import remat_policy

    with remat_policy(policy):
        for _ in range(2):
            zero_grads(model)
            sync()
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = model.loss(batch, remat=policy != "off")
            loss.backward()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
    return ms, (torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else 0.0)


def train_phase(smi, dev):
    """Phase train: LM training at the full width of TRAIN_ARCH on the card,
    cut to TRAIN_LAYERS layers, weights from a generator seeded 0: batches
    of TRAIN_BATCH rows of TRAIN_SEQ tokens from ``TokenPipeline``,
    TRAIN_ACCUM microbatches a step, the launcher's AdamW (lr 3e-4, float32
    moments, warmup a tenth of the steps), TRAIN_STEPS steps through
    ``train_loop.train``.  Checks, each failing the run:

    (a) every loss finite, the first within 1.0 of ln(vocab) + 0.5 (unit
        variance logits at initialisation), every grad norm > 0, every
        parameter moved; the run's peak memory under TRAIN_PEAK_GB;
    (b) remat off, ``none`` and ``dots`` give bit-identical gradients on one
        microbatch, at TRAIN_REMAT_LAYERS layers of the same width;
    (c) the loss and every gradient of a 1-layer cut at full width on one row
        of TRAIN_CPU_TOKENS tokens, the card against the CPU port with the
        same weights: the loss within LM_CARD_TOL, each gradient within
        ``grad_errors``' bound;
    (d) every reduced arch, one train step, card against the CPU port
        (``lm_train_step_card_vs_cpu``);
    (e) the reduced deepseek on the card: crashed at step 7 and resumed, bit
        for bit the uninterrupted run; accum 2 against accum 1 within the
        reference's test bounds; a checkpoint written on the card restores
        on the CPU, equal;
    (f) ``launch/train.main(["--arch", TRAIN_ARCH, "--steps", "4"])`` on the
        card.

    Prints step ms, trained tokens/s, peak memory, one profiled step's kernel
    time against its wall time, the optimizer's share of a step and the
    remat policies' times.  Returns the index kernels' launches during the
    training run (none of them is on this path) and the phase's numbers."""
    import dataclasses as dc
    import math
    import tempfile

    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import LMModel
    from repro_torch.train import _tree
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import TrainConfig, train

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_cases import (LM_CARD_TOL, LM_GRAD_RTOL, grad_errors,
                              lm_train_step_card_vs_cpu, remat_grads, train_crash_resume)

    t_phase = time.time()
    cuda = DEVICE == "cuda"
    full = get_arch(TRAIN_ARCH)
    cfg = full.reduced() if TRAIN_REDUCED else dc.replace(full, n_layers=TRAIN_LAYERS)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))

    def on_device(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def check(ok, msg):
        if not ok:
            fail(f"phase train: {msg}")

    micro = on_device({k: v[: TRAIN_BATCH // TRAIN_ACCUM] for k, v in pipe.batch_at(0).items()})

    # (b) remat off / none / dots at TRAIN_REMAT_LAYERS layers of the same width
    t = time.time()
    small = LMModel(dc.replace(cfg, n_layers=TRAIN_REMAT_LAYERS), device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    grads = remat_grads(small, micro)
    for policy in ("none", "dots"):
        for name, g in grads["off"].items():
            check(torch.equal(grads[policy][name], g),
                  f"(b) remat {policy} gives another gradient of {name} than remat off")
    del grads
    remat_small = {p: fwd_bwd_ms(small, micro, p) for p in ("off", "none", "dots")}
    per_layer_off_gb = (remat_small["off"][1] - remat_small["none"][1]) / TRAIN_REMAT_LAYERS
    del small
    if cuda:
        torch.cuda.empty_cache()
    say(f"phase train: (b) remat off, none and dots give bit-identical gradients of every "
        f"parameter on one microbatch of {TRAIN_SEQ} tokens at {TRAIN_REMAT_LAYERS} layers of "
        f"full width; forward + backward ms (peak GB): " + ", ".join(
            f"{p} {ms:.1f} ({gb:.2f})" for p, (ms, gb) in remat_small.items())
        + f"; recompute share of none {1 - remat_small['off'][0] / remat_small['none'][0]:.3f}"
        f" ({smi}; {time.time() - t:.1f} s)")

    # the model at the cell's depth
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = LMModel(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    say(f"phase train: {cfg.name} ({cfg.n_layers} of {full.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}): {n_params} parameters; float32 weights, gradients and two "
        f"moments {16 * n_params / 1e9:.2f} GB")

    # remat none / dots (/ off where it fits) at the cell's depth, before the
    # optimizer's moments exist
    remat_full = {p: fwd_bwd_ms(model, micro, p) for p in ("none", "dots")}
    off_est = remat_full["none"][1] + per_layer_off_gb * cfg.n_layers
    if off_est < 0.9 * 80:
        remat_full["off"] = fwd_bwd_ms(model, micro, "off")
    say(f"phase train: remat at {cfg.n_layers} layers, one microbatch forward + backward ms "
        f"(peak GB): "
        + ", ".join(f"{p} {ms:.1f} ({gb:.2f})" for p, (ms, gb) in remat_full.items())
        + ("" if "off" in remat_full else
           f"; off not run: {off_est:.1f} GB estimated ({per_layer_off_gb:.2f} GB a layer "
           f"more than none at {TRAIN_REMAT_LAYERS} layers)") + f" ({smi})")

    # (c) a 1-layer cut at full width on one row: the card against the CPU port
    t = time.time()
    one = dc.replace(cfg, n_layers=1)
    row = {k: v[:1, :TRAIN_CPU_TOKENS] for k, v in pipe.batch_at(0).items()}
    # built on the meta device (no initialisation) and given the card's weights
    cpu1 = LMModel(one, device="meta", generator=torch.Generator()).to_empty(device="cpu")
    with torch.no_grad():
        for name, p in cpu1.top.items():
            p.copy_(model.top[name])
        for name, p in cpu1.blocks.items():
            p.copy_(model.blocks[name][:1])
    steps_mod.zero_grads(cpu1)
    cpu_loss, _ = cpu1.loss({k: torch.from_numpy(v) for k, v in row.items()})
    cpu_loss.backward()
    model.cfg = one
    try:
        steps_mod.zero_grads(model)
        card_loss, card_met = model.loss(on_device(row))
        card_loss.backward()
    finally:
        model.cfg = cfg
    card_loss, cpu_loss = float(card_met["loss"]), float(cpu_loss.detach())
    card_g = {k: (p.grad[0] if k.startswith("blocks.") else p.grad)
              for k, p in model.params().items()}
    errs = grad_errors(card_g, {k: p.grad for k, p in cpu1.params().items()})
    del cpu1, card_g
    loss_err = abs(card_loss - cpu_loss)
    check(loss_err <= LM_CARD_TOL, f"(c) loss {card_loss} on the card against {cpu_loss} on "
          "the CPU")
    for name, (err, bound) in errs.items():
        check(err <= bound, f"(c) gradient of {name}: |card - cpu| {err:.4g} over {bound:.4g}")
    worst_c = max(errs.items(), key=lambda kv: kv[1][0] / max(kv[1][1], 1e-30))
    say(f"phase train: (c) 1 layer at full width on one row of {TRAIN_CPU_TOKENS} tokens, card "
        f"vs cpu: loss {card_loss:.6f} / {cpu_loss:.6f} (|diff| {loss_err:.3g}, "
        f"tol {LM_CARD_TOL}); gradients within their bounds (relative {LM_GRAD_RTOL}), the "
        f"closest {worst_c[0]} at {worst_c[1][0] / worst_c[1][1]:.3f} of its bound "
        f"({time.time() - t:.1f} s)")

    # the run: TRAIN_STEPS steps through train_loop.train, counts set to 0 first
    opt = opt_mod.AdamWConfig(lr=3e-4, state_dtype=torch.float32,
                              warmup_steps=max(TRAIN_STEPS // 10, 1), total_steps=TRAIN_STEPS)
    before = {k: p.detach().clone() for k, p in model.params().items()
              if p.numel() < 1 << 24}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    sync()
    t = time.time()
    out = train(model, pipe.batch_at, opt, TrainConfig(steps=TRAIN_STEPS, accum=TRAIN_ACCUM),
                generator=torch.Generator(dev).manual_seed(0))
    sync()
    run_s = time.time() - t
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"(a) a loss is not finite: {losses}")
    want0 = math.log(cfg.vocab) + 0.5
    check(abs(losses[0] - want0) <= 1.0, f"(a) first loss {losses[0]} not within 1.0 of "
          f"ln({cfg.vocab}) + 0.5 = {want0:.3f}")
    check(all(h["grad_norm"] > 0 for h in hist), "(a) a grad norm is not > 0")
    unmoved = [k for k, v in before.items() if torch.equal(model.params()[k].detach(), v)]
    check(not unmoved, f"(a) parameters {unmoved} did not move")
    check(peak_gb <= TRAIN_PEAK_GB, f"(a) peak memory {peak_gb:.2f} GB over {TRAIN_PEAK_GB}")
    check(not any(launches.values()), f"index kernels launched while training: {launches}")
    step_s = sorted(h["step_time_s"] for h in hist[1:])
    step_ms = 1e3 * step_s[len(step_s) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say(f"phase train: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens (accum "
        f"{TRAIN_ACCUM}) in {run_s:.1f} s ({smi}): step ms "
        f"{[round(1e3 * h['step_time_s'], 1) for h in hist]}, "
        f"median after the first {step_ms:.1f} = {tokens / step_ms * 1e3:.0f} trained tokens/s; "
        f"loss {[round(x, 4) for x in losses]} (first vs ln(V) + 0.5 = {want0:.3f}), "
        f"grad_norm {[round(h['grad_norm'], 3) for h in hist]}, lr "
        f"{[float('%.3g' % h['lr']) for h in hist]}; max_memory_allocated {peak_gb:.2f} GB "
        f"(limit {TRAIN_PEAK_GB}); every parameter moved; index kernel launches {launches}")

    # the optimizer's share of a step, and one profiled step
    state = out["opt_state"]
    tree = model.param_tree()
    grads_tree = _tree.map_with_path(lambda _, p: p.grad, tree)
    opt_ms = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        opt_mod.apply_updates(tree, grads_tree, state, opt)
        sync()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step_fn = steps_mod.make_train_step(model, opt, accum=TRAIN_ACCUM)
    batch = on_device(pipe.batch_at(TRAIN_STEPS))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        sync()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        head = re.sub(r"^void |<.*$|\(.*$", "", e.name).replace("at::native::", "")[:40]
        by_name[head][0] += e.time_range.elapsed_us() / 1e3
        by_name[head][1] += 1
    dev_ms = sum(ms for ms, _ in by_name.values())
    say(f"phase train: optimizer (apply_updates, {n_params} parameters) {opt_ms[-1]:.1f} ms = "
        f"{opt_ms[-1] / step_ms:.3f} of a step; one profiled step: {dev_ms:.1f} ms of kernel "
        f"time against the {step_ms:.1f} ms step (idle share "
        f"{max(0.0, 1 - dev_ms / step_ms):.3f}; against the profiled step's own "
        f"{prof_wall:.1f} ms wall, which the profiler slows, "
        f"{max(0.0, 1 - dev_ms / prof_wall):.3f}), {len(kernels)} kernel launches ({smi}); "
        "by kernel: "
        + ", ".join(f"{k} {ms:.1f} ms x{n}" for k, (ms, n) in sorted(
            by_name.items(), key=lambda kv: -kv[1][0])[:8]))
    del out, state, tree, grads_tree, step_fn, batch, prof, kernels, before, model, micro
    if cuda:
        torch.cuda.empty_cache()

    # (d) every reduced arch: one train step, the card against the CPU port
    t = time.time()
    reduced = {}
    for name in ARCHS:
        r = lm_train_step_card_vs_cpu(name, dev)
        lr = r["cpu"]["lr"]
        check(abs(r["card"]["loss"] - r["cpu"]["loss"]) <= LM_CARD_TOL,
              f"(d) {name}: loss {r['card']['loss']} on the card, {r['cpu']['loss']} on the cpu")
        check(abs(r["card"]["grad_norm"] - r["cpu"]["grad_norm"])
              <= LM_GRAD_RTOL * r["cpu"]["grad_norm"], f"(d) {name}: grad norms {r['card']} "
              f"{r['cpu']}")
        for g, (err, bound) in r["grads"].items():
            check(err <= bound, f"(d) {name}: gradient of {g}: {err:.4g} over {bound:.4g}")
        check(r["param_err"] <= 2.02 * lr, f"(d) {name}: parameters {r['param_err']:.3g} apart "
              f"after the step (lr {lr:.3g})")
        reduced[name] = max(e / b for e, b in r["grads"].values())
    say(f"phase train: (d) reduced archs, one step card vs cpu: losses within {LM_CARD_TOL}, "
        f"every gradient within its bound; the largest share of its bound: " + ", ".join(
            f"{k} {v:.3f}" for k, v in reduced.items()) + f" ({time.time() - t:.1f} s)")

    # (e) the reduced deepseek: crash and resume, accum, a checkpoint card -> cpu
    t = time.time()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        res, resumed, clean = train_crash_resume(dev, tmp)
        check(res["resumed_from"] == 6, f"(e) resumed from {res['resumed_from']}, not 6")
        check(all(torch.equal(v, clean[k]) for k, v in resumed.items()),
              "(e) the resumed run's parameters differ from the uninterrupted run's")
        r = ARCHS[TRAIN_ARCH].reduced()
        cpu_m = LMModel(r, device="cpu", generator=torch.Generator().manual_seed(5))
        ocfg = opt_mod.AdamWConfig(state_dtype=torch.float32)
        got, meta = ckpt_mod.restore_latest(os.path.join(tmp, "crash"), {
            "params": cpu_m.param_tree(), "opt": opt_mod.init_state(cpu_m.param_tree(), ocfg)})
        check(meta["step"] == 10, f"(e) the latest checkpoint is step {meta['step']}")
        gp = got["params"]
        restored = {**{k: v for k, v in gp.items() if k != "blocks"},
                    **{"blocks." + k: v for k, v in gp["blocks"].items()}}
        check(set(restored) == set(resumed) and all(
            v.device.type == "cpu" and torch.equal(v, resumed[k].cpu())
            for k, v in restored.items()),
              "(e) the card's checkpoint restores on the CPU to other values")
    acc = {}
    for accum in (1, 2):
        m = LMModel(r, device=dev, generator=torch.Generator(dev).manual_seed(2))
        rng = np.random.default_rng(2)
        batch = {"tokens": torch.from_numpy(rng.integers(0, r.vocab, (4, 16)).astype(
            np.int32)).to(dev), "labels": torch.from_numpy(rng.integers(
                0, r.vocab, (4, 16)).astype(np.int32)).to(dev)}
        _, met = steps_mod.make_train_step(m, ocfg, accum=accum)(
            opt_mod.init_state(m.param_tree(), ocfg), batch)
        acc[accum] = (float(met["loss"]), [p.detach().float().cpu() for p in m.parameters()])
    check(abs(acc[1][0] - acc[2][0]) < 1e-2, f"(e) accum losses {acc[1][0]} / {acc[2][0]}")
    check(all(torch.allclose(a, b, rtol=2e-2, atol=2e-3) for a, b in zip(acc[1][1], acc[2][1])),
          "(e) accum 2 parameters outside rtol 2e-2, atol 2e-3 of accum 1's")
    say(f"phase train: (e) reduced {TRAIN_ARCH} on the card: killed at step 7, resumed from "
        f"6, bit for bit the uninterrupted run; the step-10 checkpoint restores on the CPU "
        f"equal; accum 2 vs 1: loss {acc[2][0]:.6f} / {acc[1][0]:.6f}, parameters within the "
        f"reference's bounds ({time.time() - t:.1f} s)")

    # (f) the launcher, reduced, on the card
    t = time.time()
    lout = train_launcher.main(["--arch", TRAIN_ARCH, "--steps", "4"] +
                               ([] if cuda else ["--device", "cpu"]))
    check(len(lout["history"]) == 4 and all(math.isfinite(h["loss"]) for h in lout["history"])
          and lout["params"]["embed"].device.type == dev.type, "(f) the launcher's run")
    say(f"phase train: (f) launch/train.main --arch {TRAIN_ARCH} --steps 4 on {dev}: losses "
        f"{[round(h['loss'], 4) for h in lout['history']]} ({time.time() - t:.1f} s); "
        f"phase {time.time() - t_phase:.1f} s")
    numbers = {"arch": cfg.name, "layers": cfg.n_layers, "parameters": n_params,
               "static_gb": 16 * n_params / 1e9, "peak_gb": peak_gb, "step_ms": step_ms,
               "tokens_per_s": tokens / step_ms * 1e3, "losses": losses,
               "step_ms_all": [1e3 * h["step_time_s"] for h in hist],
               "optimizer_ms": opt_ms[-1], "profiled_step_ms": prof_wall,
               "profiled_step_device_ms": dev_ms, "remat_small": remat_small,
               "remat_full": remat_full, "card_vs_cpu_loss_err": loss_err,
               "reduced_grad_share": reduced}
    return launches, numbers


def mesh_phase(smi, dev):
    """Phase mesh: the device mesh on one card.  A one-rank NCCL
    ``("data", "model")`` mesh (``launch/mesh.make_host_mesh``; one card
    holds one NCCL rank), on which every collective is the identity, so each
    check holds the mesh result to its no-mesh result bit for bit
    (``torch.equal``), each failing the run:

    (a) MESH_ARCH at full width cut to MESH_LAYERS layers, weights from a
        generator seeded 0, ``AdamWConfig``'s default bf16 moments:
        MESH_STEPS steps of MESH_BATCH rows of MESH_SEQ tokens (MESH_ACCUM
        microbatches) through ``train_loop.train`` under the mesh, then
        without (the first run's state freed first): every loss, grad norm
        and parameter equal; each run's peak memory under MESH_PEAK_GB;
        each parameter's local shard the shape ``param_shardings`` gives it;
    (b) on the second run's weights, layer 0's MoE block forward and
        backward in ``ag`` and in ``ws``, and a prefill of MESH_SERVE's rows
        and tokens with its decode steps, under the mesh and without;
    (c) MESH_DP_ARCH at full width cut to MESH_DP_LAYERS layers: one
        ``make_compressed_dp_step`` step over the one-rank ``data`` axis
        equals the plain update applied to each gradient's
        ``dequantize(quantize(g))``, and its error state is ``g32 -
        dequantize(q, scale)``;
    (d) ``launch/train.main(["--arch", MESH_ARCH, "--use-mesh", "--steps",
        "3"])`` (reduced) on the card;
    (e) dense tensor parallelism on the one-rank ``model`` axis: each dense
        weight's compute piece (``LMModel._local_params``) is its ``"tp"``
        dim over the axis size, its stored shard is ``param_shardings``'
        (the layout of (a)), and (a) and (b), bit for bit against no mesh,
        went through the sums over the model group (NCCL all-reduces,
        counted).

    Prints ms a step both ways, the peaks, the local shard shapes, the
    compressed step's ms against the plain step's and its wire bytes.
    Returns the index kernels' launches during (a) (none is on this path)
    and the phase's numbers."""
    import dataclasses as dc
    import math

    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.distributed import sharding
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LMModel
    from repro_torch.models.layers import cast_tree
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_cases import (compressed_vs_plain, mesh_train_pair, moe_block_mesh_vs_plain,
                              serve_mesh_vs_plain)

    def check(ok, msg):
        if not ok:
            fail(f"phase mesh: {msg}")

    t_phase = time.time()
    cuda = DEVICE == "cuda"
    full = get_arch(MESH_ARCH)
    cfg = full.reduced() if MESH_REDUCED else dc.replace(full, n_layers=MESH_LAYERS)
    mesh = make_host_mesh(device=dev)
    try:
        # (a) the run under the mesh and the run without, counts set to 0 first
        pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=MESH_SEQ,
                                            global_batch=MESH_BATCH))
        _build.reset_launches()
        sync()
        with tp_calls_on(mesh) as tp_calls:   # (e): the sums over the model axis
            runs = mesh_train_pair(cfg, dev, mesh, pipe.batch_at, AdamWConfig(),
                                   TrainConfig(steps=MESH_STEPS, accum=MESH_ACCUM))
        sync()
        launches = dict(_build.LAUNCHES)
        model = runs["plain"].pop("model")
        n_params = sum(p.numel() for p in model.parameters())
        hist = {k: r["history"] for k, r in runs.items()}
        for key in ("loss", "grad_norm"):
            got, want = ([h[key] for h in hist[k]] for k in ("mesh", "plain"))
            check(got == want, f"(a) {key} under the mesh {got}, without {want}")
        check(all(math.isfinite(h["loss"]) for h in hist["plain"]), "(a) a loss is not finite")
        check(runs["plain"]["differ"] == [], f"(a) parameters {runs['plain']['differ']} differ "
              "after the steps under the mesh and without")
        for k, r in runs.items():
            check(r["peak_gb"] <= MESH_PEAK_GB, f"(a) the {k} run's peak {r['peak_gb']:.2f} GB "
                  f"over {MESH_PEAK_GB}")
        layout = runs["mesh"]["layout"]
        bad = [k for k, (got, want, same) in layout.items() if got != want or not same]
        check(not bad, f"(a) local shards of {bad} off param_shardings")
        check(not any(launches.values()), f"index kernels launched on the mesh path: {launches}")
        step_ms = {k: [round(1e3 * h["step_time_s"], 1) for h in v] for k, v in hist.items()}
        overhead = step_ms["mesh"][-1] / step_ms["plain"][-1] - 1
        say(f"phase mesh: (a) {cfg.name} ({cfg.n_layers} of {full.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab}): {n_params} parameters, 12 B each with bf16 moments = "
            f"{12 * n_params / 1e9:.2f} GB; {MESH_STEPS} steps of {MESH_BATCH} x {MESH_SEQ} "
            f"tokens (accum {MESH_ACCUM}) under a one-rank {dist.get_backend().upper()} (1, 1) "
            f"mesh and without: "
            f"loss {[round(h['loss'], 6) for h in hist['mesh']]}, grad norm "
            f"{[round(h['grad_norm'], 6) for h in hist['mesh']]}, every parameter: bit for bit "
            f"equal; step ms mesh {step_ms['mesh']} / plain {step_ms['plain']} (last step's "
            f"mesh overhead {overhead:+.4f}); peak GB mesh {runs['mesh']['peak_gb']:.2f} / plain "
            f"{runs['plain']['peak_gb']:.2f} (limit {MESH_PEAK_GB}); runs "
            f"{runs['mesh']['seconds']:.1f} / {runs['plain']['seconds']:.1f} s; index kernel "
            f"launches {launches} ({smi})")
        say("phase mesh: (a) local shards == param_shardings' on every parameter: " + ", ".join(
            f"{k} {got}" for k, (got, _, _) in layout.items() if k.startswith(("blocks/moe",
                                                                                "embed"))))

        # (b) the MoE block in ag and ws, prefill and decode, on the same weights
        t = time.time()
        for p in model.parameters():
            p.grad = None
        if cuda:
            torch.cuda.empty_cache()
        x = torch.randn((1, MESH_SEQ, cfg.d_model), device=dev,
                        generator=torch.Generator(dev).manual_seed(3)).to(torch.bfloat16)
        for mode in ("ag", "ws"):
            differ = moe_block_mesh_vs_plain(model, mesh, x, mode)
            check(not differ, f"(b) the MoE block in {mode}: {differ} differ")
        B, S, n_dec = MESH_SERVE
        tokens = torch.from_numpy(np.random.default_rng(SEED + 9).integers(
            0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
        with tp_calls_on(mesh) as serve_calls:
            differ = serve_mesh_vs_plain(model, mesh, tokens, n_dec)
        check(not differ, f"(b) prefill and decode: {differ} differ")

        # (e) dense tensor parallelism on the one-rank model axis: every dense
        #     weight's compute piece is its "tp" dim over the axis size, the
        #     stored shards are param_shardings' ((a)'s layout), and (a) and
        #     (b) went through the sums over the model group on NCCL
        m_size = mesh.size(mesh.mesh_dim_names.index("model"))
        sharding.set_mesh(mesh)
        try:
            with torch.no_grad():
                pieces = model._local_params(cast_tree(model.layer(0)))
        finally:
            sharding.set_mesh(None)
        defs, split = model.layer_defs(), {}
        for k, v in pieces.items():
            pd = defs[k]
            if k.startswith("moe.") or "tp" not in pd.logical:
                continue
            want = list(pd.shape)
            want[pd.logical.index("tp")] //= m_size
            split[k] = (tuple(v.shape), tuple(want))
        bad = [k for k, (got, want) in split.items() if got != want]
        check(split and not bad, f"(e) compute pieces of {bad} off their tp split")
        dense = {k: v for k, v in layout.items() if k.startswith(("blocks/attn", "embed",
                                                                    "lm_head"))}
        check(all(got == want and same for got, want, same in dense.values()),
              f"(e) dense shards off param_shardings: {dense}")
        check(tp_calls["n"] > 0 and serve_calls["n"] > 0,
              f"(e) no sum over the model group: (a) {tp_calls['n']}, (b) {serve_calls['n']}")
        say(f"phase mesh: (e) dense tensor parallelism over the one-rank model axis (m = "
            f"{m_size}): compute pieces {split}; dense shards == param_shardings; all-reduces "
            f"on the {dist.get_backend().upper()} model group: (a) {tp_calls['n']}, (b) "
            f"{serve_calls['n']}, every (a)/(b) result bit for bit against no mesh")
        del model, x
        if cuda:
            torch.cuda.empty_cache()
        say(f"phase mesh: (b) layer 0's MoE block ({MESH_SEQ} tokens) forward and backward in "
            f"ag and ws, a prefill of {B} x {S} tokens and {n_dec} decode steps: bit for bit "
            f"equal under the mesh and without ({time.time() - t:.1f} s)")

        # (c) the compressed data-parallel step against the plain update
        t = time.time()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        dfull = get_arch(MESH_DP_ARCH)
        dcfg = dfull.reduced() if MESH_REDUCED else dc.replace(dfull, n_layers=MESH_DP_LAYERS)
        dmodel = LMModel(dcfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
        dp_params = sum(p.numel() for p in dmodel.parameters())
        row = {k: torch.from_numpy(v[:1]).to(dev) for k, v in TokenPipeline(PipelineConfig(
            vocab=dcfg.vocab, seq_len=MESH_SEQ, global_batch=1)).batch_at(0).items()}
        res = compressed_vs_plain(dmodel, mesh, row, AdamWConfig())
        check(res["params_differ"] == [], f"(c) parameters {res['params_differ']} differ")
        check(res["err_differ"] == [], f"(c) error state {res['err_differ']} differs")
        check(res["compressed"]["loss"] == res["plain"]["loss"]
              and res["compressed"]["grad_norm"] == res["plain"]["grad_norm"],
              f"(c) metrics {res['compressed']} against {res['plain']}")
        from repro_torch.distributed.compression import init_error_state, make_compressed_dp_step
        from repro_torch.train import optimizer as opt_mod

        ocfg = AdamWConfig()
        tree = dmodel.param_tree()
        state, err = opt_mod.init_state(tree, ocfg), init_error_state(tree)
        comp_step = make_compressed_dp_step(dmodel, ocfg, mesh)
        plain_step = steps_mod.make_train_step(dmodel, ocfg)
        dp_ms = {"compressed": [], "plain": []}
        for _ in range(2):
            for name in ("plain", "compressed"):
                sync()
                t0 = time.perf_counter()
                if name == "plain":
                    state, _ = plain_step(state, row)
                else:
                    state, err, _ = comp_step(state, err, row)
                sync()
                dp_ms[name].append(round((time.perf_counter() - t0) * 1e3, 1))
        peak_dp = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        del dmodel, tree, state, err, comp_step, plain_step
        if cuda:
            torch.cuda.empty_cache()
        say(f"phase mesh: (c) {dcfg.name} ({dcfg.n_layers} layers at full width, {dp_params} "
            f"parameters): make_compressed_dp_step over the one-rank data axis == the plain "
            f"update on dequantize(quantize(g)), and its error state == g32 - dequantize(q, "
            f"scale), bit for bit; loss {res['compressed']['loss']:.6f}; ms a step (plain, "
            f"compressed, twice in turns) plain {dp_ms['plain']} / compressed "
            f"{dp_ms['compressed']}; wire bytes a step {res['wire_bytes']} against float32's "
            f"{res['float32_bytes']} ({res['float32_bytes'] / res['wire_bytes']:.3f}x less); "
            f"peak {peak_dp:.2f} GB ({smi}; {time.time() - t:.1f} s)")

        # (d) the launcher under the mesh, reduced, on the card
        t = time.time()
        lout = train_launcher.main(["--arch", MESH_ARCH, "--use-mesh", "--steps", "3"] +
                                   ([] if cuda else ["--device", "cpu"]))
        losses = [h["loss"] for h in lout["history"]]
        check(len(losses) == 3 and all(math.isfinite(x) for x in losses)
              and lout["params"]["embed"].device.type == dev.type, "(d) the launcher's run")
        say(f"phase mesh: (d) launch/train.main --arch {MESH_ARCH} --use-mesh --steps 3 on "
            f"{dev}: losses {[round(x, 4) for x in losses]} ({time.time() - t:.1f} s); phase "
            f"{time.time() - t_phase:.1f} s")
    finally:
        dist.destroy_process_group()
    numbers = {"arch": cfg.name, "layers": cfg.n_layers, "parameters": n_params,
               "step_ms": step_ms, "mesh_overhead": overhead,
               "peak_gb": {k: r["peak_gb"] for k, r in runs.items()},
               "losses": [h["loss"] for h in hist["mesh"]],
               "dp_arch": dcfg.name, "dp_layers": dcfg.n_layers, "dp_parameters": dp_params,
               "dp_ms": dp_ms, "dp_peak_gb": peak_dp, "dp_wire_bytes": res["wire_bytes"],
               "dp_float32_bytes": res["float32_bytes"]}
    return launches, numbers


DRYRUN_SCRIPT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.launch.dryrun import run_config
from repro_torch.train.optimizer import AdamWConfig

arch, layers, seq, batch, accum = sys.argv[1], *map(int, sys.argv[2:6])
cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
rec = run_config(cfg, ShapeSpec("phase_train", seq, batch, "train"), mesh_shape=(1, 1),
                 param_dtype=torch.float32, opt_cfg=AdamWConfig(state_dtype=torch.float32),
                 accum=accum)
print(json.dumps(rec))
"""


def dryrun_phase(train_numbers, smi) -> dict:
    """Phase dryrun: the dry-run and roofline tools on the card's host, on
    the CPU over torch's fake process group (no card involved: the
    subprocesses see none), all started together, each failing the run if
    it fails or writes a record with an error:

    * ``python -m repro_torch.launch.dryrun --arch DRYRUN_ARCH --shape S`` for
      each S of DRYRUN_SHAPES on the (16, 16) mesh, and ``python -m
      repro_torch.launch.dryrun_index`` at its defaults; their records under
      ``build/dryrun``, tabulated by ``launch/roofline``;
    * the dry-run of phase train's own configuration (TRAIN_ARCH cut to
      TRAIN_LAYERS layers, TRAIN_BATCH rows of TRAIN_SEQ tokens, accum
      TRAIN_ACCUM, float32 parameters and moments) on a (1, 1) mesh: its
      predicted memory a device beside phase train's measured peak, and
      ``launch/roofline``'s analytic compute term for that step (its FLOPs
      over the H100's published 989 TFLOP/s bf16) beside phase train's
      measured step time, as a share.

    Returns the phase's numbers."""
    import dataclasses as dc

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import roofline

    t = time.time()
    out_dir = os.path.join(ROOT, "build", "dryrun")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    cmds = {s: [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
                "--shape", s, "--out", out_dir] for s in DRYRUN_SHAPES}
    cmds["index"] = [sys.executable, "-m", "repro_torch.launch.dryrun_index", "--out", out_dir]
    cmds["phase train"] = [sys.executable, "-c", DRYRUN_SCRIPT, TRAIN_ARCH, str(TRAIN_LAYERS),
                           str(TRAIN_SEQ), str(TRAIN_BATCH), str(TRAIN_ACCUM)]
    procs = {k: subprocess.Popen(c, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
    outs = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=max(DRYRUN_TIMEOUT - (time.time() - t), 1))
            if p.returncode != 0:
                fail(f"phase dryrun: {k} exited {p.returncode}: {stderr[-2000:]}")
            outs[k] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    recs = roofline.load_all(out_dir)
    bad = [r for r in recs if "error" in r or "skip" in r]
    if bad or len(recs) != len(DRYRUN_SHAPES) + 1:
        fail(f"phase dryrun: {len(recs)} records, {len(bad)} failed or skipped: "
             f"{[r.get('error', r.get('skip'))[:300] for r in bad]}")
    say(f"phase dryrun: {DRYRUN_ARCH} {', '.join(DRYRUN_SHAPES)} on (16, 16) and the LITS "
        f"query service, on the host CPU over the fake process group (analytic terms on the "
        f"published peaks of an H100 SXM at 700 W):")
    for line in roofline.table(recs).splitlines():
        say("phase dryrun: " + line)
    own = json.loads(outs["phase train"].strip().splitlines()[-1])
    if "error" in own:
        fail(f"phase dryrun: phase train's configuration: {own['error'][:300]}")
    cfg = dc.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    shape = ShapeSpec("phase_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    compute_s = roofline.analytic_flops(cfg, shape) / roofline.PEAK_FLOPS
    predicted_gb = own["memory"]["total_per_device"] / 1e9
    measured_ms = train_numbers["step_ms"] if train_numbers else None
    share = compute_s * 1e3 / measured_ms if measured_ms else None
    say(f"phase dryrun: phase train's configuration ({TRAIN_ARCH}, {TRAIN_LAYERS} layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, accum {TRAIN_ACCUM}, float32 parameters and "
        f"moments) on a (1, 1) mesh: predicted {predicted_gb:.2f} GB a device (arguments "
        f"{own['memory']['argument_size_in_bytes'] / 1e9:.2f} GB + temporaries "
        f"{own['memory']['temp_size_in_bytes'] / 1e9:.2f} GB) against phase train's measured "
        f"peak {train_numbers['peak_gb'] if train_numbers else float('nan'):.2f} GB; analytic "
        f"compute term {compute_s * 1e3:.1f} ms ({roofline.analytic_flops(cfg, shape) / 1e12:.1f} "
        f"TFLOP at {roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s) against the measured step "
        f"{measured_ms if measured_ms else float('nan'):.1f} ms: share "
        f"{share if share else float('nan'):.4f} ({smi}; phase {time.time() - t:.1f} s)")
    return {"records": {r["shape"]: {k: r[k] for k in ("memory", "collectives", "roofline",
                                                       "dominant")} for r in recs},
            "phase_train_predicted_gb": predicted_gb,
            "phase_train_measured_peak_gb": train_numbers["peak_gb"] if train_numbers else None,
            "phase_train_compute_s": compute_s, "phase_train_step_ms": measured_ms,
            "roofline_share": share, "seconds": time.time() - t}


@contextlib.contextmanager
def tp_calls_on(mesh):
    """Count the ``torch.distributed.all_reduce`` calls made on ``mesh``'s
    model group inside the block: ``{"n": count}``."""
    import torch.distributed as dist

    group, real, got = mesh.get_group("model"), dist.all_reduce, {"n": 0}

    def counted(t, *a, **kw):
        if kw.get("group") is group:
            got["n"] += 1
        return real(t, *a, **kw)

    dist.all_reduce = counted
    try:
        yield got
    finally:
        dist.all_reduce = real


def free_port() -> int:
    """A free TCP port on the loopback address."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    occupancy_jobs = start_occupancy_builds()
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
    # 9e. the distributed index: CDF-range shards, routed lookups and scans
    if parent:
        say("phase distributed: skipped (--parent: the package predates the distributed index)")
        dist_launches, dist_numbers = no_launches, None
    else:
        dist_launches, dist_numbers = distributed_phase(keys, values, batches, smi, dev)

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
    walk = {}  # the plain walk's terminal items (an older package's walk takes no trace)
    results["fused_search"] = (got, traverse.fused_search_plain(
        ti, qb, ql, **({} if parent else {"trace": walk})))
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

    # the compact leaves the main batch reaches: how often, how many live
    # slots, how many false 16-bit matches (K4's probe reads, counted in its
    # bound below); K3 past one pass of 16 slots and on a tile 4 bytes past
    # a 16-byte boundary; K4 over an index whose compact leaves hold equal
    # codes (tests/_torch_cases.py), checked only
    probe = None
    if not parent:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from _torch_cases import cnode_probe_stats, collision_keys, probe_tile

        probe = cnode_probe_stats(ti, qb, ql, walk["item"], *results["fused_search"][1][:2])
        say(f"phase probe: of the main batch's {B} queries {probe['at_cnode']} end at a compact "
            f"leaf ({probe['at_cnode'] / B:.4f}); their probes scan {probe['live']} live slots "
            f"({probe['live'] / max(probe['at_cnode'], 1):.2f} a query), meet {probe['met']} of "
            f"{probe['matches']} 16-bit hash matches, {probe['false']} of them false")
        for k, shift in ((16, 1), (17, 0), (33, 1), (64, 0)):  # own streams: `rng` stays as it was
            tile = [torch.from_numpy(a).to(dev)
                    for a in probe_tile(np.random.default_rng(SEED + 7 + k), B + 37, k)]
            if shift:  # a contiguous tile 4 bytes past a 16-byte boundary: scalar loads
                tile[0] = torch.cat([tile[0].new_zeros(1), tile[0].flatten()])[1:].view(B + 37, k)
            results[f"cnode_probe, K = {k}{', shifted 4 bytes' if shift else ''}"] = (
                (cnode_probe.cnode_probe_cuda(*tile),), (cnode_probe.cnode_probe_plain(*tile),))
        ckeys, cabsent = collision_keys(SEED, N_COLLIDE)
        cbuild = LITSBuilder(device=DEVICE)
        cbuild.bulkload(StringSet.from_list(ckeys))
        cti = freeze(cbuild)
        cqb, cql = (torch.from_numpy(a).to(dev) for a in pad_queries(ckeys + cabsent, cti.width))
        cwalk = {}
        cwant = traverse.fused_search_plain(cti, cqb, cql, trace=cwalk)
        cst = cnode_probe_stats(cti, cqb, cql, cwalk["item"], *cwant[:2])
        behind = int((cst["q_false"][cwant[0][cst["at"]]] > 0).sum())
        absent_m = cst["q_matches"][~cwant[0][cst["at"]]]
        say(f"phase probe: collision index of {len(ckeys)} keys and {len(cabsent)} never stored: "
            f"{behind} stored keys found behind a false match, {int((absent_m == 1).sum())} "
            f"never-stored keys meet one hash match and {int((absent_m >= 2).sum())} several")
        if not behind or not (absent_m == 1).any() or not (absent_m >= 2).any():
            fail("the collision index does not exercise the probe's false matches")
        results["fused_search, compact leaves with equal codes"] = (
            traverse.fused_search_cuda(cti, cqb, cql), cwant)
    else:
        say("phase probe: skipped (--parent: the package predates the walk's trace)")

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
        # (at most the item pool once), key bytes + entry record of each hit;
        # the model nodes' HPT and node reads are not counted
        "fused_search": B * (W + 4) + 12 * B
        + 4 * min(int(levels.sum()), ti.items.shape[0])
        + int((ql[hit].long() + 8).sum()),
    }
    if probe is not None:
        # the probe: (cn_base, cn_cnt) of each compact leaf reached, its live
        # codes, the ch_ent word of each hash match met and the entry record
        # of each false one (a hit's is counted above)
        nbytes["fused_search"] += (8 * probe["at_cnode"] + 4 * probe["live"]
                                   + 4 * probe["met"] + 8 * probe["false"])
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
                   "execute": exec_launches[k], "service": svc_launches[k],
                   "distributed": dist_launches[k]} for k in launches}
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
        if dist_numbers is not None and name in dist_numbers["times"]:
            rows[-1]["distributed"] = dist_numbers["times"][name]
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
    # K4's and K3's registers, shared memory and blocks an SM holds, from the
    # card (K4 at this width's stage); K3 on a random tile
    for name, r in occupancy(occupancy_jobs, W).items():
        next(row for row in rows if row["name"] == name)["resources"] = r
        say(f"phase times: {name}: {r}")
    tile_ms = probe_tile_ms(dev)
    next(r for r in rows if r["name"] == "cnode_probe")["random_tile_ms"] = tile_ms
    say(f"phase times: cnode_probe on a random ({B}, 16) tile {tile_ms:.4f} ms")
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

    # 16. the LM serving path at full width, last: it frees its model
    if parent:
        say("phase lm: skipped (--parent: the package predates the LM serving path)")
    else:
        lm_launches, lm_numbers = lm_phase(smi, dev)
        for r in rows:
            r["launches_by_path"]["lm"] = lm_launches[r["name"]]
        next(r for r in rows if r["name"] == "fused_search")["lm"] = lm_numbers

    # 17. LM training at full width, after phase lm has freed its model
    if parent:
        say("phase train: skipped (--parent: the package predates LM training)")
    else:
        train_launches, train_numbers = train_phase(smi, dev)
        for r in rows:
            r["launches_by_path"]["train"] = train_launches[r["name"]]
        say("phase train: numbers " + json.dumps(train_numbers))

    # 18. the device mesh on one card, after phase train has freed its model
    if parent:
        say("phase mesh: skipped (--parent: the package predates the mesh)")
    else:
        mesh_launches, mesh_numbers = mesh_phase(smi, dev)
        for r in rows:
            r["launches_by_path"]["mesh"] = mesh_launches[r["name"]]
        say("phase mesh: numbers " + json.dumps(mesh_numbers))

    # 19. the dry-run and roofline tools, on the host CPU: no kernel, no card
    if parent:
        say("phase dryrun: skipped (--parent: the package predates the dry-run)")
    else:
        say("phase dryrun: numbers " + json.dumps(dryrun_phase(train_numbers, smi)))
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
                         "underflow rows, the probe, execute, the service, snapshots, "
                         "wide rows, the distributed index, the LM serving path, LM "
                         "training, the mesh and the dry-run")
    sys.exit(main(ap.parse_args().parent))
