"""One run of one cell: keys and traffic from the seed, the bulk load, the
warm-up, a measured window, the optional traced sub-window, the check
against the reference, and the result line.

The program is ``repro_torch`` (from the checkout's ``src/``), reached only
through ``StringIndex.bulk_load``, ``get_batch``, ``execute``, ``nbytes``,
``width`` and ``merge_count``.  Everything the run measures goes into one
plain dict, ``run``, from which each metric's reader takes its number.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import keysets, reference, trace, traffic
from .spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level module names


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Stream:
    """The op stream: the block's batches in turn, inserts taking the
    never-stored keys in order.  ``next()`` is None once the pool cannot
    give a batch its inserts."""

    def __init__(self, block: traffic.Block, n_pool: int):
        self.block, self.n_pool = block, n_pool
        self.i = 0
        self.inserted = 0

    def next(self) -> Optional[tuple]:
        b = self.i % self.block.n_batches
        kind = self.block.kind[b]
        n_ins = int((kind == traffic.INSERT).sum())
        if self.inserted + n_ins > self.n_pool:
            return None
        ids = np.arange(self.inserted, self.inserted + n_ins)
        self.inserted += n_ins
        self.i += 1
        return kind, self.block.key[b], self.block.value[b], self.block.length[b], ids


class Program:
    """Turns a batch of op arrays into the entry point's call and its
    answers into plain data for the judge."""

    def __init__(self, index, entry: str, stored: List[bytes], pool: List[bytes]):
        import torch

        from repro_torch.index import GetRequest, PutRequest, ScanRequest

        self.index, self.entry = index, entry
        self.stored, self.pool = stored, pool
        self.req = {traffic.READ: GetRequest, traffic.SCAN: ScanRequest,
                    traffic.UPDATE: PutRequest, traffic.INSERT: PutRequest}
        self.span = torch.profiler.record_function
        if entry not in ("get_batch", "execute"):
            raise ValueError(f"unknown entry point {entry!r}")

    def build(self, batch) -> list:
        kind, key, value, length, ids = batch
        keys = [self.stored[k] for k in key.tolist()]
        if self.entry == "get_batch":
            return keys
        pool_at = iter(ids.tolist())
        out = []
        for k, kd, v, n in zip(keys, kind.tolist(), value.tolist(), length.tolist()):
            if kd == traffic.READ:
                out.append(self.req[kd](k))
            elif kd == traffic.SCAN:
                out.append(self.req[kd](k, n))
            elif kd == traffic.UPDATE:
                out.append(self.req[kd](k, v))
            else:
                out.append(self.req[kd](self.pool[next(pool_at)], v))
        return out

    def call(self, args):
        with self.span(f"facade.{self.entry}"):
            return getattr(self.index, self.entry)(args)

    def merged(self, out) -> bool:
        return bool(getattr(out, "merged", False))

    def keep(self, out):
        """The answers of one call as the judge reads them: ``(found,
        values)`` arrays for ``get_batch``; for ``execute``, one ``(status,
        value, updated, entries)`` tuple an op.  The program's result
        objects are dropped; what is kept is tuples of strings, numbers and
        the program's own tuples of scanned entries, which the garbage
        collector stops tracking at its first pass over them, so that
        keeping every batch's answers for the check leaves the program's
        own collections as they would be where each answer is sent off."""
        if self.entry == "get_batch":
            return out
        return [(r.status.name, r.value, r.updated, r.entries) for r in out.results]


def run_cell(argv, *, root: Path, device: str = "cuda", t_start: Optional[float] = None,
             spec: Optional[Spec] = None, src: Optional[Path] = None,
             check_imports: bool = True) -> int:
    """Run the cell ``argv`` names; print the result line.  Returns the
    exit code.  ``device="cpu"`` skips the look for a card, ``spec`` and
    ``src`` stand for the checkout's files, and ``check_imports=False``
    skips the look for JAX in ``sys.modules`` (tests only: a test process
    imports JAX for other tests)."""
    t_start = time.time() if t_start is None else t_start
    args = parse(argv)
    spec = spec or Spec(root)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    import torch

    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= int(cell["chips"])):
        say(f"needs {cell['chips']} CUDA device(s): torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    src = Path(root) / "src" if src is None else Path(src)
    if not (src / "repro_torch").is_dir():
        say(f"the program is not in this checkout: no {src / 'repro_torch'}")
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.index import IndexConfig, StringIndex
    if device == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    t_imports = time.time()

    seed = args.seed % 2 ** 64
    keys = keysets.config_keys(cfg)
    rng = np.random.default_rng([seed, 0])
    stored, pool = sorted(keys[: cfg["n_stored"]]), keys[cfg["n_stored"]:]
    values = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, len(stored),
                          dtype=np.int64, endpoint=True)
    block = traffic.draw_block(mix, len(stored), np.random.default_rng([seed, 1]))
    t_keys = time.time()

    index = StringIndex.bulk_load(stored, values,
                                  IndexConfig(**cfg["index_config"], device=device))
    if device == "cuda":
        torch.cuda.synchronize()
    t_load = time.time()

    prog = Program(index, mix["entry"], stored, pool)
    stream = Stream(block, len(pool))
    batches: List[tuple] = []     # every batch run, in order, for the reference
    answers: List[object] = []    # the program's answers to each, as kept

    def step():
        b = stream.next()
        if b is None:
            return None
        t0 = time.perf_counter()
        reqs = prog.build(b)
        t1 = time.perf_counter()
        out = prog.call(reqs)
        t2 = time.perf_counter()
        batches.append(b)
        answers.append(prog.keep(out))
        return {"ops": len(b[0]), "t0": t0, "t_call": t1, "t1": t2,
                "t_kept": time.perf_counter(), "merged": prog.merged(out),
                "peak": torch.cuda.max_memory_allocated() if device == "cuda" else 0}

    warm = mix.get("warmup", {})
    n_warm = 0
    while n_warm < int(warm.get("batches", 1)) or (
            warm.get("until_merge") and index.merge_count == 0
            and n_warm < int(warm.get("max_batches", 256))):
        if step() is None:
            break
        n_warm += 1
    if warm.get("until_merge") and index.merge_count == 0:
        say("warm-up ended without a merge")
        return 1
    if device == "cuda":
        torch.cuda.synchronize()
    judged_from = len(batches)    # the batches before are warm-up
    t_first = time.time()
    setup = {"setup_s": t_first - t_start, "imports_s": t_imports - t_start,
             "keys_s": t_keys - t_imports, "bulk_load_s": t_load - t_keys,
             "warmup_s": t_first - t_load, "warmup_batches": n_warm,
             "merges_in_warmup": index.merge_count}

    # the measured window: closed loop, one batch after the other, for
    # --seconds; a mix that merges (its warm-up runs until the first merge)
    # then runs on to the end of the merge cycle in progress, so that every
    # window holds whole cycles (a cycle is at most the warm-up's max_batches)
    on_merge = bool(warm.get("until_merge"))
    window: List[dict] = []
    late = 0
    w0 = time.perf_counter()
    while True:
        rec = step()
        if rec is None:
            say("the traffic ran out of never-stored keys: the window ends early")
            break
        window.append(rec)
        if time.perf_counter() - w0 >= args.seconds:
            late += 1
            if not on_merge or rec["merged"] or late >= int(warm.get("max_batches", 256)):
                break
    w1 = time.perf_counter()
    if on_merge and window and not window[-1]["merged"]:
        say("the window ended before a merge")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    run: Dict = {"cell": args.workload, "seed": args.seed, "trace": bool(args.trace),
                 "memory_batches": mix.get("memory_batches"),
                 "width": index.width, "index_bytes": index.nbytes(),
                 "setup": setup, "peak_bytes": peak, "profile": None,
                 "window": {"seconds": w1 - w0, "ops": sum(r["ops"] for r in window),
                            "batches": window, "merges": index.merge_count
                            - setup["merges_in_warmup"]}}
    if args.trace:
        run["profile"] = profile_batches(prog, step, int(mix.get("trace_batches", 2)),
                                         batches, device)
    bad = forbidden_modules() if check_imports else []
    if bad:
        say(f"forbidden modules loaded in this process: {bad}")
        return 3

    # the program's state goes before the reference runs
    if run["profile"] is not None:
        run["profile"]["answers"] = answers[-len(run["profile"]["batches"]):]
    del prog, index
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.time()
    counts, attempted, failed = check(stored, values, pool, mix["entry"], batches, answers,
                                      judged_from)
    say(f"reference: {len(batches)} batches replayed, {len(batches) - judged_from} judged, "
        f"{time.time() - t_ref:.1f} s")

    metrics = {}
    for m in spec.metrics(args.workload, bool(args.trace)):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    say(describe(run, stream))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if device == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": all(v == 0 for v in counts.values()), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    prof = run["profile"]
    if prof is not None and prof.get("window_s"):
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        result["breakdown"] = {"device_ops": trace.top(prof["device_ops"]),
                               "idle_gaps": trace.top(prof["idle_gaps"])}
    result["check"] = {k: {"value": v, "limit": 0} for k, v in counts.items()}
    for k, v in counts.items():
        say(f"check {k} {v} limit 0")
    print(json.dumps(result), flush=True)
    return 0


def profile_batches(prog, step, n: int, batches, device) -> Optional[dict]:
    """Run ``n`` more batches under the profiler and reduce its record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    first = len(batches)
    if device == "cuda":
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            recs = [r for r in (step() for _ in range(n)) if r is not None]
            if device == "cuda":
                torch.cuda.synchronize()
    red = trace.reduce_profile(prof.events()) or {}
    red["ops"] = sum(r["ops"] for r in recs)
    red["batches"] = batches[first:]
    red["entry"] = prog.entry
    red["key_lens"] = [np.array([len(prog.stored[k]) for k in b[1].tolist()])
                       for b in batches[first:]]
    return red


def check(stored, values, pool, entry, batches, answers, judged_from):
    """Replay every batch on the reference; judge the answers of those from
    ``judged_from`` on.  Returns (counts, ops judged, ops refused)."""
    ref = reference.Reference(stored, values, pool)
    counts = reference.new_counts()
    attempted = failed = 0
    for i, (b, got) in enumerate(zip(batches, answers)):
        kind, key, value, length, ids = b
        refused = None
        if entry == "execute":
            refused = np.array([g[0] in reference.REFUSALS for g in got])
        exp = ref.batch(kind, key, value, length, ids, refused)
        if i < judged_from:
            continue
        attempted += len(kind)
        if entry == "get_batch":
            reference.judge_gets(exp, *got, counts)
        else:
            failed += int(refused.sum())
            reference.judge_execute(ref, exp, got, counts)
    return counts, attempted, failed


def describe(run: Dict, stream: Stream) -> str:
    w, s = run["window"], run["setup"]
    calls = [b["t1"] - b["t_call"] for b in w["batches"]]
    build = [b["t_call"] - b["t0"] for b in w["batches"]]
    keep = [b["t_kept"] - b["t1"] for b in w["batches"]]
    return (f"cell {run['cell']} seed {run['seed']}: set-up {s['setup_s']:.3f} s (imports "
            f"{s['imports_s']:.3f}, keys {s['keys_s']:.3f}, bulk load {s['bulk_load_s']:.3f}, "
            f"warm-up {s['warmup_s']:.3f} over {s['warmup_batches']} batches, "
            f"{s['merges_in_warmup']} merges); window {w['seconds']:.3f} s, "
            f"{len(w['batches'])} batches, {w['ops']} ops, {w['merges']} merges, "
            f"{sum(b['merged'] for b in w['batches'])} merged batches; in calls "
            f"{sum(calls):.3f} s, building requests {sum(build):.3f} s, keeping answers "
            f"{sum(keep):.3f} s; index "
            f"{run['index_bytes']} bytes, width {run['width']}; peak {run['peak_bytes']} "
            f"bytes; {stream.inserted} inserts in all")
