#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``repro_torch``, never ``repro`` or JAX) at a
real size: bulk load of 1,000,000 synthetic URLs on the card, then batched
point lookups of 65,536 queries.  It builds every CUDA kernel from
``src/repro_torch/kernels/csrc``, holds each against its plain PyTorch
version on the same inputs (exact equality), checks that the main path went
through the kernels, that the card-built and CPU-built pools are equal, and
that every lookup answers right, then times each kernel.  It exits non-zero
on any failure, and when there is no CUDA device.

Output: one line per phase, then a JSON line of per-kernel numbers, then
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_KEYS = 1_000_000          # stored keys (url)
N_EXTRA = 250_000           # never-stored keys from the same generator
BATCH = 65_536              # queries per get_batch
N_SUBSET = 100_000          # keys of the cuda-vs-cpu structure check
SEED = 0
DEVICE = "cuda"
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
}


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


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


def max_abs_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.builder import LITSBuilder
    from repro_torch.core.strings import StringSet
    from repro_torch.core.tensor_index import (
        DATA_FIELDS, _delta_lookup, freeze, lookup_values, pad_queries)
    from repro_torch.data import synthetic
    from repro_torch.index import IndexConfig, StringIndex
    from repro_torch.kernels import _build, cnode_probe, hpt_cdf, hpt_locate, traverse
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

    # 2. build
    t = time.time()
    _build.build_all()
    say(f"phase build: {len(_build.SOURCES)} libraries in {time.time() - t:.1f} s")

    # 3. data
    t = time.time()
    rng = np.random.default_rng(SEED)
    pool = synthetic.load("url", N_KEYS + N_EXTRA, seed=SEED)
    perm = rng.permutation(len(pool))
    keys = [pool[i] for i in perm[:N_KEYS]]
    absent = [pool[i] for i in perm[N_KEYS:]]
    values = rng.integers(-(1 << 62), 1 << 62, N_KEYS, dtype=np.int64)
    say(f"phase data: url {len(keys)} stored + {len(absent)} never stored keys "
        f"in {time.time() - t:.1f} s")

    # 4. main path: bulk load, then get_batch; launch counts around it
    stored = set(keys)
    _build.reset_launches()
    torch.cuda.synchronize()
    t = time.time()
    index = StringIndex.bulk_load(keys, values, IndexConfig(device=DEVICE))
    torch.cuda.synchronize()
    build_s = time.time() - t
    ti = index.ti
    W = ti.width
    order = rng.permutation(N_KEYS)
    n_stored, n_absent = BATCH // 2, BATCH // 4
    n_prefix = BATCH - n_stored - n_absent
    batches, answers = [], []
    for b in range(0, N_KEYS, n_stored):
        q = [keys[i] for i in order[b: b + n_stored]]
        q += [absent[(b // 2 + j) % len(absent)] for j in range(n_absent)]
        src = [keys[i] for i in rng.integers(0, N_KEYS, n_prefix)]
        q += [k[: max(1, len(k) // 2)] for k in src[: n_prefix // 2]]
        q += [k + b"/" * (W + 1 - len(k) + j % 7) for j, k in enumerate(src[n_prefix // 2:])]
        batches.append(q)
    t = time.time()
    for q in batches:
        answers.append(index.get_batch(q))
    torch.cuda.synchronize()
    get_s = time.time() - t
    main_launches = dict(_build.LAUNCHES)
    n_lookups = sum(len(q) for q in batches)
    pool_bytes = ti.nbytes()
    say(f"phase main: bulk_load {build_s:.2f} s, width {W}, max_iters {ti.max_iters}, "
        f"cdf_steps {ti.cdf_steps}, pools {pool_bytes} bytes; get_batch {n_lookups} lookups "
        f"in {len(batches)} batches of {BATCH}: {get_s:.2f} s = "
        f"{n_lookups / get_s:.0f} lookups/s; launches {main_launches}")
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
    say(f"stored_keys_missed={len(missed)} (of {N_KEYS})")
    say(f"phase truth: wrong values {wrong}, hits on keys never stored {false_hits}")
    if wrong or false_hits:
        fail("lookups answered wrong")

    # 6. each kernel against its plain version at main-path shapes
    qb_np, ql_np = pad_queries(batches[0], W)
    qb, ql = torch.from_numpy(qb_np).to(dev), torch.from_numpy(ql_np).to(dev)
    B = qb.shape[0]
    results, inputs = {}, {}
    got = traverse.fused_search_cuda(ti, qb, ql)
    want = traverse.fused_search_plain(ti, qb, ql)
    results["fused_search"] = (got, want)
    inputs["fused_search"] = ((ti, qb, ql), traverse.fused_search_cuda,
                              traverse.fused_search_plain)

    steps = min(64, W)  # the builder's GetCDF walk (MAX_CDF_STEPS)
    start = torch.from_numpy(rng.integers(0, 8, B).astype(np.int32)).to(dev)
    args = (qb, ql, start, ti.cdf_tab, ti.prob_tab, steps)
    results["hpt_cdf"] = ((hpt_cdf.hpt_cdf_cuda(*args),), (hpt_cdf.hpt_cdf_plain(*args),))
    inputs["hpt_cdf"] = (args, hpt_cdf.hpt_cdf_cuda, hpt_cdf.hpt_cdf_plain)

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
    torch.cuda.synchronize()
    for name, (g, w) in results.items():
        same = all(torch.equal(a, b) for a, b in zip(g, w))
        say(f"phase kernels: {name} kernel == plain on {B} rows: {same}")
        if not same:
            fail(f"{name} differs from its plain version")

    # 7. structure: the card's build (K1/K2) equals the CPU's (plain), array for array
    sub = [keys[i] for i in np.sort(rng.choice(N_KEYS, N_SUBSET, replace=False))]
    ss = StringSet.from_list(sub)
    t = time.time()
    bg = LITSBuilder(device=DEVICE)
    model_s = [0.0]  # time inside the model-value and slot-position calls

    def timed(fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            model_s[0] += time.perf_counter() - t0
            return out
        return call

    bg._values, bg._positions = timed(bg._values), timed(bg._positions)
    bg.bulkload(ss, values[:N_SUBSET])
    tg_s = time.time() - t
    t = time.time()
    bc = LITSBuilder(device="cpu")
    bc.bulkload(ss, values[:N_SUBSET])
    tc_s = time.time() - t
    fg, fc = freeze(bg), freeze(bc)
    diff = [f for f in DATA_FIELDS if not torch.equal(getattr(fg, f).cpu(), getattr(fc, f))]
    say(f"phase structure: {N_SUBSET} keys built on cuda ({tg_s:.1f} s, of which "
        f"{model_s[0]:.2f} s in _values/_positions: K2/K1 with their copies) and cpu "
        f"({tc_s:.1f} s): pools differ in {diff or 'no field'}")
    if diff or bg.root_item != bc.root_item:
        fail(f"cuda and cpu builds differ: {diff}")

    # 8. times at main-path shapes
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
    nbytes["hpt_cdf"] = B * (W + 12) + min(8 * n_steps, table_bytes)
    nbytes["hpt_locate"] = B * (W + 24) + min(8 * n_steps, table_bytes)
    nbytes["cnode_probe"] = B * (K * 4 + 16)
    flops = {"fused_search": 0.0, "hpt_cdf": 3.0 * n_steps,
             "hpt_locate": 3.0 * n_steps + 2.0 * B, "cnode_probe": 0.0}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        args, kern, plain = inputs[name]
        ms = time_cuda(lambda: kern(*args), reps=50)
        plain_ms = time_cuda(lambda: plain(*args), reps=3, warmup=1)
        b_ms, b_by = bound_ms(nbytes[name], flops[name])
        g, w = results[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": main_launches[name], "max_abs_err": max_abs_err(g, w),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        say(f"phase times: {name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms "
            f"by {b_by}, {nbytes[name]} bytes), main-path launches {main_launches[name]}")
    if main_launches["cnode_probe"] == 0:
        say("phase times: cnode_probe runs inline in every fused_search launch "
            f"({main_launches['fused_search']} on the main path); its own entry is "
            "launched only here, against its plain version")

    # 9. where one get_batch's time goes: each stage alone, a sync after it
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
    sys.exit(main())
