"""Dry-run for the distributed LITS query service on the production mesh:
the port of :mod:`repro.launch.dryrun_index`.

Topology: the index is CDF-range-partitioned 16 ways over ``data`` and
replicated across ``model`` (and ``pod``): each model column is a full
serving replica; queries are row-sharded over every mesh axis.  One step =
route (all_to_all over data) -> local LITS search -> return (all_to_all).

The index is built for real on the CPU (``build_sharded``), then one routed
lookup of rank 0 runs over torch's fake process group of 256 or 512 ranks
(``dryrun.fake_process_group``): rank 0 holds its shard and its
``q_per_device`` query rows (keys drawn like the index's), and every
collective is issued and counted but moves nothing, so the owners search
zeroed rows (``index_service._exchange``).  The record therefore does not
depend on the answers (the routed lookup's answers are checked by
``tests/test_torch_distributed.py`` and ``chip_smoke.py``'s phase
distributed).  Counts as in :mod:`repro_torch.launch.dryrun`: collectives
with the reference's ring cost model, FLOPs of matrix products (the walk
has none), the peak of live temporaries; its bytes-accessed term is not a
trace count but the analytic one ``chip_smoke.py`` uses for the fused
walk's (K4's) bound, over the rows an owner receives at the most they can
need (``walk_bytes``).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.strings import random_strings
from repro_torch.core.tensor_index import DATA_FIELDS, pad_queries
from repro_torch.distributed.index_service import build_sharded, make_service_fn
from repro_torch.launch.dryrun import DEVICE, OUT_DIR, StepCounter, _buckets, fake_process_group
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import roofline_terms


def walk_bytes(rows: int, width: int, max_iters: int) -> int:
    """K4's bound count (``chip_smoke.py``: query rows and lengths in, three
    outputs, an item word each level walked, each hit's key bytes and entry
    record) for ``rows`` rows at the most they can need: ``max_iters``
    levels and a full-width hit each."""
    return rows * (width + 4) + 12 * rows + 4 * rows * max_iters + rows * (width + 8)


def run(multi_pod: bool, n_keys: int, q_per_device: int, out_dir: str,
        per_dest_capacity: int = 512) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_dev = 512 if multi_pod else 256
    t0 = time.time()
    rng = np.random.default_rng(0)
    keys = sorted(set(random_strings(rng, n_keys, 4, 24)))
    vals = np.arange(len(keys), dtype=np.int64)
    sidx = build_sharded(keys, vals, n_shards=16, device=DEVICE)
    t_build = time.time() - t0
    fake_process_group(n_dev)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=DEVICE)
        axes = tuple(a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names)
        fn = make_service_fn(sidx, per_dest_capacity=per_dest_capacity, mesh=mesh,
                             axis="data", shard_axes=axes)
        Q = q_per_device * n_dev
        qb, ql = (torch.from_numpy(a) for a in pad_queries(
            [keys[i] for i in rng.integers(0, len(keys), q_per_device)], sidx.width))
        (ti,) = fn.shards.values()
        args = [getattr(ti, f) for f in DATA_FIELDS] + [fn.boundaries, qb, ql]
        counters = StepCounter(args)
        with counters:
            fn(qb, ql)
        counts = counters.snapshot()
    finally:
        dist.destroy_process_group()
    t_trace = time.time() - t0 - t_build
    coll = _buckets(counts["coll"])
    flops = counts["flops"]
    recv = sidx.n_shards * per_dest_capacity
    byts = float(walk_bytes(recv, sidx.width, ti.max_iters))
    terms = roofline_terms(flops, byts, coll["total_bytes"])
    arg = sum(t.numel() * t.element_size() for t in args)
    rec = {
        "arch": "lits-query-service", "shape": f"q{q_per_device}_n{n_keys}",
        "mesh": mesh_name, "kind": "index-serve", "n_devices": n_dev,
        "queries_per_step": Q, "build_s": round(t_build, 2),
        "compile_s": round(t_trace, 2),
        "memory": {"total_per_device": int(arg + counts["temp"])},
        "flops_per_device": flops, "hlo_bytes_per_device": byts,
        "collectives": coll, "roofline": terms,
        "dominant": max(terms, key=terms.get),
        "coll_bytes_per_query": coll["total_bytes"] / q_per_device,
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"lits-query_{rec['shape']}_{mesh_name}.json"), "w") as f:
        json.dump(rec, f, indent=2)
    print(f"[ok] lits-query {rec['shape']} {mesh_name}: compile={rec['compile_s']}s "
          f"dominant={rec['dominant']} coll/query={rec['coll_bytes_per_query']:.0f}B "
          f"terms={{{', '.join(f'{k}={v:.3e}' for k, v in terms.items())}}}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--keys", type=int, default=200000)
    ap.add_argument("--q-per-device", type=int, default=4096)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    run(args.multi_pod, args.keys, args.q_per_device, args.out, args.capacity)


if __name__ == "__main__":
    main()
