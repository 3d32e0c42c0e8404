"""Fixtures of the harness's CPU tests: a tiny copy of the benchmark (the
same mixes at small batches, the same configurations at a few thousand
keys) in a temporary directory, and a runner that drives one run of a cell
in this process on the CPU and returns its result line."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

# each mix's batch at test size (scans of 1-4 keys, so that a batch makes
# few scan groups, each a call of the plain scan); each configuration's keys
TINY_MIX = {"ycsb-c": {"batch": 256}, "ycsb-a": {"batch": 64},
            "ycsb-e": {"batch": 64, "scan_length": [1, 4]}}
TINY_KEYS = {"url-1m": (3000, 1500), "email-400k": (2000, 1000)}
# cells the tiny tree adds: the configurations and mixes kept for cells
# that are not in the benchmark yet (PERF.md, Open questions) are held to
# the reference too
EXTRA_CELLS = [("url-1m", "ycsb-c"), ("email-400k", "ycsb-a"), ("email-400k", "ycsb-e")]


def make_tiny(dst: Path) -> Path:
    """A checkout-like tree under ``dst``: ``BENCHMARK.json`` and ``bench/``
    with the real metric readers, the mixes at test batches and the
    configurations at test sizes (a delta of 16 entries, so that YCSB E
    merges within a few batches)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = dst / "bench"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    for p in (BENCH / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        mix.update(TINY_MIX.get(p.stem, {"batch": 64}))
        mix["block_batches"] = 8
        mix["trace_batches"] = 1
        if mix.get("warmup", {}).get("until_merge"):
            mix["warmup"]["max_batches"] = 12
        (bench / "traffic" / p.name).write_text(json.dumps(mix))
    have = {c["name"] for c in spec["configs"]}
    spec["configs"] += [{"name": p.stem, "source": "test", "why": "test", "reduced": [],
                         "file": f"bench/configs/{p.name}"}
                        for p in sorted((BENCH / "configs").glob("*.json")) if p.stem not in have]
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["n_stored"], cfg["n_pool"] = TINY_KEYS.get(c["name"], (2000, 1000))
        cfg["index_config"]["delta_capacity"] = 16
        (dst / c["file"]).write_text(json.dumps(cfg))
    have = {w["name"] for w in spec["workloads"]}
    spec["workloads"] += [{"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1,
                           "why": "test"} for c, t in EXTRA_CELLS if f"{c}.{t}" not in have]
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)


@pytest.fixture
def run_tiny(tiny, capsys):
    """``run_tiny(cell, seed=..., trace=0, seconds=0.3)`` -> (exit code,
    the result line as a dict or None)."""
    from litsbench.harness import run_cell
    from litsbench.spec import Spec

    def run(cell, seed=7, trace=0, seconds=0.3):
        capsys.readouterr()
        rc = run_cell(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=tiny, device="cpu",
                      spec=Spec(tiny, tiny / "bench"), src=ROOT / "src",
                      check_imports=False)   # test_bench_spec checks them in a process of its own
        lines = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)

    return run
