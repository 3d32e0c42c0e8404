"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<mix>`` of ``workloads`` names a configuration (its
``file``, under ``bench/configs/``) and a traffic mix
(``bench/traffic/<mix>.json``); each metric is computed by its own reader,
``bench/metrics/<metric>.py``.  Adding a configuration, a mix or a metric
is adding its file and its entry: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


class Spec:
    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """Every end-to-end metric (``trace`` False), or the per-layer
        metrics whose ``workloads`` list the cell."""
        if not trace:
            return self.data["end_to_end"]
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str) -> Callable[[Dict], object]:
        """``read(run)`` of ``bench/metrics/<metric>.py``."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
