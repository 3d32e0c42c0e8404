"""The harness is driven by data: a configuration, a mix or a metric added
as a file is found by its name; and nothing it runs imports JAX or the JAX
package, while the reference imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_harness_source_imports_jax_or_the_jax_package():
    sources = [p for p in BENCH.rglob("*.py") if not p.name.startswith("test_")]
    assert sources
    for p in sources:
        found = _top_imports(p) & FORBIDDEN
        assert not found, f"{p} imports {found}"
    # whole names: the program's package begins with the JAX package's name
    assert "repro_torch" not in FORBIDDEN and "repro_torch".startswith("repro")


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "traffic.py", "keysets.py", "control.py"):
        assert not _top_imports(BENCH / "litsbench" / name) & {"repro_torch", "torch"}
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import litsbench.reference, "
            "litsbench.control; bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'torch'}); print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_run_loads_no_jax_module(tiny):
    """One tiny run in a fresh process: the harness itself refuses to print
    a result with jax, jaxlib, flax or repro in ``sys.modules``."""
    code = ("import sys, json; from pathlib import Path; sys.path.insert(0, sys.argv[1]); "
            "from litsbench.harness import run_cell; from litsbench.spec import Spec; "
            "t = Path(sys.argv[2]); rc = run_cell(['--workload', 'email-400k.ycsb-a', "
            "'--seed', '3', '--seconds', '0.2'], root=t, device='cpu', "
            "spec=Spec(t, t / 'bench'), src=Path(sys.argv[3])); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro'})); sys.exit(rc)")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH), str(tiny), str(ROOT / "src")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2])["correct"] is True and lines[-1] == "[]"


def test_a_config_mix_and_metric_added_as_files_are_found_by_name(tiny, run_tiny):
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny / "bench/configs/email-400k.json").read_text())
    cfg["n_stored"], cfg["n_pool"] = 1500, 500
    (tiny / "bench/configs/email-small.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny / "bench/traffic/ycsb-a.json").read_text())
    mix["proportions"] = {"read": 0.95, "update": 0.05}
    mix["distribution"] = "uniform"
    (tiny / "bench/traffic/ycsb-b.json").write_text(json.dumps(mix))
    (tiny / "bench/metrics/window_batches.py").write_text(
        "def read(run):\n    return len(run['window']['batches'])\n")
    spec["configs"].append({"name": "email-small", "source": "test", "why": "test",
                            "file": "bench/configs/email-small.json", "reduced": []})
    spec["workloads"].append({"name": "email-small.ycsb-b", "config": "email-small",
                              "traffic": "ycsb-b", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "window_batches", "unit": "batches", "better": "higher",
                              "source": "host_clock", "layer": "facade", "moves": "ops_per_s",
                              "workloads": ["email-small.ycsb-b"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, res = run_tiny("email-small.ycsb-b", trace=1)
    assert rc == 0 and res["correct"], res
    assert res["metrics"]["window_batches"]["value"] >= 1
    assert "k4_roofline" not in res["metrics"]   # not listed for this cell
    # every end-to-end metric is reported in every cell
    rc, res = run_tiny("email-small.ycsb-b", trace=0)
    assert set(res["metrics"]) >= {"ops_per_s", "setup_s"}


def test_benchmark_json_has_the_required_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["command"] == ["python3", "bench/run.py"] and spec["paths"] == ["bench"]
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file() and 0.01 <= m["bound"] <= 0.25
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] == 1


def test_the_window_ends_on_a_merge_and_keeps_answers_out_of_the_collector(tiny, run_tiny):
    """YCSB E's window runs on past ``--seconds`` to its next merged batch;
    the answers kept for the check are objects the collector does not scan."""
    import gc

    (tiny / "bench/metrics/last_merged.py").write_text(
        "def read(run):\n    return float(run['window']['batches'][-1]['merged'])\n")
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "last_merged", "unit": "1", "better": "higher",
                              "source": "host_clock", "layer": "facade", "moves": "ops_per_s",
                              "workloads": ["url-1m.ycsb-e"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, res = run_tiny("url-1m.ycsb-e", trace=1, seconds=0.05)
    assert rc == 0 and res["correct"], res
    assert res["metrics"]["last_merged"]["value"] == 1.0

    sys.path.insert(0, str(ROOT / "src"))
    from litsbench.harness import Program
    from repro_torch.index import facade

    prog = Program(None, "execute", [], [])
    out = facade.BatchResult([facade.OpResult(facade.Status.OK, entries=((b"k", 1),)),
                              facade.OpResult(facade.Status.NOT_FOUND)])
    kept = prog.keep(out)
    assert kept == [("OK", None, False, ((b"k", 1),)), ("NOT_FOUND", None, False, None)]
    gc.collect()
    assert not any(gc.is_tracked(a) for a in kept)
