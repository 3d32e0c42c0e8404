"""The cell ``url-1m-exact.ycsb-c`` at test size on the CPU: the exact
placement mode's configuration through the harness, held to the reference,
its planted faults caught, and its new per-layer metrics read; the cells the
benchmark had keep their metric lists."""
import json

import pytest

from conftest import ROOT
from test_bench_check import FAULTS

CELL = "url-1m-exact.ycsb-c"
NEW_METRICS = ("shared_slot_keys", "get_pad_queries_ms", "delta_probe_ms", "lookup_values_ms",
               "get_device_idle_pct", "k4_get_roofline")
# read from the program's spans and counters; the device's two come from a
# CUDA trace, which a CPU run does not have
SPAN_METRICS = NEW_METRICS[:4]
# every per-layer metric of url-1m.ycsb-e before the cell was added
E_METRICS = ["batch_p50_ms", "batch_p95_ms", "bulk_load_s", "merged_batch_ms", "k4_roofline",
             "k6_roofline", "device_idle_pct", "kernels_per_op", "scan_loop_ms", "answer_copy_ms",
             "pad_queries_ms", "write_path_ms", "wrapper_ms", "merge_replay_ms",
             "merge_refreeze_ms", "bulk_load_host_s"]


def test_the_configuration_sets_the_mode_and_keeps_url_1m_s_draw():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in spec["configs"]}
    exact, url = files["url-1m-exact"], files["url-1m"]
    assert exact["index_config"] == {**url["index_config"], "builder": {"exact_slots": True}}
    for k in ("recipe", "n_stored", "n_pool", "data_seed", "reduced", "values"):
        assert exact[k] == url[k], k
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("url-1m-exact", "ycsb-c", 1)
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW_METRICS:
        assert per_layer[name]["workloads"] == [CELL], name
    assert [m["name"] for m in spec["per_layer"] if "url-1m.ycsb-e" in m["workloads"]] \
        == E_METRICS


def test_a_tiny_cell_is_correct(run_tiny):
    rc, res = run_tiny(CELL, seed=2**31 + 21)
    assert rc == 0 and res["correct"], res
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(v == {"value": 0, "limit": 0} for v in res["check"].values())
    assert {"ops_per_s", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_each_fault_makes_the_tiny_cell_not_correct(run_tiny, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    rc, res = run_tiny(CELL, seed=2**31 + 22)
    assert rc == 0 and res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())


def test_a_traced_tiny_run_reads_the_new_metrics(run_tiny):
    rc, res = run_tiny(CELL, seed=2**31 + 23, trace=1)
    assert rc == 0 and res["correct"], res
    m = res["metrics"]
    assert set(m) <= set(NEW_METRICS)
    for name in SPAN_METRICS:
        assert name in m, name
    assert m["shared_slot_keys"]["unit"] == "keys" and m["shared_slot_keys"]["value"] >= 0
    assert m["get_pad_queries_ms"]["value"] > 0 and m["delta_probe_ms"]["value"] > 0
    assert m["lookup_values_ms"]["value"] > 0


def test_without_the_programs_spans_the_new_readers_find_nothing(monkeypatch):
    """A program without ``repro_torch.spans`` (or without the counter) and
    a run without a trace: every new reader returns None and raises nothing."""
    from litsbench import program_spans
    from litsbench.spec import Spec

    spec = Spec(ROOT)
    batch = {"t0": 0.0, "t_call": 0.0, "t1": 1.0, "t_kept": 1.0}
    run = {"window": {"batches": [batch]}, "profile": None, "width": 96}
    monkeypatch.setattr(program_spans, "_spans", lambda: None)
    for name in NEW_METRICS:
        assert spec.reader(name)(run) is None, name
    monkeypatch.setattr(program_spans, "setup_call", lambda run, name: {"counts": {}})
    assert spec.reader("shared_slot_keys")(run) is None
