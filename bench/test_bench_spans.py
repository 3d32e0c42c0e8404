"""The per-layer metrics read from the program's own spans
(``repro_torch.spans``, through ``litsbench.program_spans``) on a tiny
traced run of ``url-1m.ycsb-e``: present, consistent with the call records
they come from, absent from the untraced line, and absent, without an
error, where the program has no spans."""
import json
import time

import pytest

from conftest import ROOT

SPAN_METRICS = ("scan_loop_ms", "answer_copy_ms", "pad_queries_ms", "write_path_ms",
                "wrapper_ms", "merge_replay_ms", "merge_refreeze_ms", "bulk_load_host_s")


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_span_metrics_are_declared_for_the_cell():
    spec = _spec()
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in SPAN_METRICS:
        m = per_layer[name]
        assert m["source"] == "host_clock" and m["workloads"] == ["url-1m.ycsb-e"]
        assert m["moves"] == ("setup_s" if name == "bulk_load_host_s" else "ops_per_s")


def test_a_traced_run_reports_every_span_metric(run_tiny):
    from repro_torch import spans

    t0 = time.perf_counter()
    rc, res = run_tiny("url-1m.ycsb-e", trace=1)
    assert rc == 0 and res["correct"], res
    m = res["metrics"]
    for name in SPAN_METRICS:
        assert name in m, name
        assert m[name]["value"] >= 0 and m[name]["unit"] == ("s" if name.endswith("_s") else "ms")
    assert m["scan_loop_ms"]["value"] > 0 and m["pad_queries_ms"]["value"] > 0
    assert m["merge_replay_ms"]["value"] > 0 and m["merge_refreeze_ms"]["value"] > 0
    # the builder's own time is part of the bulk load the harness times
    assert 0 < m["bulk_load_host_s"]["value"] < m["bulk_load_s"]["value"]
    # every call of the run: its self times add up to its length
    recs = [r for r in spans.calls(t0) if r["name"] == "lits.facade.execute"]
    assert len(recs) > 3
    for r in recs:
        total = r["t1"] - r["t0"]
        assert sum(v[2] for v in r["spans"].values()) == pytest.approx(total, rel=0.01)


def test_the_untraced_line_keeps_the_end_to_end_names(run_tiny):
    rc, res = run_tiny("url-1m.ycsb-e", trace=0)
    assert rc == 0 and res["correct"], res
    e2e = {m["name"] for m in _spec()["end_to_end"]}
    assert {"ops_per_s", "setup_s"} <= set(res["metrics"]) <= e2e


def test_without_the_programs_spans_the_readers_find_nothing(run_tiny, monkeypatch):
    from litsbench import program_spans

    monkeypatch.setattr(program_spans, "_spans", lambda: None)
    rc, res = run_tiny("url-1m.ycsb-e", trace=1)
    assert rc == 0 and res["correct"], res
    assert not set(SPAN_METRICS) & set(res["metrics"])
    assert {"batch_p50_ms", "bulk_load_s", "merged_batch_ms"} <= set(res["metrics"])


def test_a_window_the_records_do_not_match_reads_nothing():
    from litsbench import program_spans
    from litsbench.spec import Spec
    from repro_torch import spans

    with spans.span("lits.facade.execute"):
        pass
    rec = spans.calls()[-1]
    batch = {"t0": rec["t0"], "t_call": rec["t0"], "t1": rec["t1"]}
    one = {"window": {"batches": [batch]}}
    two = {"window": {"batches": [batch, dict(batch)]}}
    assert program_spans.window_calls(one) == [rec]
    assert program_spans.window_calls(two) is None
    none = {"window": {"batches": [{"t0": 0.0, "t_call": 0.0, "t1": 0.0}]}}
    spec = Spec(ROOT)
    for name in SPAN_METRICS:
        assert spec.reader(name)(none) is None
        if name != "bulk_load_host_s":   # read from the set-up, not the window
            assert spec.reader(name)(two) is None
