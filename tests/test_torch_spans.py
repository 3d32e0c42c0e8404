"""The port's spans and counters (``repro_torch.spans``) on the CPU: call
records with self times that add up, a stack a thread, a bounded ring, the
profiler's ``record_function`` only while a profiler runs, and the counts
of an ``execute`` and a merge on a tiny index matching what the batch did."""
import ast
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.index import IndexConfig, PutRequest, ScanRequest, StringIndex
from repro_torch.kernels import _build

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _keys(n=600):
    return sorted({f"https://site{i % 37}.example.com/p/{i * 7919}".encode() for i in range(n)})


def _index(delta_capacity=64):
    keys = _keys()
    vals = np.arange(len(keys), dtype=np.int64) * 3 + 1
    return keys, StringIndex.bulk_load(keys, vals, IndexConfig(device="cpu",
                                                               delta_capacity=delta_capacity))


def _batch(keys, tag, n_put=5, n_scan=30):
    return ([PutRequest(f"https://new{tag}.example.com/{i}".encode(), i) for i in range(n_put)]
            + [ScanRequest(keys[(i * 17) % len(keys)], 1 + i % 4) for i in range(n_scan)])


def _last(name):
    recs = [r for r in spans.calls() if r["name"] == name]
    assert recs, f"no record {name}"
    return recs[-1]


def _check_self_times(rec, rel=1e-9):
    total = rec["t1"] - rec["t0"]
    assert sum(v[2] for v in rec["spans"].values()) == pytest.approx(total, rel=rel, abs=1e-12)
    assert rec["spans"][rec["name"]][1] == pytest.approx(total, rel=rel, abs=1e-12)
    for calls, tot, own in rec["spans"].values():
        assert calls >= 1 and tot >= own >= -1e-9


def test_spans_nest_and_self_times_add_up():
    with spans.span("lits.test.outer", items=3):
        time.sleep(0.002)
        for _ in range(2):
            with spans.span("lits.test.inner"):
                time.sleep(0.003)
                with spans.span("lits.test.leaf"):
                    time.sleep(0.001)
        spans.add("lits.test.extra", 5)
    rec = _last("lits.test.outer")
    _check_self_times(rec)
    outer, inner, leaf = (rec["spans"][f"lits.test.{n}"] for n in ("outer", "inner", "leaf"))
    assert (outer[0], inner[0], leaf[0]) == (1, 2, 2)
    assert inner[1] == pytest.approx(inner[2] + leaf[1])
    assert outer[1] == pytest.approx(outer[2] + inner[1])
    assert outer[2] >= 0.002 and inner[2] >= 0.006 and leaf[1] >= 0.002
    assert rec["counts"] == {"lits.test.outer.items": 3, "lits.test.extra": 5}


def test_add_outside_a_call_does_nothing_and_calls_filters_by_interval():
    n = len(spans.RING)
    spans.add("lits.test.nowhere", 1)
    assert len(spans.RING) == n
    t0 = time.perf_counter()
    with spans.span("lits.test.a"):
        pass
    t1 = time.perf_counter()
    with spans.span("lits.test.b"):
        pass
    assert [r["name"] for r in spans.calls(t0, t1)] == ["lits.test.a"]
    assert [r["name"] for r in spans.calls(t1)] == ["lits.test.b"]
    assert all(r["t1"] <= t0 for r in spans.calls(None, t0))


def test_an_exception_unwinds_the_stack():
    with pytest.raises(ValueError):
        with spans.span("lits.test.raises"):
            with spans.span("lits.test.raises_inner"):
                raise ValueError("x")
    assert spans._state.stack == [] and spans._state.rec is None
    rec = _last("lits.test.raises")
    assert rec["spans"]["lits.test.raises_inner"][0] == 1
    _check_self_times(rec)


def test_stacks_are_per_thread():
    barrier = threading.Barrier(2)
    seen = {}

    def work(tag):
        with spans.span(f"lits.test.thread_{tag}"):
            barrier.wait(timeout=10)   # both calls open at once
            with spans.span("lits.test.thread_child"):
                time.sleep(0.002)
            barrier.wait(timeout=10)
        seen[tag] = threading.get_ident()

    threads = [threading.Thread(target=work, args=(t,)) for t in ("x", "y")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for tag in ("x", "y"):
        rec = _last(f"lits.test.thread_{tag}")
        assert rec["thread"] == seen[tag]
        assert set(rec["spans"]) == {f"lits.test.thread_{tag}", "lits.test.thread_child"}
        assert rec["spans"]["lits.test.thread_child"][0] == 1
        _check_self_times(rec)


def test_many_threads_lose_no_record():
    import sys

    n_threads, n_calls = 16, 100
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t0 = time.perf_counter()
    try:
        def work(tag):
            for _ in range(n_calls):
                with spans.span("lits.test.stress", tag=tag):
                    with spans.span("lits.test.stress_child"):
                        spans.add("lits.test.stress_n", 1)

        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = [r for r in spans.calls(t0) if r["name"] == "lits.test.stress"]
    assert len(recs) == n_threads * n_calls
    assert len({r["id"] for r in recs}) == len(recs)
    for r in recs:
        assert r["spans"]["lits.test.stress_child"][0] == 1
        assert r["counts"]["lits.test.stress_n"] == 1
        _check_self_times(r)
    tags = [r["counts"]["lits.test.stress.tag"] for r in recs]
    assert sorted(set(tags)) == list(range(n_threads))
    assert all(tags.count(t) == n_calls for t in range(n_threads))


def test_the_ring_stays_bounded():
    for _ in range(spans.RING_SIZE + 50):
        with spans.span("lits.test.ring"):
            pass
    assert len(spans.RING) == spans.RING_SIZE
    ids = [r["id"] for r in spans.RING]
    assert ids == sorted(ids) and spans.RING[-1]["name"] == "lits.test.ring"


def test_no_record_function_with_the_profiler_off(monkeypatch):
    keys, idx = _index()

    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    out = idx.execute(_batch(keys, "off"))
    assert out.n_put == 5 and _last("lits.facade.execute")["spans"]["lits.facade.scan_group"]


def test_spans_on_the_profiler_timeline():
    from torch.profiler import ProfilerActivity, profile, record_function

    keys, idx = _index()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.outer"):
            idx.execute(_batch(keys, "prof"))
    assert not torch.autograd.profiler._is_profiler_enabled
    events = prof.events()
    names = {e.name for e in events}
    for name in ("lits.facade.execute", "lits.facade.plan", "lits.ti.pad_queries",
                 "lits.ti.mutate", "lits.kernels.fused_search", "lits.facade.scan_group",
                 "lits.facade.scan_entries", "lits.facade.answer_copy"):
        assert name in names, name

    def ancestors(e):
        out = []
        while e.cpu_parent is not None:
            e = e.cpu_parent
            out.append(e.name)
        return out

    ex = [e for e in events if e.name == "lits.facade.execute"]
    assert len(ex) == 1 and ancestors(ex[0])[-1] == "test.outer"
    for e in events:
        if e.name in ("lits.ti.mutate", "lits.facade.scan_entries"):
            assert "lits.facade.execute" in ancestors(e)
        if e.name == "lits.kernels.fused_search":
            assert ancestors(e)[0] == "lits.ti.mutate"
    # the per-call record was kept as without the profiler
    _check_self_times(_last("lits.facade.execute"))


def test_an_execute_record_counts_the_batch_exactly():
    keys, idx = _index()
    # the last scan's window takes the batch's seven fresh (delta) keys and two base keys
    batch = _batch(keys, "count", n_put=7, n_scan=40) + [ScanRequest(b"https://newcount", 9)]
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    out = idx.execute(batch)
    t1 = time.perf_counter()
    recs = [r for r in spans.calls(t0, t1)]
    assert [r["name"] for r in recs] == ["lits.facade.execute"]
    rec = recs[0]
    c = rec["counts"]
    entries = [e for r in out.results if r.entries is not None for e in r.entries]
    fresh = {r.key for r in batch if isinstance(r, PutRequest)}
    delta = sum(k in fresh for k, _ in entries)
    assert len(entries) > delta == 7 and not out.merged
    assert c["lits.facade.scan_entries.entries"] == len(entries)
    assert c["lits.facade.scan_entries.delta"] == delta
    assert c["lits.ti.mutate.ops"] == 7
    assert c["lits.facade.execute.ops"] == len(batch)
    assert c["lits.facade.scan_group.scans"] == 41
    assert c["lits.ti.pad_queries.keys"] == 7 + 41
    assert c["lits.ti.pad_queries.converted"] == 0
    windows = len({r.window for r in batch if isinstance(r, ScanRequest)})
    assert rec["spans"]["lits.facade.scan_group"][0] == windows
    assert rec["spans"]["lits.facade.scan_entries"][0] == windows
    assert rec["spans"]["lits.kernels.scan"][0] == windows
    assert rec["spans"]["lits.kernels.fused_search"][0] == 1
    assert c["lits.facade.answer_copy.bytes"] > 0 and c["lits.facade.query_copy.bytes"] > 0
    assert rec["launches"] == {k: n - before[k] for k, n in _build.LAUNCHES.items()
                               if n != before[k]}
    _check_self_times(rec)


def test_pad_queries_counts_the_keys_it_converts():
    keys, idx = _index()
    plain = keys[:40]
    found, vals = idx.get_batch(plain)
    c = _last("lits.facade.get_batch")["counts"]
    assert c["lits.ti.pad_queries.keys"] == 40 and c["lits.ti.pad_queries.converted"] == 0
    mixed = [k if i % 3 else (bytearray(k) if i % 2 else memoryview(k))
             for i, k in enumerate(plain)] + [np.bytes_(keys[50])]
    got, got_vals = idx.get_batch(mixed)
    c = _last("lits.facade.get_batch")["counts"]
    assert c["lits.ti.pad_queries.keys"] == 41
    assert c["lits.ti.pad_queries.converted"] == sum(type(k) is not bytes for k in mixed) == 15
    assert found.all() and got.all()
    np.testing.assert_array_equal(got_vals[:40], vals)


def test_a_merge_record_holds_the_replay_and_the_refreeze():
    keys, idx = _index(delta_capacity=16)
    t0 = time.perf_counter()
    for j in range(6):
        out = idx.execute(_batch(keys, f"merge{j}", n_put=4, n_scan=6))
        if out.merged:
            break
    assert out.merged
    rec = spans.calls(t0)[-1]
    assert rec["name"] == "lits.facade.execute"
    s = rec["spans"]
    for name in ("lits.index.merge", "lits.merge.copy", "lits.merge.replay", "lits.build.folds",
                 "lits.ti.freeze", "lits.ti.upload", "lits.merge.journal"):
        assert s[name][0] >= 1, name
    assert s["lits.index.merge"][1] >= s["lits.merge.replay"][1] + s["lits.ti.freeze"][1]
    assert rec["counts"]["lits.merge.replay.keys"] + rec["counts"].get(
        "lits.merge.replay.tombstones", 0) >= 12
    _check_self_times(rec)


def test_a_bulk_load_record_splits_the_builder_and_the_freeze():
    keys = _keys()
    StringIndex.bulk_load(keys, None, IndexConfig(device="cpu"))
    rec = _last("lits.index.bulk_load")
    s = rec["spans"]
    assert {"lits.build.bulkload", "lits.ti.freeze", "lits.ti.upload",
            "lits.kernels.hpt_cdf"} <= set(s)
    assert rec["counts"]["lits.build.bulkload.keys"] == len(keys)
    # the kernels' wrappers are children of the builder's span
    kern = sum(v[1] for k, v in s.items() if k.startswith("lits.kernels."))
    assert s["lits.build.bulkload"][1] == pytest.approx(s["lits.build.bulkload"][2] + kern)
    _check_self_times(rec)


def _loop_calls(tree):
    """Calls of ``span``/``add`` (any receiver) written inside a loop."""
    bad = []
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While, ast.comprehension)):
            continue
        body = loop.body + loop.orelse if not isinstance(loop, ast.comprehension) else []
        for node in (n for stmt in body for n in ast.walk(stmt)):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
                if name in ("span", "add") and (not isinstance(f, ast.Attribute)
                                                or getattr(f.value, "id", "") == "spans"):
                    bad.append(node.lineno)
    return bad


def test_no_span_is_written_inside_a_loop():
    users = [p for p in SRC.rglob("*.py") if "repro_torch.spans import" in p.read_text()]
    assert len(users) >= 9
    for p in users:
        assert not _loop_calls(ast.parse(p.read_text())), p
    # the check finds one
    assert _loop_calls(ast.parse("for i in x:\n    with span('a'):\n        add('b', 1)\n")) \
        == [2, 3]
