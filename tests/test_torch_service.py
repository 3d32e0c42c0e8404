"""The port's ``IndexService`` against the JAX package, on the CPU: the cases
of tests/test_index_service.py (the distributed backend's included) and
the two service cases of tests/test_compaction.py, on the port.  Where a
case compares the service with a direct ``execute``, the port's service is
also held to the reference's service (or index) on the same ops, result
for result.  Every wait has a timeout and every service is closed by the
``services`` fixture, so a hung thread fails its test.
"""
import dataclasses
import logging
import threading
import time

import numpy as np
import pytest

from repro.core.strings import random_strings
from repro.index import IndexConfig as RConfig, StringIndex as RIndex
from repro.index import facade as r_facade
from repro.serve.service import IndexService as RService, ServiceConfig as RServiceConfig
from repro_torch.index import (
    DeleteRequest, GetRequest, IndexConfig, PutRequest, ScanRequest, Status, StringIndex,
)
from repro_torch.serve import IndexService, ServiceConfig
from repro_torch.serve.service import _make_cursor

WAIT_S = 60.0


def _corpus(rng, n=600):
    keys = sorted(set(random_strings(rng, n, 2, 24)))
    vals = np.arange(len(keys), dtype=np.int64) * 5 + 1
    return keys, vals


def _cfg(**kw):
    kw.setdefault("auto_merge_threshold", None)
    return IndexConfig(device="cpu", **kw)


@pytest.fixture
def services():
    """Services a test starts, closed after it whatever its outcome."""
    made = []
    yield made
    for svc in made:
        svc.close()


def _started(services, svc):
    services.append(svc)
    return svc


def _to_ref(r):
    if isinstance(r, GetRequest):
        return r_facade.GetRequest(r.key)
    if isinstance(r, PutRequest):
        return r_facade.PutRequest(r.key, r.value)
    if isinstance(r, DeleteRequest):
        return r_facade.DeleteRequest(r.key)
    return r_facade.ScanRequest(r.start, r.window)


def _same(got, want):
    """Two OpResults of either package equal."""
    assert int(got.status) == int(want.status), (got, want)
    assert (got.value, got.updated, got.entries) == (want.value, want.updated, want.entries)


def _strip(tenant, entries):
    p = IndexService.encode_key(tenant, b"")
    return tuple((k[len(p):], v) for k, v in entries)


def _same_as_direct(got, want, tenant):
    assert int(got.status) == int(want.status), (got, want)
    assert got.value == want.value and got.updated == want.updated
    if want.entries is not None:
        assert got.entries == _strip(tenant, want.entries)


def _twins(services, keys, vals, tenant="t0", **svc_kw):
    """(service, direct index) over the same bulk loads of tenant-encoded keys."""
    cfg = _cfg(delta_capacity=4096, scan_window=6)
    enc = [IndexService.encode_key(tenant, k) for k in keys]
    kw = dict(max_batch=4096, max_delay_ms=25.0, merge_threshold=None, default_tenant=tenant)
    kw.update(svc_kw)
    svc = _started(services, IndexService(StringIndex.bulk_load(enc, vals, cfg),
                                          ServiceConfig(**kw)))
    return svc, StringIndex.bulk_load(enc, vals, cfg)


def test_single_flush_equal_direct_execute_and_reference_service(rng, services):
    """One coalesced flush of a mixed batch equals a direct ``execute`` of
    the same batch, and the reference's service on the same batch."""
    keys, vals = _corpus(rng)
    svc, direct = _twins(services, keys, vals)
    batch = (
        [GetRequest(k) for k in keys[:30]]
        + [GetRequest(k + b"~miss") for k in keys[:5]]
        + [PutRequest(b"np-%03d" % i, 9000 + i) for i in range(20)]
        + [PutRequest(keys[4], 4444)]
        + [DeleteRequest(keys[7]), DeleteRequest(b"absent-key")]
        + [GetRequest(b"np-003"), GetRequest(keys[7]), GetRequest(keys[4])]
        + [ScanRequest(keys[0]), ScanRequest(keys[50][:2], 11)]
    )
    got = svc.execute(batch)
    want = direct.execute([svc._encode(r, None) for r in batch])
    assert len(got) == len(want.results)
    for g, w in zip(got, want.results):
        _same_as_direct(g, w, "t0")
    assert got[35].ok and not got[35].updated
    assert got[55].ok and got[55].updated
    assert got[56].status == Status.OK and got[57].status == Status.NOT_FOUND
    assert got[58].value == 9003 and got[59].status == Status.NOT_FOUND and got[60].value == 4444
    assert svc.stats().flushes == 1
    enc = [IndexService.encode_key("t0", k) for k in keys]
    ref = _started(services, RService(
        RIndex.bulk_load(enc, vals, RConfig(delta_capacity=4096, auto_merge_threshold=None,
                                            scan_window=6)),
        RServiceConfig(max_batch=4096, max_delay_ms=25.0, merge_threshold=None,
                       default_tenant="t0")))
    for g, w in zip(got, ref.execute([_to_ref(r) for r in batch])):
        _same(g, w)


def test_concurrent_clients_coalesced_and_equal_direct(rng, services):
    """8 clients with disjoint keyspaces submit at once; their ops share
    flushes, and each client's results equal a direct run of its ops."""
    keys, vals = _corpus(rng, 800)
    svc, direct = _twins(services, keys, vals, max_batch=64)
    n_clients = 8

    def client_ops(i):
        mine = keys[i::n_clients]
        return ([GetRequest(k) for k in mine[:15]]
                + [PutRequest(b"c%d-%04d" % (i, j), i * 10000 + j) for j in range(10)]
                + [GetRequest(b"c%d-0007" % i)]
                + [DeleteRequest(k) for k in mine[15:20]]
                + [GetRequest(mine[15])]
                + [ScanRequest(mine[0], 9)])

    results = {}
    barrier = threading.Barrier(n_clients, timeout=WAIT_S)

    def run(i):
        ops = client_ops(i)
        barrier.wait()
        results[i] = svc.execute(ops, timeout=WAIT_S)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive()
    s = svc.stats()
    assert s.completed == sum(len(client_ops(i)) for i in range(n_clients))
    assert s.coalescing_factor > 1.0
    for i in range(n_clients):
        want = direct.execute([svc._encode(r, None) for r in client_ops(i)])
        for g, w in zip(results[i], want.results):
            _same_as_direct(g, w, "t0")


def test_tenant_isolation_gets_and_scans(rng, services):
    keys, vals = _corpus(rng, 300)
    svc = _started(services, IndexService.bulk_load(
        {"alice": (keys, vals), "bob": (keys[:50], vals[:50] + 7)},
        _cfg(delta_capacity=512), ServiceConfig(max_batch=1024, merge_threshold=None)))
    ra = svc.execute([GetRequest(keys[3])], tenant="alice")[0]
    rb = svc.execute([GetRequest(keys[3])], tenant="bob")[0]
    assert ra.value == int(vals[3]) and rb.value == int(vals[3]) + 7
    assert svc.execute([GetRequest(keys[100])], tenant="bob")[0].status == Status.NOT_FOUND
    svc.execute([PutRequest(b"secret", 42)], tenant="alice")
    assert svc.execute([GetRequest(b"secret")], tenant="bob")[0].status == Status.NOT_FOUND
    pa = svc.execute([ScanRequest(keys[48], 40)], tenant="bob")[0]
    assert [k for k, _ in pa.entries] == keys[48:50]
    pb = svc.execute([ScanRequest(keys[len(keys) - 2], 40)], tenant="alice")[0]
    assert [k for k, _ in pb.entries] == keys[-2:]
    for k, _ in pa.entries + pb.entries:
        assert b"\x1f" not in k
    with pytest.raises(ValueError):
        svc.execute([GetRequest(b"x")], tenant="no spaces allowed")


def test_cursor_pagination_equals_one_shot_scan(rng, services):
    keys, vals = _corpus(rng, 250)
    svc = _started(services, IndexService.bulk_load(
        {"t": (keys, vals)}, _cfg(), ServiceConfig(max_batch=1024, merge_threshold=None)))
    one = svc.execute([ScanRequest(b"", 60)], tenant="t")[0].entries
    assert len(one) == 60
    pages, page, hops = [], svc.scan_page(start=b"", page_size=7, tenant="t"), 0
    while True:
        pages.extend(page.entries)
        if page.cursor is None or len(pages) >= 60:
            break
        page = svc.scan_page(cursor=page.cursor, tenant="t")
        hops += 1
    assert pages[:60] == list(one) and hops >= 8
    tail = svc.scan_page(start=keys[-3], page_size=50, tenant="t")
    assert [k for k, _ in tail.entries] == keys[-3:] and tail.cursor is None
    with pytest.raises(ValueError):
        svc.scan_page(cursor="not-a-cursor")


def test_forged_cursor_cannot_cross_tenants(rng, services):
    keys, vals = _corpus(rng, 120)
    svc = _started(services, IndexService.bulk_load(
        {"alice": (keys, vals), "bob": (keys[:30], vals[:30] + 9)}, _cfg(),
        ServiceConfig(max_batch=1024, merge_threshold=None)))
    alice_page = svc.scan_page(start=b"", page_size=5, tenant="alice")
    assert alice_page.cursor is not None
    forged = svc.scan_page(cursor=alice_page.cursor, tenant="bob")
    assert forged.status == Status.FORBIDDEN and forged.entries == () and forged.cursor is None
    crafted = _make_cursor("alice", b"", 50)
    assert svc.scan_page(cursor=crafted, tenant="bob").status == Status.FORBIDDEN
    assert svc.scan_page(cursor=crafted).status == Status.FORBIDDEN
    cont = svc.scan_page(cursor=alice_page.cursor, tenant="alice")
    assert cont.status == Status.OK and len(cont.entries) > 0
    assert all(b"\x1f" not in k for k, _ in cont.entries)


def test_maintenance_failures_surface_in_stats(rng, services, caplog):
    keys, vals = _corpus(rng, 100)
    svc = _started(services, IndexService.bulk_load(
        {"t": (keys, vals)}, _cfg(delta_capacity=16),
        ServiceConfig(max_batch=1024, default_tenant="t", merge_threshold=0.5,
                      maintenance_interval_ms=60_000.0)))

    def failing_merge(*a, **kw):
        raise RuntimeError("injected merge failure")

    svc.index.begin_merge = failing_merge
    with caplog.at_level(logging.ERROR, logger="repro_torch.serve.service"):
        svc.execute([PutRequest(b"f-%03d" % i, i) for i in range(10)])
        for want in (1, 2, 3):
            svc._maint_wake.set()
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and svc.stats().maintenance_errors < want:
                time.sleep(0.005)
    s = svc.stats()
    assert s.maintenance_errors >= 1
    assert "injected merge failure" in (s.last_maintenance_error or "")
    assert len([r for r in caplog.records if "injected merge failure" in r.getMessage()]) == 1
    assert svc.execute([GetRequest(keys[0])])[0].value == int(vals[0])


def test_stats_polling_never_syncs_device(rng, services, monkeypatch):
    """``stats()`` and the maintenance check read the facade's host mirrors,
    never the device-syncing ``delta_fill_fraction``."""
    from repro_torch.core import tensor_index as tix

    keys, vals = _corpus(rng, 80)
    svc = _started(services, IndexService.bulk_load(
        {"t": (keys, vals)}, _cfg(),
        ServiceConfig(max_batch=1024, default_tenant="t", merge_threshold=0.9)))
    svc.execute([PutRequest(b"s-%03d" % i, i) for i in range(10)])

    def forbidden(ti):
        raise AssertionError("stats polling must not sync the device")

    monkeypatch.setattr(tix, "delta_fill_fraction", forbidden)
    assert svc.stats().delta_fill > 0.0
    assert svc.maintenance_step() is False


def test_admission_control_sheds_as_data(rng, services):
    keys, vals = _corpus(rng, 120)
    svc = _started(services, IndexService.bulk_load(
        {"t": (keys, vals)}, _cfg(),
        ServiceConfig(max_batch=4096, max_delay_ms=10_000.0, max_queue=16,
                      default_tenant="t", merge_threshold=None)))
    futs = svc.submit_many([GetRequest(keys[i % len(keys)]) for i in range(50)])
    shed = [f for f in futs if f.done()]
    assert len(shed) == 50 - 16
    assert all(f.result(timeout=WAIT_S).status == Status.OVERLOADED for f in shed)
    whole = svc.submit_batch([GetRequest(keys[0])] * 4)
    assert [r.status for r in whole.result(timeout=WAIT_S)] == [Status.OVERLOADED] * 4
    svc.flush()
    head = [f.result(timeout=WAIT_S) for f in futs[:16]]
    assert all(r.status == Status.OK for r in head)
    s = svc.stats()
    assert s.shed == 38 and s.completed == 16 and s.p99_ms >= s.p50_ms >= 0.0


def test_maintenance_owns_compaction_not_request_path(rng, services):
    keys, vals = _corpus(rng, 200)
    svc = _started(services, IndexService.bulk_load(
        {"t": (keys, vals)}, _cfg(delta_capacity=64, auto_merge_threshold=0.75),
        ServiceConfig(max_batch=1024, default_tenant="t", merge_threshold=0.99,
                      maintenance_interval_ms=10_000.0)))
    assert svc.index.config.auto_merge_threshold is None
    svc.execute([PutRequest(b"zz-%03d" % i, i) for i in range(40)])
    assert svc.index.merge_count == 0 and svc.index.delta_fill >= 0.5
    svc.config = dataclasses.replace(svc.config, merge_threshold=0.5)
    assert svc.maintenance_step() is True
    assert svc.index.merge_count == 1 and svc.stats().merges == 1
    assert svc.index.delta_fill == 0.0
    res = svc.execute([GetRequest(b"zz-007"), ScanRequest(b"zz-", 5)])
    assert res[0].value == 7
    assert [k for k, _ in res[1].entries] == [b"zz-%03d" % i for i in range(5)]


def test_close_restores_index_compaction_policy(rng):
    keys, vals = _corpus(rng, 120)
    idx = StringIndex.bulk_load(keys, vals, _cfg(auto_merge_threshold=0.5))
    svc = IndexService(idx, ServiceConfig(merge_threshold=None))
    try:
        assert idx.config.auto_merge_threshold is None
    finally:
        svc.close()
    assert idx.config.auto_merge_threshold == 0.5
    assert not svc._flusher.is_alive() and not svc._maintenance.is_alive()
    with pytest.raises(RuntimeError):
        svc.submit(GetRequest(keys[0]))


def test_maintenance_compacts_on_overflow_below_fill_threshold(rng, services):
    keys, vals = _corpus(rng, 150)
    svc = _started(services, IndexService.bulk_load(
        {"t": (keys, vals)}, _cfg(delta_capacity=256, delta_bytes=64),
        ServiceConfig(max_batch=1024, default_tenant="t", merge_threshold=0.6,
                      maintenance_interval_ms=60_000.0)))
    res = svc.execute([PutRequest(b"k-%02d" % i, i) for i in range(40)])
    assert any(r.status == Status.REJECTED_FULL for r in res)
    assert svc.index.delta_fill < 0.6
    deadline = time.monotonic() + 10.0
    while svc.index.merge_count == 0 and time.monotonic() < deadline:
        svc.maintenance_step()
        time.sleep(0.01)
    assert svc.index.merge_count >= 1 and not svc.index.delta_overflowed
    ok = svc.execute([PutRequest(b"post-merge", 1), GetRequest(b"post-merge")])
    assert ok[0].ok and ok[1].value == 1


def test_compact_forces_merge_past_disabled_threshold(rng, services):
    keys, vals = _corpus(rng, 150)
    svc = _started(services, IndexService.bulk_load(
        {"t": (keys, vals)}, _cfg(delta_capacity=64),
        ServiceConfig(max_batch=256, default_tenant="t", merge_threshold=None)))
    svc.execute([PutRequest(b"c-%03d" % i, i) for i in range(20)])
    assert svc.maintenance_step() is False and svc.index.merge_count == 0
    assert svc.compact() is True
    assert svc.index.merge_count == 1 and svc.index.delta_fill == 0.0
    assert svc.stats().merges == 1
    assert svc.compact() is False


def test_concurrent_writers_race_forced_compaction(rng, services):
    """Writer threads and forced ``compact()`` calls race; every write is
    journaled during a merge and replayed at its commit, and the end state
    equals the per-writer oracle through gets and a cursor pass."""
    keys, vals = _corpus(rng, 300)
    svc = _started(services, IndexService.bulk_load(
        {"t": (keys, vals)}, _cfg(delta_capacity=8192),
        ServiceConfig(max_batch=64, max_delay_ms=0.5, default_tenant="t",
                      merge_threshold=None)))
    n_writers, rounds = 4, 6
    oracle = {k: int(v) for k, v in zip(keys, vals)}
    barrier = threading.Barrier(n_writers + 1, timeout=WAIT_S)
    statuses, lock = [], threading.Lock()

    def writer(i):
        barrier.wait()
        for r in range(rounds):
            batch = [PutRequest(b"w%d-%04d" % (i, r * 50 + j), i * 100000 + r * 50 + j)
                     for j in range(50)]
            batch.append(DeleteRequest(b"w%d-%04d" % (i, r * 50)))
            batch.append(PutRequest(b"w%d-%04d" % (i, r * 50 + 1), -(i + r)))
            ok = all(res.status == Status.OK for res in svc.execute(batch, timeout=WAIT_S))
            with lock:
                statuses.append(ok)
                for req in batch:
                    if isinstance(req, PutRequest):
                        oracle[req.key] = req.value
                    else:
                        oracle.pop(req.key, None)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(n_writers)]
    for t in threads:
        t.start()
    barrier.wait()
    merges = 0
    for _ in range(4):
        time.sleep(0.05)
        merges += bool(svc.compact())
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive()
    assert len(statuses) == n_writers * rounds and all(statuses)
    assert merges >= 1
    svc.compact()
    s = svc.stats()
    assert s.epoch == s.merges >= 1
    live = sorted(oracle)
    assert [r.value for r in svc.execute([GetRequest(k) for k in live])] == \
        [oracle[k] for k in live]
    page, got = svc.scan_page(b"", 200, tenant="t"), []
    while True:
        got.extend(page.entries)
        if page.cursor is None:
            break
        page = svc.scan_page(cursor=page.cursor, tenant="t")
    assert got == [(k, oracle[k]) for k in live]


def test_commit_pause_excludes_merge_work(rng, services):
    """The replay runs outside the index lock: the commit pause is a small
    part of the merge's wall time."""
    keys, vals = _corpus(rng, 400)
    svc = _started(services, IndexService.bulk_load(
        {"t": (keys, vals)}, _cfg(delta_capacity=4096),
        ServiceConfig(default_tenant="t", merge_threshold=None)))
    svc.execute([PutRequest(b"p-%05d" % i, i) for i in range(1500)])
    assert svc.compact() is True
    s = svc.stats()
    assert s.merge_wall_ms > 0 and s.merge_pause_ms >= 0
    assert s.merge_pause_ms < s.merge_wall_ms / 2, (s.merge_pause_ms, s.merge_wall_ms)



def test_service_over_distributed_backend(rng, services):
    """The same request plane fronts the distributed read-only index:
    coalesced gets are bit-identical to direct ``execute``, and to the
    reference's distributed index; mutations come back UNSUPPORTED as data
    (facade contract riding through the service)."""
    import jax

    from repro.distributed.index_service import DistributedStringIndex as RDistributed
    from repro_torch.distributed import DistributedStringIndex

    keys, vals = _corpus(rng, 400)
    enc = [IndexService.encode_key("t", k) for k in keys]
    dsi = DistributedStringIndex.build(enc, vals, n_shards=1, config=_cfg())
    ref = RDistributed.build(enc, vals, n_shards=1, mesh=jax.make_mesh((1,), ("data",)))
    svc = _started(services, IndexService(dsi, ServiceConfig(
        max_batch=64, default_tenant="t", merge_threshold=None)))
    n_clients = 8
    results = {}
    barrier = threading.Barrier(n_clients, timeout=WAIT_S)

    def run(i):
        ops = ([GetRequest(k) for k in keys[i::n_clients][:20]]
               + [GetRequest(b"miss-%d" % i), PutRequest(b"x-%d" % i, 1),
                  DeleteRequest(b"y-%d" % i)])
        barrier.wait()
        results[i] = (ops, svc.execute(ops, timeout=WAIT_S))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads) and len(results) == n_clients
    for i in range(n_clients):
        ops, got = results[i]
        enc_ops = [svc._encode(r, None) for r in ops]
        want = dsi.execute(enc_ops).results
        for g, w, r in zip(got, want, ref.execute([_to_ref(o) for o in enc_ops]).results):
            assert g.status == w.status and g.value == w.value
            _same(w, r)
        assert got[-2].status == Status.UNSUPPORTED   # put on the read-only shards
        assert got[-1].status == Status.UNSUPPORTED   # delete likewise
    assert svc.stats().coalescing_factor > 1.0
