"""The port's typed batch API against the JAX package, on the CPU: the same
batches of ``GetRequest``/``PutRequest``/``DeleteRequest``/``ScanRequest``
over the same numpy-made keys go through the reference's
``StringIndex.execute`` (its default jnp search backend) and the port's,
and every result must be equal bit for bit: the status, the value, the
updated flag, the scan entries (key bytes and values), ``merged`` and
``delta_fill``.  The cases are those of tests/test_string_index.py, but for
its backend-precedence test (the reference's ``search_backend`` and
``kernel_backend`` and their environment variables have no counterpart in
the port, whose ``device`` alone decides the path)."""
import numpy as np
import pytest

from repro.core.strings import random_strings
from repro.index import (
    DeleteRequest as RDelete, GetRequest as RGet, IndexConfig as RConfig,
    PutRequest as RPut, ScanRequest as RScan, StringIndex as RIndex,
)
from repro_torch.index import (
    DeleteRequest, GetRequest, IndexConfig, PutRequest, ScanRequest, Status, StringIndex,
)

_TO_REF = {GetRequest: lambda r: RGet(r.key), PutRequest: lambda r: RPut(r.key, r.value),
           DeleteRequest: lambda r: RDelete(r.key),
           ScanRequest: lambda r: RScan(r.start, r.window)}


def _corpus(rng, n=600):
    keys = sorted(set(random_strings(rng, n, 2, 24)))
    vals = np.arange(len(keys), dtype=np.int64) * 5 + 1
    return keys, vals


def _pair(keys, vals, **cfg):
    """The reference's and the port's facades over the same keys."""
    return (RIndex.bulk_load(keys, vals, RConfig(**cfg)),
            StringIndex.bulk_load(keys, vals, IndexConfig(device="cpu", **cfg)))


def _same_result(want, got):
    assert int(got.status) == int(want.status), (got, want)
    assert (got.value, got.updated, got.entries) == (want.value, want.updated, want.entries)


def run_both(ri, ti, batch):
    """``batch`` (port requests) through both facades' ``execute``; every
    result and the batch's effects equal.  Returns the port's result."""
    want = ri.execute([_TO_REF[type(r)](r) for r in batch])
    got = ti.execute(batch)
    assert len(got.results) == len(want.results) == len(batch)
    for w, g in zip(want.results, got.results):
        _same_result(w, g)
    assert (got.n_get, got.n_put, got.n_scan, got.n_delete, got.merged, got.delta_fill) == \
        (want.n_get, want.n_put, want.n_scan, want.n_delete, want.merged, want.delta_fill)
    assert (ti.merge_count, ti.epoch, ti.delta_overflowed) == \
        (ri.merge_count, ri.epoch, ri.delta_overflowed)
    return got


def test_execute_mixed_batch_equal_reference(rng):
    """Gets, misses, fresh puts, base updates, get-after-put, and scans of
    two windows in one batch, one of them over the batch's own fresh delta
    keys, then a second batch on the live delta."""
    keys, vals = _corpus(rng)
    ri, ti = _pair(keys, vals, delta_capacity=512, auto_merge_threshold=None, scan_window=9)
    batch = (
        [GetRequest(k) for k in keys[:40]]
        + [GetRequest(k + b"~miss") for k in keys[:10]]
        + [PutRequest(b"pp-%03d" % i, 7000 + i) for i in range(30)]
        + [PutRequest(keys[5], 99991), PutRequest(keys[6], 99992)]
        + [GetRequest(b"pp-007"), GetRequest(keys[5])]
        + [ScanRequest(keys[0]), ScanRequest(keys[100][:3]), ScanRequest(b"~~~"),
           ScanRequest(b"pp-"), ScanRequest(b"pp-01", 5), ScanRequest(keys[7], 5)]
    )
    got = run_both(ri, ti, batch)
    fresh = got.results[-3].entries
    assert [k for k, _ in fresh[:9]] == [b"pp-%03d" % i for i in range(9)]
    assert len(got.results[-1].entries) == 5
    run_both(ri, ti, [ScanRequest(keys[i]) for i in range(0, len(keys), 23)]
             + [GetRequest(b"pp-%03d" % i) for i in range(30)])


def test_delete_beats_put_of_same_key_in_one_batch(rng):
    keys, vals = _corpus(rng, 300)
    ri, ti = _pair(keys, vals, delta_capacity=256, auto_merge_threshold=None)
    got = run_both(ri, ti, [
        DeleteRequest(keys[3]), PutRequest(keys[3], 5), GetRequest(keys[3]),
        PutRequest(b"both", 1), DeleteRequest(b"both"), GetRequest(b"both"),
        DeleteRequest(b"never-existed"), ScanRequest(keys[2], 4), ScanRequest(b"bo", 2),
    ])
    assert [int(r.status) for r in got.results[:7]] == [
        Status.OK, Status.OK, Status.NOT_FOUND, Status.OK, Status.OK, Status.NOT_FOUND,
        Status.NOT_FOUND]


def test_per_op_error_statuses_equal_reference(rng):
    """Over-width keys and a full delta come back as statuses; with the
    policy off even an overflow does not merge, until ``merge()``."""
    keys, vals = _corpus(rng, 200)
    ri, ti = _pair(keys, vals, delta_capacity=8, delta_bytes=64, auto_merge_threshold=None)
    wide = b"w" * (ti.width + 1)
    got = run_both(ri, ti, [PutRequest(wide, 1), GetRequest(wide), DeleteRequest(wide),
                            ScanRequest(wide, 3)]
                   + [PutRequest(b"f-%04d" % i, i) for i in range(32)]
                   + [DeleteRequest(keys[1]), GetRequest(keys[0])])
    assert got.results[0].status == Status.REJECTED_OVER_WIDTH
    assert Status.REJECTED_FULL in {r.status for r in got.results[4:-1]}
    assert ti.merge_count == 0 and not got.merged
    ri.merge()
    ti.merge()
    run_both(ri, ti, [GetRequest(b"f-%04d" % i) for i in range(32)] + [DeleteRequest(keys[1])])


def test_auto_merge_inside_execute_equal_reference(rng):
    keys, vals = _corpus(rng, 300)
    ri, ti = _pair(keys, vals, delta_capacity=64, auto_merge_threshold=0.5)
    assert not run_both(ri, ti, [PutRequest(b"zm-%03d" % i, 100 + i) for i in range(20)]).merged
    got = run_both(ri, ti, [PutRequest(b"zm-%03d" % i, 100 + i) for i in range(20, 40)]
                   + [DeleteRequest(keys[0]), ScanRequest(b"zm-", 12)])
    assert got.merged and ti.merge_count == 1 and got.delta_fill == 1 / 64  # the delete
    run_both(ri, ti, [GetRequest(b"zm-%03d" % i) for i in range(40)]
             + [GetRequest(keys[0]), ScanRequest(b"zm-", 12), ScanRequest(b"", 6)])


def test_full_delta_then_merge_equal_reference(rng):
    """Deletes and puts that find the delta full, an explicit merge, then
    the same ops again."""
    keys, vals = _corpus(rng, 150)
    ri, ti = _pair(keys, vals, delta_capacity=8, auto_merge_threshold=None)
    run_both(ri, ti, [PutRequest(b"f-%02d" % i, i) for i in range(8)])
    got = run_both(ri, ti, [DeleteRequest(keys[0]), PutRequest(b"g", 1), GetRequest(keys[0])])
    assert got.results[0].status == Status.REJECTED_FULL
    ri.merge()
    ti.merge()
    run_both(ri, ti, [DeleteRequest(keys[0]), PutRequest(b"g", 1), GetRequest(keys[0]),
                      ScanRequest(b"f-", 10)])


def test_scan_window_grouping_and_default_equal_reference(rng):
    keys, vals = _corpus(rng, 250)
    ri, ti = _pair(keys, vals, scan_window=4)
    got = run_both(ri, ti, [ScanRequest(keys[0]), ScanRequest(keys[0], window=8),
                            ScanRequest(keys[3], window=8), ScanRequest(keys[9])])
    assert [k for k, _ in got.results[0].entries] == keys[:4]
    assert [k for k, _ in got.results[2].entries] == keys[3:11]


def test_tombstones_resurrect_and_merge_equal_reference(rng):
    keys, vals = _corpus(rng, 300)
    ri, ti = _pair(keys, vals, delta_capacity=256, auto_merge_threshold=None)
    run_both(ri, ti, [DeleteRequest(keys[3]), DeleteRequest(b"never-existed"),
                      GetRequest(keys[3]), GetRequest(keys[4]), ScanRequest(keys[2], 4)])
    for r in (ri, ti):
        assert r.delete(keys[3]).status == Status.NOT_FOUND
        assert r.put(b"fresh", 11).ok
        assert r.delete(b"fresh").status == Status.OK and r.get(b"fresh") is None
        put = r.put(keys[3], 777)
        assert put.ok and not put.updated and r.get(keys[3]) == 777
        r.delete(keys[5])
        r.merge()
    assert ri.scan(keys[4], 3) == ti.scan(keys[4], 3) == [
        (keys[4], int(vals[4])), (keys[6], int(vals[6])), (keys[7], int(vals[7]))]
    run_both(ri, ti, [GetRequest(k) for k in keys[:10]] + [ScanRequest(b"", 12)])


def test_convenience_ops_and_64bit_values_equal_reference(rng):
    keys, _ = _corpus(rng, 150)
    vals = (np.arange(len(keys), dtype=np.int64) << 33) + 12345
    vals[::2] = -vals[::2]
    ri, ti = _pair(keys, vals)
    for r in (ri, ti):
        assert r.get(keys[3]) == int(vals[3]) and r.get(b"absent") is None
        first = r.put(b"fresh-key", -(1 << 62))
        assert first.ok and not first.updated
        assert r.put(b"fresh-key", (1 << 62) + 5).updated
    got = run_both(ri, ti, [GetRequest(k) for k in keys[:60]] + [GetRequest(b"fresh-key"),
                                                                 ScanRequest(keys[0], 16)])
    assert [r.value for r in got.results[:60]] == vals[:60].tolist()
    assert got.results[60].value == (1 << 62) + 5
    found, v = ti.get_batch(keys)
    assert found.all() and (v == vals).all()


def test_unknown_request_type_raises():
    keys = [b"a", b"b", b"c"]
    ti = StringIndex.bulk_load(keys, None, IndexConfig(device="cpu"))
    with pytest.raises(TypeError):
        ti.execute([GetRequest(b"a"), object()])
