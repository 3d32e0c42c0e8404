"""The port's snapshots against the JAX package, on the CPU.

A snapshot is the reference's versioned ``.npz`` format: a round trip in the
port answers as the index did; a file of another magic or version raises the
typed errors; files at versions 1-3, made as the reference's tests make
them, load with the fields they lack made as the reference makes them; and
a snapshot saved by either package, with a live delta holding tombstones,
loads in the other and answers ``get_batch``, ``scan_batch`` and ``execute``
identically, every field equal.
"""
import json

import numpy as np
import pytest
import torch

from repro.core.strings import random_strings
from repro.index import (
    DeleteRequest as RDelete, GetRequest as RGet, IndexConfig as RConfig,
    PutRequest as RPut, StringIndex as RIndex,
)
from repro_torch.core import tensor_index as t_ti
from repro_torch.index import (
    DeleteRequest, GetRequest, IndexConfig, PutRequest, SnapshotFormatError,
    SnapshotVersionError, Status, StringIndex,
)
from repro_torch.index.snapshot import SNAPSHOT_VERSION


def _corpus(rng, n=300):
    keys = sorted(set(random_strings(rng, n, 3, 24)))
    return keys, np.arange(len(keys), dtype=np.int64) * 3 + 1


def _cpu(**kw):
    return IndexConfig(device="cpu", auto_merge_threshold=None, **kw)


def _same_fields(rti, tti):
    """Every data field (values and shape) and static field equal."""
    for f in t_ti.DATA_FIELDS:
        a, b = np.asarray(getattr(rti, f)), getattr(tti, f).numpy()
        assert a.shape == b.shape and (a.astype(np.float64) == b.astype(np.float64)).all(), f
    for f in t_ti.STATIC_FIELDS:
        assert getattr(rti, f) == getattr(tti, f), f


def _same_answers(ri, ti, probe):
    for a, b in zip(ri.get_batch(probe), ti.get_batch(probe)):
        np.testing.assert_array_equal(a, b)
    for w in (1, 9):
        for a, b in zip(ri.scan_batch(probe, w), ti.scan_batch(probe, w)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert ri.scan(b"", 40) == ti.scan(b"", 40)


def _rewrite(path, out, version, drop=()):
    """``path`` rewritten at ``version`` without the members ``drop``."""
    with open(path, "rb") as f:
        z = np.load(f, allow_pickle=False)
        arrays = {n: z[n] for n in z.files if n != "__snapshot_meta__" and n not in drop}
        header = json.loads(bytes(z["__snapshot_meta__"]).decode())
    header["version"] = version
    header["data_fields"] = sorted(arrays)
    meta = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    with open(out, "wb") as f:
        np.savez_compressed(f, __snapshot_meta__=meta, **arrays)


def test_roundtrip_answers_as_before(rng, tmp_path):
    keys, vals = _corpus(rng, 400)
    index = StringIndex.bulk_load(keys, vals, _cpu(delta_capacity=128))
    index.execute([PutRequest(b"dl-%03d" % i, i) for i in range(30)]
                  + [DeleteRequest(keys[4]), PutRequest(keys[5], -9)])
    path = str(tmp_path / "idx.snap")
    index.save(path)
    restored = StringIndex.load(path, _cpu())
    assert restored.ti.device.type == "cpu" and restored._builder is None
    for f in t_ti.DATA_FIELDS:
        a, b = getattr(index.ti, f), getattr(restored.ti, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    probe = keys[::7] + [b"dl-%03d" % i for i in range(30)] + [keys[4], keys[5], b"nope"]
    for a, b in zip(index.get_batch(probe), restored.get_batch(probe)):
        np.testing.assert_array_equal(a, b)
    assert index.scan(b"", 50) == restored.scan(b"", 50)
    assert (restored.delta_fill, restored.epoch) == (index.delta_fill, index.epoch)


def test_file_holds_the_reference_dtypes(rng, tmp_path):
    """``de_hash`` is written as uint32 and the scalars with shape ()."""
    keys, vals = _corpus(rng, 100)
    index = StringIndex.bulk_load(keys, vals, _cpu())
    index.execute([PutRequest(b"x", 1)])
    path = str(tmp_path / "idx.snap")
    index.save(path)
    with np.load(path, allow_pickle=False) as z:
        assert z.files[0] == "__snapshot_meta__"
        header = json.loads(bytes(z["__snapshot_meta__"]).decode())
        assert header["version"] == SNAPSHOT_VERSION == 4
        assert header["data_fields"] == sorted(t_ti.DATA_FIELDS)
        assert z["de_hash"].dtype == np.uint32
        for name in ("db_used", "de_count", "delta_overflow", "epoch", "root_item"):
            assert z[name].shape == (), name


def test_version_and_format_errors(rng, tmp_path):
    keys, vals = _corpus(rng, 120)
    index = StringIndex.bulk_load(keys, vals, _cpu())
    path = str(tmp_path / "idx.snap")
    index.save(path)
    bad_version = str(tmp_path / "v99.snap")
    _rewrite(path, bad_version, 99)
    with pytest.raises(SnapshotVersionError):
        StringIndex.load(bad_version, _cpu())
    z = dict(np.load(path, allow_pickle=False))
    hdr = json.loads(bytes(z["__snapshot_meta__"]).decode())
    hdr["magic"] = "not-lits"
    z["__snapshot_meta__"] = np.frombuffer(json.dumps(hdr).encode(), np.uint8)
    bad_magic = str(tmp_path / "magic.snap")
    with open(bad_magic, "wb") as f:
        np.savez_compressed(f, **z)
    with pytest.raises(SnapshotFormatError):
        StringIndex.load(bad_magic, _cpu())
    garbled = str(tmp_path / "garbled.snap")
    z["__snapshot_meta__"] = np.frombuffer(b"\xff{not json", np.uint8)
    with open(garbled, "wb") as f:
        np.savez_compressed(f, **z)
    with pytest.raises(SnapshotFormatError):
        StringIndex.load(garbled, _cpu())
    missing = str(tmp_path / "missing.snap")
    _rewrite(path, missing, 4, drop=("dh_slot",))
    with pytest.raises(SnapshotFormatError, match="dh_slot"):
        StringIndex.load(missing, _cpu())
    not_snap = str(tmp_path / "random.npz")
    with open(not_snap, "wb") as f:
        np.savez_compressed(f, a=np.arange(3))
    with pytest.raises(SnapshotFormatError):
        StringIndex.load(not_snap, _cpu())


def test_snapshot_carries_tombstones_and_reads_v1(rng, tmp_path):
    keys, vals = _corpus(rng, 150)
    index = StringIndex.bulk_load(keys, vals, _cpu())
    index.execute([DeleteRequest(keys[9]), PutRequest(b"dl-1", 5)])
    path = str(tmp_path / "v4.snap")
    index.save(path)
    restored = StringIndex.load(path, _cpu())
    assert restored.get(keys[9]) is None and restored.get(b"dl-1") == 5
    assert restored.get(keys[10]) == int(vals[10])
    # a v1 file, made from a delete-free index as the reference's test makes it
    live = StringIndex.bulk_load(keys, vals, _cpu())
    live.execute([PutRequest(b"dl-1", 5), PutRequest(b"dl-0", 4)])
    path_live, v1 = str(tmp_path / "live.snap"), str(tmp_path / "v1.snap")
    live.save(path_live)
    _rewrite(path_live, v1, 1, drop=("de_tomb", "epoch", "ds_order"))
    old = StringIndex.load(v1, _cpu())
    ref_old = RIndex.load(v1, RConfig(auto_merge_threshold=None))
    _same_fields(ref_old.ti, old.ti)
    assert old.get(keys[9]) == int(vals[9]) and old.get(b"dl-1") == 5
    assert old.scan(b"dl-", 2) == [(b"dl-0", 4), (b"dl-1", 5)]
    assert old.delete(b"dl-1").status == Status.OK


def test_epoch_roundtrips_through_snapshot_v3(rng, tmp_path):
    keys, vals = _corpus(rng, 120)
    index = StringIndex.bulk_load(keys, vals, _cpu())
    index.execute([PutRequest(b"x-%03d" % i, i) for i in range(30)])
    index.merge()
    index.execute([PutRequest(b"y-%03d" % i, i) for i in range(10)])
    index.merge()
    assert index.epoch == 2
    p, p3 = str(tmp_path / "epoch.snap"), str(tmp_path / "v3.snap")
    index.save(p)
    with np.load(p, allow_pickle=False) as z:
        assert int(z["epoch"]) == 2
    _rewrite(p, p3, 3, drop=("ds_order",))
    for path in (p, p3):
        loaded = StringIndex.load(path, _cpu())
        assert loaded.epoch == 2 and loaded.get(b"x-007") == 7
        _same_fields(RIndex.load(path, RConfig(auto_merge_threshold=None)).ti, loaded.ti)
        loaded.execute([PutRequest(b"z-000", 99)])
        loaded.merge()
        assert loaded.epoch == 3 and loaded.get(b"z-000") == 99


def test_snapshot_v2_loads_with_epoch_zero(rng, tmp_path):
    keys, vals = _corpus(rng, 100)
    index = StringIndex.bulk_load(keys, vals, _cpu())
    index.execute([PutRequest(b"d-%03d" % i, 100 + i) for i in range(20)])
    index.merge()
    index.execute([PutRequest(b"d-1", 7), DeleteRequest(b"d-003"), DeleteRequest(keys[0])])
    p4, p2 = str(tmp_path / "v4.snap"), str(tmp_path / "v2.snap")
    index.save(p4)
    _rewrite(p4, p2, 2, drop=("epoch", "ds_order"))
    loaded = StringIndex.load(p2, _cpu())
    ref = RIndex.load(p2, RConfig(auto_merge_threshold=None))
    _same_fields(ref.ti, loaded.ti)
    assert loaded.epoch == 0 and loaded.get(b"d-007") == 107 and loaded.get(b"d-003") is None
    assert [k for k, _ in loaded.scan(b"d-", 5)] == [b"d-000", b"d-001", b"d-002", b"d-004",
                                                     b"d-005"]
    loaded.execute([PutRequest(b"post-v2", 5)])
    loaded.merge()
    assert loaded.epoch == 1 and loaded.get(b"post-v2") == 5 and loaded.get(keys[0]) is None


def test_emptied_index_does_not_resurrect_dead_keys_after_load(rng, tmp_path):
    keys, vals = _corpus(rng, 60)
    index = StringIndex.bulk_load(keys, vals, _cpu())
    index.execute([DeleteRequest(k) for k in keys])
    index.merge()
    assert index.scan(b"", 10) == []
    p = str(tmp_path / "empty.snap")
    index.save(p)
    loaded = StringIndex.load(p, _cpu())
    loaded.execute([PutRequest(b"only-key", 7)])
    loaded.merge()
    assert loaded.get(keys[0]) is None and loaded.get(b"only-key") == 7
    assert [k for k, _ in loaded.scan(b"", 10)] == [b"only-key"]


def _live_delta(index_cls, config, keys, vals, put, get, delete):
    """A facade of either package with a merged epoch and a live delta that
    holds fresh keys, updates, a resurrected key and tombstones of base and
    delta keys."""
    index = index_cls.bulk_load(keys, vals, config)
    index.execute([put(b"m-%03d" % i, i) for i in range(12)])
    index.merge()
    index.execute([put(b"dl-%03d" % i, 1000 + i) for i in range(20)]
                  + [put(keys[1], -(1 << 40)), put(b"m-003", 33)]
                  + [delete(keys[2]), delete(b"m-004"), delete(b"dl-005"), delete(keys[6])])
    index.execute([put(keys[6], 66), get(keys[0])])
    return index


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_snapshot_loads_across_packages(rng, tmp_path, saver):
    """A snapshot saved by one package, with a live delta holding tombstones,
    loads in the other: every field equal, and ``get_batch``, ``scan_batch``
    and a mixed ``execute`` answer identically, then again after a merge."""
    keys, vals = _corpus(rng, 300)
    ri = _live_delta(RIndex, RConfig(delta_capacity=128, auto_merge_threshold=None), keys, vals,
                     RPut, RGet, RDelete)
    ti = _live_delta(StringIndex, _cpu(delta_capacity=128), keys, vals, PutRequest,
                     GetRequest, DeleteRequest)
    _same_fields(ri.ti, ti.ti)
    path = str(tmp_path / f"{saver}.snap")
    (ri if saver == "reference" else ti).save(path)
    ri2 = RIndex.load(path, RConfig(auto_merge_threshold=None))
    ti2 = StringIndex.load(path, _cpu())
    _same_fields(ri2.ti, ti2.ti)
    _same_fields(ri.ti, ti2.ti)
    assert (ri2.delta_fill, ri2.epoch, ri2.delta_overflowed) == \
        (ti2.delta_fill, ti2.epoch, ti2.delta_overflowed)
    probe = (keys[::5] + [b"dl-%03d" % i for i in range(20)] + [b"m-%03d" % i for i in range(12)]
             + [keys[1], keys[2], keys[6], b"", b"zzz"])
    _same_answers(ri2, ti2, probe)
    want = ri2.execute([RPut(b"after", 1), RDelete(keys[3]), RGet(keys[3]), RGet(b"dl-005")])
    got = ti2.execute([PutRequest(b"after", 1), DeleteRequest(keys[3]), GetRequest(keys[3]),
                       GetRequest(b"dl-005")])
    assert [(int(r.status), r.value, r.updated) for r in want.results] == \
        [(int(r.status), r.value, r.updated) for r in got.results]
    ri2.merge()
    ti2.merge()
    _same_answers(ri2, ti2, probe + [b"after"])
