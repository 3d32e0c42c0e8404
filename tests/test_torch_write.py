"""The port's write path against the JAX package, on the CPU: insert_batch,
delete_batch, the sorted delta view and the facade's put/delete.  The same
numpy-seeded op sequences go through both packages; every delta field,
``ent_val_*`` and the returned masks must be equal after each batch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LITSBuilder as RBuilder, StringSet as RStringSet
from repro.core import tensor_index as r_ti
from repro.core.strings import random_strings
from repro.index import IndexConfig as RConfig, StringIndex as RIndex
from repro_torch.convert import tensor_index_from_reference
from repro_torch.core import tensor_index as t_ti
from repro_torch.index import IndexConfig as TConfig, StringIndex as TIndex

WRITE_FIELDS = ("db_bytes", "db_used", "de_off", "de_len", "de_val_lo", "de_val_hi",
                "de_hash", "de_tomb", "de_count", "dh_slot", "ds_order", "delta_overflow",
                "ent_val_lo", "ent_val_hi")


def _pair(keys, width=None, **freeze_kw):
    """A reference index and the port's copy of it (carried by convert.py)."""
    rb = RBuilder()
    rb.bulkload(RStringSet.from_list(list(keys)), np.arange(len(keys), dtype=np.int64),
                width=width)
    rti = r_ti.freeze(rb, **freeze_kw)
    arrays = {f: np.asarray(getattr(rti, f)) for f in t_ti.DATA_FIELDS}
    static = {f: getattr(rti, f) for f in t_ti.STATIC_FIELDS}
    return rb, rti, tensor_index_from_reference(arrays, static, device="cpu")


def _same(rti, tti, fields=t_ti.DATA_FIELDS):
    for f in fields:
        a, b = np.asarray(getattr(rti, f)), getattr(tti, f).numpy()
        assert a.shape == b.shape and (a.astype(np.int64) == b.astype(np.int64)).all(), f


class _Both:
    """Runs every write batch through both packages and checks them equal."""

    def __init__(self, rti, tti):
        self.rti, self.tti = rti, tti

    def put(self, keys, vals):
        qb, ql = r_ti.pad_queries(keys, self.rti.width)
        v = np.asarray(vals, np.int64)
        lo = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        hi = (v >> 32).astype(np.int32)
        self.rti, *rm = r_ti.insert_batch(self.rti, jnp.asarray(qb), jnp.asarray(ql),
                                          jnp.asarray(lo), jnp.asarray(hi))
        self.tti, *tm = t_ti.insert_batch(self.tti, torch.from_numpy(qb), torch.from_numpy(ql),
                                          torch.from_numpy(lo), torch.from_numpy(hi))
        return self._check(rm, tm)

    def delete(self, keys):
        qb, ql = r_ti.pad_queries(keys, self.rti.width)
        self.rti, *rm = r_ti.delete_batch(self.rti, jnp.asarray(qb), jnp.asarray(ql))
        self.tti, *tm = t_ti.delete_batch(self.tti, torch.from_numpy(qb), torch.from_numpy(ql))
        return self._check(rm, tm)

    def _check(self, rm, tm):
        for a, b in zip(rm, tm):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        _same(self.rti, self.tti, WRITE_FIELDS)
        return [b.numpy() for b in tm]

    def get(self, keys):
        qb, ql = r_ti.pad_queries(keys, self.rti.width)
        rf, re, rd = r_ti.search_batch(self.rti, jnp.asarray(qb), jnp.asarray(ql), backend="jnp")
        tf, te, td = t_ti.search_batch(self.tti, torch.from_numpy(qb), torch.from_numpy(ql))
        for a, b in zip((rf, re, rd), (tf, te, td)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        lo, hi = t_ti.lookup_values(self.tti, te, td)
        return tf.numpy(), (hi.long() << 32 | (lo.long() & 0xFFFFFFFF)).numpy()


def _sequence(rng, keys, fresh, n_batches, B):
    """Batches of B ops: puts and deletes of base keys, fresh keys and
    over-width keys, with duplicates inside a batch."""
    out = []
    for i in range(n_batches):
        pick = [keys[j] for j in rng.integers(0, len(keys), B // 2)]
        pick += [fresh[j] for j in rng.integers(0, len(fresh), B - B // 2 - 2)]
        pick += [pick[0], b"o" * 40]                     # a duplicate, an over-width key
        pick = [pick[j] for j in rng.permutation(len(pick))]
        out.append(("delete" if i % 3 == 1 else "put", pick,
                    rng.integers(-(1 << 62), 1 << 62, B)))
    return out


@pytest.mark.parametrize("capacity", [256, 12])
def test_write_sequence_fields_equal(capacity):
    """Insert/delete/resurrect sequences: with room to spare, and with a
    12-entry pool (a 32-slot hash table) whose probe chains collide and
    whose claims overflow."""
    rng = np.random.default_rng(100 + capacity)
    keys = sorted(set(random_strings(rng, 300, 2, 14)))
    _, rti, tti = _pair(keys, width=24, delta_capacity=capacity)
    both = _Both(rti, tti)
    fresh = [b"fresh-%03d" % i for i in range(60)] + [k + b"~" for k in keys[:20]]
    seen = set()
    for kind, batch, vals in _sequence(rng, keys, fresh, 9, 32):
        if kind == "put":
            ins, upd = both.put(batch, vals)
            seen |= {k for k, a in zip(batch, ins) if a}
        else:
            both.delete(batch)
    assert seen  # some inserts landed
    f, _ = both.get(keys + fresh)
    assert f.any() and not f.all()
    if capacity == 12:
        assert bool(both.tti.delta_overflow) and int(both.tti.de_count) == 12


def test_resurrect_and_delete_delta_only_keys():
    keys = [b"k-%03d" % i for i in range(0, 60, 2)]
    _, rti, tti = _pair(keys, width=16, delta_capacity=64)
    both = _Both(rti, tti)
    ins, upd = both.put([b"k-001", b"k-003", b"k-004"], [1, 3, 4])
    assert ins.tolist() == [True, True, False] and upd.tolist() == [False, False, True]
    deleted, rej = both.delete([b"k-001", b"k-006", b"k-007", b"k-006"])
    assert deleted.tolist() == [True, True, False, False] and not rej.any()
    ins, upd = both.put([b"k-006", b"k-001", b"k-006"], [60, 10, 61])   # resurrect both
    assert ins.tolist() == [True, True, False] and upd.tolist() == [False, False, True]
    f, v = both.get([b"k-001", b"k-006", b"k-003", b"k-007"])
    assert f.tolist() == [True, True, True, False] and v[:3].tolist() == [10, 61, 3]


def test_near_full_byte_pool():
    """The byte-pool gate uses the key's true length: five 4-byte keys fill
    a 20-byte pool exactly, and the sixth overflows without corrupting the
    earlier entries."""
    _, rti, tti = _pair([b"base-a", b"base-b", b"base-c"], width=16,
                        delta_capacity=8, delta_bytes=20)
    both = _Both(rti, tti)
    new = [b"dk%02d" % i for i in range(5)]
    ins, _ = both.put(new, range(5))
    assert ins.all() and not bool(both.tti.delta_overflow)
    ins, _ = both.put([b"dk99"], [9])
    assert not ins.any() and bool(both.tti.delta_overflow)
    f, v = both.get(new)
    assert f.all() and v.tolist() == list(range(5))


def test_overwidth_keys_rejected():
    rng = np.random.default_rng(7)
    keys = sorted(set(random_strings(rng, 200, 2, 12)))
    _, rti, tti = _pair(keys, delta_capacity=64)
    W = tti.width
    both = _Both(rti, tti)
    longs = [b"L" * (W + 4), b"L" * W + b"diff"]
    ins, upd = both.put(longs, [1, 2])
    assert not ins.any() and not upd.any() and not bool(both.tti.delta_overflow)
    deleted, rej = both.delete(longs)
    assert not deleted.any() and not rej.any()
    assert int(both.tti.de_count) == 0
    f, _ = both.get(longs + keys[:5])
    assert f.tolist() == [False, False] + [True] * 5


def test_eid0_base_put_lost():
    """The reference's base-value scatter writes index 0 with the old value
    for every op that is not a base put, and XLA keeps the last write: a put
    to entry 0 followed in its batch by any other op is lost (still reported
    as updated).  The port reproduces it: value 0, the old one."""
    keys = [b"k%05d" % i for i in range(667)]
    rb, rti0, tti0 = _pair(keys)
    assert rb.key_at(0) == b"k00000"
    got = []
    for batch in ([b"k00000"], [b"k00000", b"zzz-new"], [b"zzz-new2", b"k00000"]):
        both = _Both(rti0, tti0)
        _, upd = both.put(batch, [777] * len(batch))
        assert upd.tolist() == [k == b"k00000" for k in batch]
        got.append(both.get([b"k00000"])[1][0])
    assert got == [777, 0, 777]


@pytest.mark.parametrize("width", [16, 13])
def test_delta_sort_order_unclaimed_tails(width):
    """The sorted delta view over random pools with unclaimed tail slots:
    shared prefixes, length ties, zero bytes, and widths that do and do not
    fill the last packed word."""
    rng = np.random.default_rng(width)
    dcap, dbcap = 64, 64 * width
    db = rng.integers(0, 3, dbcap).astype(np.uint8)       # few symbols: many ties
    off = rng.integers(0, dbcap - width, dcap).astype(np.int32)
    off[10:20] = off[0]                                     # equal keys
    ln = rng.integers(0, width + 1, dcap).astype(np.int32)
    for count in (0, 1, 37, dcap):
        for blank_tail in (False, True):
            o, n = off.copy(), ln.copy()
            if blank_tail:                  # unclaimed slots as freeze leaves them
                o[count:], n[count:] = 0, 0
            want = r_ti.delta_sort_order(jnp.asarray(db), jnp.asarray(o), jnp.asarray(n),
                                         jnp.int32(count), width)
            got = t_ti.delta_sort_order(torch.from_numpy(db), torch.from_numpy(o),
                                        torch.from_numpy(n),
                                        torch.tensor(count, dtype=torch.int32), width)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            tail = got.numpy()[count:].tolist()
            assert sorted(tail) == list(range(count, dcap))      # unclaimed sort last
            if blank_tail:
                assert tail == list(range(count, dcap))          # tied: index order


def test_mutate_batch_never_syncs(monkeypatch):
    """The write path reads no tensor back to the host: with the base walk
    done beforehand, every host conversion of a tensor raises."""
    keys = [b"k-%03d" % i for i in range(0, 60, 2)]
    _, _, tti = _pair(keys, width=16, delta_capacity=16)
    qb, ql = t_ti.pad_queries([b"k-001", b"k-002", b"k-001", b"x" * 20], 16)
    qb, ql = torch.from_numpy(qb), torch.from_numpy(ql)
    walk = t_ti.fused_search(tti, qb, ql)
    monkeypatch.setattr(t_ti, "fused_search", lambda *a: walk)

    def no_sync(*a, **k):
        raise AssertionError("host sync in the write path")

    for name in ("__bool__", "item", "__int__", "__index__", "__float__", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    z = torch.zeros(4, dtype=torch.int32)
    nti, ins, upd = t_ti.insert_batch(tti, qb, ql, z + 5, z)
    nti, deleted, rej = t_ti.delete_batch(nti, qb, ql)
    monkeypatch.undo()
    assert ins.tolist() == [True, False, False, False]
    assert upd.tolist() == [False, True, True, False]
    assert deleted.tolist() == [True, True, False, False] and int(nti.de_count) == 2


def test_facade_writes_match_reference():
    """put_batch/delete_batch through both facades, with no auto-merge, up
    to a full delta: masks, gets, and the host mirrors."""
    rng = np.random.default_rng(21)
    keys = sorted(set(random_strings(rng, 400, 3, 16)))
    vals = rng.integers(-(1 << 62), 1 << 62, len(keys), dtype=np.int64)
    kw = dict(width=24, delta_capacity=128)
    ri = RIndex.bulk_load(keys, vals, RConfig(auto_merge_threshold=None, **kw))
    ti = TIndex.bulk_load(keys, vals, TConfig(device="cpu", auto_merge_threshold=None, **kw))
    assert ti.delta_fill == 0.0 and not ti.delta_overflowed and ti.epoch == 0
    fresh = [b"new-%04d" % i for i in range(150)]
    ops = [("put", keys[:30] + fresh[:40]), ("delete", keys[20:50] + fresh[30:45]),
           ("put", keys[25:35] + fresh[40:100]), ("delete", fresh[95:150] + [b"absent"])]
    for kind, batch in ops:
        if kind == "put":
            v = rng.integers(0, 1 << 40, len(batch))
            want, got = ri.put_batch(batch, v), ti.put_batch(batch, v)
        else:
            want, got = ri.delete_batch(batch), ti.delete_batch(batch)
        for a, b in zip(want[:2], got[:2]):
            np.testing.assert_array_equal(a, b)
        assert got[2] is False and want[2] is False
        assert ti.delta_fill == ri.delta_fill and ti.delta_overflowed == ri.delta_overflowed
        probe = keys + fresh + [b"absent", b"z" * 30]
        for a, b in zip(ri.get_batch(probe), ti.get_batch(probe)):
            np.testing.assert_array_equal(a, b)
    assert ti.delta_overflowed                      # the last puts overflowed 128 slots
    assert t_ti.delta_fill_fraction(ti.ti) == ti.delta_fill == 1.0
    assert ti.put_batch([], [])[0].shape == (0,) and ti.delete_batch([])[1].shape == (0,)
