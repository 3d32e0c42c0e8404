"""The port's compaction against the JAX package, on the CPU: the builder's
bulk replay, ``merge_delta``, the facade's merge with its journal and the
auto-merge.  The same op sequences over the same numpy-made keys go through
both packages' facades (``put_batch``/``delete_batch``; the reference's
``execute`` runs a batch's puts, then its deletes, the same way), and after
each merge every pool, static field, ``height_bound()``, the sorted order,
the epoch and the answers of ``get_batch`` and ``scan_batch`` must be equal
bit for bit, including where the reference loses base puts (the keys a bulk
load loses are carried through a merge in test_torch_index.py, which builds
that key set once for both of its tests)."""
import numpy as np
import pytest

from _torch_cases import scan_entries
from repro.core import LITSBuilder as RBuilder
from repro.core import StringSet as RStringSet
from repro.core import tensor_index as r_ti
from repro.core.strings import random_strings
from repro.index import IndexConfig as RConfig, StringIndex as RIndex
from repro_torch.core import tensor_index as t_ti
from repro_torch.core.builder import LITSBuilder as TBuilder
from repro_torch.core.strings import StringSet as TStringSet
from repro_torch.index import IndexConfig as TConfig, StringIndex as TIndex
from repro_torch.index import facade as t_facade


def _corpus(rng, n):
    keys = sorted(set(random_strings(rng, n, 3, 24)))
    return keys, np.arange(len(keys), dtype=np.int64) * 3 + 1


def _pair(keys, vals, threshold=None, **cfg):
    """The reference's and the port's facades over the same keys."""
    ri = RIndex.bulk_load(keys, vals, RConfig(auto_merge_threshold=threshold, **cfg))
    ti = TIndex.bulk_load(keys, vals, TConfig(device="cpu", auto_merge_threshold=threshold,
                                              **cfg))
    return ri, ti


def _same_index(rti, tti):
    for f in t_ti.DATA_FIELDS:
        a, b = np.asarray(getattr(rti, f)), getattr(tti, f).numpy()
        assert a.shape == b.shape and (a.astype(np.float64) == b.astype(np.float64)).all(), f
    for f in t_ti.STATIC_FIELDS:
        assert getattr(rti, f) == getattr(tti, f), f


def _same(ri, ti, probe, windows=(1, 16)):
    """Every field, the builders' caches, the host mirrors, and the answers
    of get_batch and scan_batch over ``probe`` equal."""
    _same_index(ri.ti, ti.ti)
    if ri._builder is not None:
        assert ri._builder.height_bound() == ti._builder.height_bound()
        np.testing.assert_array_equal(ri._builder.sorted_eids(), ti._builder.sorted_eids())
        assert ri._builder.root_item == ti._builder.root_item
        assert ri._builder.max_suffix_len == ti._builder.max_suffix_len
    assert (ri.epoch, ri.merge_count, ri.delta_fill, ri.delta_overflowed) == \
        (ti.epoch, ti.merge_count, ti.delta_fill, ti.delta_overflowed)
    for a, b in zip(ri.get_batch(probe), ti.get_batch(probe)):
        np.testing.assert_array_equal(a, b)
    for w in windows:
        for a, b in zip(ri.scan_batch(probe, w), ti.scan_batch(probe, w)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _both(ri, ti, puts=(), vals=(), dels=()):
    """A batch's puts, then its deletes, through both facades; their masks
    and merged flags equal."""
    merged = False
    if len(puts):
        want, got = ri.put_batch(list(puts), vals), ti.put_batch(list(puts), vals)
        for a, b in zip(want[:2], got[:2]):
            np.testing.assert_array_equal(a, b)
        assert want[2] == got[2]
        merged |= got[2]
    if len(dels):
        want, got = ri.delete_batch(list(dels)), ti.delete_batch(list(dels))
        for a, b in zip(want[:2], got[:2]):
            np.testing.assert_array_equal(a, b)
        assert want[2] == got[2]
        merged |= got[2]
    return merged


def _oracle_holds(ti, oracle):
    """Every live key reads back its value, and a full scan gives the live
    keys in order with their values."""
    live = sorted(oracle)
    found, vals = ti.get_batch(live)
    assert found.all()
    np.testing.assert_array_equal(vals, [oracle[k] for k in live])
    rows = scan_entries(ti.ti, *ti.scan_batch([b""], len(live) + 16))
    assert rows[0] == [(k, oracle[k]) for k in live]


def test_merge_two_cycles_bit_identical_to_reference():
    """Fresh puts, base updates, deletes and resurrects over two merge
    cycles (the second on the warm caches), held to the reference and to a
    dict oracle."""
    rng = np.random.default_rng(12345)
    keys, vals = _corpus(rng, 400)
    ri, ti = _pair(keys, vals, delta_capacity=1024)
    oracle = {k: int(v) for k, v in zip(keys, vals)}
    probe = keys + [b"m1-%04d" % i for i in range(130)] + [b"m2-%04d" % i for i in range(70)]
    probe += [b"", b"m1-", b"zzz", b"x" * 60]

    def apply(puts, pvals, dels):
        _both(ri, ti, puts, np.asarray(pvals, np.int64), dels)
        oracle.update(zip(puts, pvals))
        for k in dels:
            oracle.pop(k, None)

    apply([b"m1-%04d" % i for i in range(120)] + [keys[3], keys[9], b"m1-0001"],
          [7000 + i for i in range(120)] + [3333, 9999, 70001],
          [keys[5], keys[6], b"m1-0000"])
    ri.merge()
    ti.merge()
    assert ti.epoch == 1 and ti.merge_count == 1 and ti.delta_fill == 0.0
    _same(ri, ti, probe)
    _oracle_holds(ti, oracle)
    apply([keys[5]] + [b"m2-%04d" % i for i in range(60)], [5550] + [8000 + i for i in range(60)],
          [b"m1-0002", keys[9]])
    ri.merge()
    ti.merge()
    assert ti.epoch == 2
    _same(ri, ti, probe)
    _oracle_holds(ti, oracle)


def test_base_value_update_survives_merge():
    """A put to a bulk-loaded key updates its base value in place on the
    device; the merge carries it into the builder, in both cycles."""
    keys, vals = _corpus(np.random.default_rng(7), 100)
    ri, ti = _pair(keys, vals)
    probe = keys + [b"fresh-key", b"fresh-2"]
    _both(ri, ti, [keys[7], b"fresh-key"], np.array([424242, 1]))
    assert ti.get(keys[7]) == 424242
    ri.merge()
    ti.merge()
    assert ti.get(keys[7]) == 424242
    _same(ri, ti, probe)
    _both(ri, ti, [keys[8], b"fresh-2"], np.array([848484, 2]))
    ri.merge()
    ti.merge()
    assert ti.get(keys[8]) == 848484 and ti.get(keys[7]) == 424242
    _same(ri, ti, probe)


def test_bulk_op_failure_invalidates_caches():
    """An over-width key midway through insert_many raises after part of the
    batch landed: the sorted order and height bound are recomputed exactly,
    a freeze finds the landed key, and the retried batch upserts cleanly;
    both packages' builders stay equal throughout."""
    keys, vals = _corpus(np.random.default_rng(8), 80)
    rb, tb = RBuilder(), TBuilder(device="cpu")
    rb.bulkload(RStringSet.from_list(keys), np.asarray(vals), width=32)
    tb.bulkload(TStringSet.from_list(keys), np.asarray(vals), width=32)
    ok1, ok2 = b"aa-new-1", b"aa-new-2"
    bad = b"aa-new-1" + b"x" * 40          # sorts between them, longer than the width
    for b in (rb, tb):
        with pytest.raises(ValueError):
            b.insert_many([ok1, bad, ok2], np.array([1, 2, 3], np.int64))
    assert list(tb.sorted_eids()) == list(tb.iter_subtree(tb.root_item))
    np.testing.assert_array_equal(rb.sorted_eids(), tb.sorted_eids())
    assert rb.height_bound() == tb.height_bound()
    rti, tti = r_ti.freeze(rb), t_ti.freeze(tb)
    _same_index(rti, tti)
    qb, ql = t_ti.pad_queries([ok1, ok2, keys[0]], tti.width)
    import torch

    found, _, _ = t_ti.search_batch(tti, torch.from_numpy(qb), torch.from_numpy(ql))
    assert found.tolist() == [True, False, True]
    ins = [b.insert_many([ok1, ok2], np.array([10, 30], np.int64)) for b in (rb, tb)]
    np.testing.assert_array_equal(ins[0], ins[1])
    assert ins[1].tolist() == [False, True]
    srt = tb.sorted_eids()
    assert len(set(srt.tolist())) == len(srt)
    assert tb.get(ok1) == 10 and tb.get(ok2) == 30 and tb.get(bad) is None
    _same_index(r_ti.freeze(rb), t_ti.freeze(tb))
    assert rb.height_bound() == tb.height_bound()


def test_facade_merge_seams_redrain_midmerge_writes():
    """begin/run/commit by hand: writes landed between begin and commit are
    journaled and replayed onto the merged index (nothing lost, nothing
    resurrected); abort keeps the live index."""
    keys, vals = _corpus(np.random.default_rng(9), 150)
    ri, ti = _pair(keys, vals, delta_capacity=1024)
    probe = keys + [b"pre-%03d" % i for i in range(40)] + [b"mid-%03d" % i for i in range(25)]
    _both(ri, ti, [b"pre-%03d" % i for i in range(40)], np.arange(40))
    tickets = [ix.begin_merge() for ix in (ri, ti)]
    for ix in (ri, ti):
        with pytest.raises(RuntimeError):
            ix.begin_merge()
    _both(ri, ti, [b"mid-%03d" % i for i in range(25)] + [keys[4]],
          np.array([500 + i for i in range(25)] + [404]), [keys[2]])
    redrained = [ix.commit_merge(t, ix.run_merge(t)) for ix, t in zip((ri, ti), tickets)]
    assert redrained == [27, 27]
    assert ti.epoch == 1
    assert ti.get(b"mid-007") == 507 and ti.get(b"pre-007") == 7
    assert ti.get(keys[2]) is None and ti.get(keys[4]) == 404
    _same(ri, ti, probe)
    for ix in (ri, ti):
        ix.abort_merge(ix.begin_merge())
        ix.merge()
    assert ti.epoch == 2 and ti.get(b"mid-007") == 507
    _same(ri, ti, probe)


def test_redrain_pads_to_pow2_with_sentinel_rows():
    """The commit pads each replayed batch to a power of two with over-width
    rows, as the reference does: they claim nothing, but they are ops that
    are not base puts, so a journaled base put to entry 0 is lost in both
    packages, through the same pad rows."""
    qb = np.arange(15, dtype=np.uint8).reshape(5, 3)
    ql = np.array([1, 2, 3, 1, 2], np.int32)
    lo = np.arange(5, dtype=np.int32)
    from repro.index import facade as r_facade

    for got, want in zip(t_facade._pad_batch_pow2(qb, ql, lo, lo + 1),
                         r_facade._pad_batch_pow2(qb, ql, lo, lo + 1)):
        np.testing.assert_array_equal(got, want)
    assert t_facade._pad_batch_pow2(qb, ql, lo, lo)[1].tolist() == [1, 2, 3, 1, 2, 4, 4, 4]
    journal = [("put", qb[:2], ql[:2], lo[:2], lo[:2]), ("put", qb[2:], ql[2:], lo[2:], lo[2:]),
               ("delete", qb, ql, None, None)]
    got, want = t_facade._coalesce_journal(journal), r_facade._coalesce_journal(journal)
    assert [g[0] for g in got] == [w[0] for w in want] == ["put", "delete"]
    np.testing.assert_array_equal(got[0][1], want[0][1])

    keys = [b"k%05d" % i for i in range(300)]
    ri, ti = _pair(keys, np.arange(300, dtype=np.int64), delta_capacity=64)
    probe = keys + [b"new-%d" % i for i in range(5)]
    tickets = [ix.begin_merge() for ix in (ri, ti)]
    _both(ri, ti, [b"k00000", b"new-0", b"new-1"], np.array([777, 1, 2]))
    for ix, t in zip((ri, ti), tickets):
        ix.commit_merge(t, ix.run_merge(t))
    assert ti.get(b"k00000") == 0                  # the journaled put is lost at commit
    _same(ri, ti, probe)


def test_auto_merge_from_put_batch():
    """At the default threshold (0.75) a put batch that leaves the delta at
    least that full merges, in both packages at the same batch; a delete
    batch and an overflowing batch merge too."""
    rng = np.random.default_rng(10)
    keys, vals = _corpus(rng, 300)
    ri, ti = _pair(keys, vals, threshold=0.75, delta_capacity=64)
    assert TConfig().auto_merge_threshold == RConfig().auto_merge_threshold == 0.75
    fresh = [b"auto-%04d" % i for i in range(400)]
    probe = keys + fresh
    merges = []
    for b in range(6):
        batch = fresh[b * 20: (b + 1) * 20] + keys[b * 7: b * 7 + 5]
        merges.append(_both(ri, ti, batch, rng.integers(0, 1 << 40, len(batch))))
        _same(ri, ti, probe, windows=(16,))
    assert merges == [False, False, True, False, False, True]
    assert ti.epoch == 2 and ti.merge_count == 2
    # deletes that claim tombstones cross the threshold as well
    assert _both(ri, ti, dels=keys[100:150])
    _same(ri, ti, probe, windows=(16,))
    # a batch larger than the pool overflows it and merges
    assert _both(ri, ti, fresh[200:300], np.arange(100))
    assert ti.epoch == 4 and not ti.delta_overflowed
    _same(ri, ti, probe, windows=(16,))


@pytest.mark.parametrize("kind", ["grow", "shrink"])
def test_rebuild_at_both_ways(kind):
    """Growth past ``RESIZE_GROW`` slots' worth of keys under one model node,
    and shrinking under ``RESIZE_SHRINK``, rebuild that node's subtree
    (``_rebuild_at``) in both packages alike."""
    rng = np.random.default_rng(11)
    keys = sorted({b"p/%02d/%03d" % (i % 40, int(rng.integers(0, 900))) for i in range(600)})
    ri, ti = _pair(keys, np.arange(len(keys), dtype=np.int64), delta_capacity=4096)
    rebuilt = []
    real = TBuilder._rebuild_at

    def counted(self, loc, item):
        rebuilt.append(loc)
        return real(self, loc, item)

    TBuilder._rebuild_at = counted
    try:
        if kind == "grow":
            extra = [b"p/07/%03d/%02d" % (i, j) for i in range(0, 900, 3) for j in range(6)]
            _both(ri, ti, extra, np.arange(len(extra)))
            probe = keys + extra[::5]
        else:
            gone = [k for k in keys if not k.startswith(b"p/3")] + keys[::97]
            _both(ri, ti, dels=gone)
            probe = keys
        ri.merge()
        ti.merge()
    finally:
        TBuilder._rebuild_at = real
    assert rebuilt
    _same(ri, ti, probe)



@pytest.mark.parametrize("base", ["live", "emptied"])
def test_merge_rebuilds_a_missing_builder(base):
    """An index wrapped without a builder (as the reference's ``load``
    gives one) rebuilds it from the live pools at its first merge: the live
    entries bulk-loaded anew, or for an index whose entries were all
    deleted, an empty builder with a uniform HPT, so that the dead entry 0
    the frozen order pads with does not come back."""
    keys, vals = _corpus(np.random.default_rng(13), 60)
    ri, ti = _pair(keys, vals)
    if base == "emptied":
        _both(ri, ti, dels=keys)
        ri.merge()
        ti.merge()
    ri = RIndex(None, ri.ti, ri.config)
    ti = TIndex(None, ti.ti, ti.config)
    probe = keys + [b"only-key", b"other-key"]
    _both(ri, ti, [b"only-key", keys[1]], np.array([7, 8]), [keys[2]])
    ri.merge()
    ti.merge()
    _same(ri, ti, probe)
    assert ti.get(b"only-key") == 7 and ti.get(keys[2]) is None
    assert (ti.get(keys[0]) is None) == (base == "emptied")
    _both(ri, ti, [b"other-key"], np.array([9]))
    ri.merge()
    ti.merge()
    _same(ri, ti, probe)
