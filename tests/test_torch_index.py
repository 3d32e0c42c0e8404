"""The port's main path against the JAX package, on the CPU: bulk load →
freeze → batched point lookup.  Pools, (found, eid, is_delta, levels) and
values must be equal bit for bit."""
import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (WORD_BATCHES_CPU, WORD_WIDTH, trimmed, underflow_keys,
                          underflow_table, word_edge_case, word_edge_indexes, word_rows)
from repro.core import LITSBuilder as RBuilder, LITSConfig as RLITSConfig
from repro.core import StringSet as RStringSet
from repro.core import tensor_index as r_ti
from repro.core.strings import random_strings
from repro.index import IndexConfig as RConfig, StringIndex as RIndex
from repro.kernels import ops as r_ops
from repro_torch.convert import tensor_index_from_reference
from repro_torch.core import tensor_index as t_ti
from repro_torch.core.builder import LITSBuilder as TBuilder, LITSConfig as TLITSConfig
from repro_torch.core.strings import StringSet as TStringSet
from repro_torch.data import synthetic
from repro_torch.index import IndexConfig as TConfig, StringIndex as TIndex
from repro_torch.kernels import _build, traverse

DATA_FIELDS = list(t_ti.DATA_FIELDS)


# the corpora of tests/test_kernels.py, rebuilt here from the same seeds
def _skewed(rng):
    keys = set()
    for grp in (b"app/events/", b"app/users/", b"zz", b"app/", b"a"):
        for _ in range(150):
            keys.add(grp + (b"%05d" % int(rng.integers(0, 4000))))
    keys |= set(random_strings(rng, 200, 2, 20))
    keys = sorted(keys)
    return keys, keys + [k + b"!" for k in keys[:100]] + [b"app/", b"app", b"zzz"]


def _longkey(rng):
    keys = sorted(set(random_strings(rng, 400, 2, 24)))
    W = max(16, max(len(k) for k in keys) + 8)
    queries = keys[:200]
    queries += [k + b"x" * (W - len(k) + 3) for k in keys[:50]]   # > width
    queries += [(k + b"q" * W)[:W] for k in keys[:50]]            # == width
    return keys, queries


def _mixed(rng):
    keys = sorted(set(random_strings(rng, 600, 2, 18)))
    queries = [bytes(q) for q in rng.permutation(np.array(keys, object))]
    return keys, queries + [k[:-1] for k in keys[:80] if len(k) > 1]


def _dataset(name, n):
    def make(rng):
        keys = synthetic.load(name, n, seed=int(rng.integers(0, 1000)))
        queries = [keys[i] for i in rng.permutation(len(keys))[: n // 2]]
        queries += [k[: len(k) // 2] for k in keys[:200]] + [k + b"~" for k in keys[:200]]
        return keys, queries
    return make


CORPORA = {"skewed": _skewed, "longkey": _longkey, "mixed": _mixed,
           "email": _dataset("email", 3000), "url": _dataset("url", 3000)}


def _ref_arrays(ti):
    arrays = {f: np.asarray(getattr(ti, f)) for f in DATA_FIELDS}
    static = {f: getattr(ti, f) for f in t_ti.STATIC_FIELDS}
    return arrays, static


def _build_both(keys, vals=None):
    vals = np.asarray(vals if vals is not None else np.arange(len(keys)), np.int64)
    rb, tb = RBuilder(), TBuilder(device="cpu")
    rb.bulkload(RStringSet.from_list(list(keys)), vals)
    tb.bulkload(TStringSet.from_list(list(keys)), vals)
    return rb, tb


def _assert_same_index(rti, tti):
    arrays, static = _ref_arrays(rti)
    for f in DATA_FIELDS:
        a, b = arrays[f], getattr(tti, f).numpy()
        assert a.shape == b.shape and (a.astype(np.float64) == b.astype(np.float64)).all(), f
    for f in t_ti.STATIC_FIELDS:
        assert static[f] == getattr(tti, f), f


@pytest.fixture(scope="module")
def built():
    """Both packages' builders and frozen indexes for every corpus."""
    out = {}
    for i, (name, make) in enumerate(CORPORA.items()):
        keys, queries = make(np.random.default_rng(12345 + i))
        rb, tb = _build_both(keys)
        out[name] = (keys, queries, rb, tb, r_ti.freeze(rb), t_ti.freeze(tb))
    return out


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_bulkload_pools_equal(built, corpus):
    keys, _, rb, tb, rti, tti = built[corpus]
    assert rb.root_item == tb.root_item
    np.testing.assert_array_equal(rb.sorted_eids(), tb.sorted_eids())
    assert rb.height_bound() == tb.height_bound()
    assert list(rb.iter_subtree(rb.root_item)) == list(tb.iter_subtree(tb.root_item))
    assert rb.max_suffix_len == tb.max_suffix_len
    assert [rb.key_at(e) for e in range(len(keys))] == [tb.key_at(e) for e in range(len(keys))]
    _assert_same_index(rti, tti)


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_search_batch_equal(built, corpus):
    keys, queries, _, _, rti, tti = built[corpus]
    qb, ql = r_ti.pad_queries(queries, rti.width)
    tqb, tql = t_ti.pad_queries(queries, tti.width)
    np.testing.assert_array_equal(qb, tqb)
    np.testing.assert_array_equal(ql, tql)
    T = (torch.from_numpy(qb), torch.from_numpy(ql))
    got = [x.numpy() for x in t_ti.search_batch(tti, *T)]
    for backend in ("jnp", "pallas"):
        want = r_ti.search_batch(rti, jnp.asarray(qb), jnp.asarray(ql), backend=backend)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    # the walk's level counts, against the reference's fused kernel in interpret mode
    _, _, levels = traverse.fused_search(tti, *T)
    _, _, r_levels = r_ops.fused_search(rti, jnp.asarray(qb), jnp.asarray(ql), interpret=True)
    np.testing.assert_array_equal(levels.numpy(), np.asarray(r_levels))
    present = np.array([q in set(keys) for q in queries])
    assert (got[0] == present).all()


def test_get_batch_values_equal():
    rng = np.random.default_rng(31)
    keys = synthetic.load("email", 2000, seed=2)
    vals = rng.integers(-(1 << 62), 1 << 62, len(keys), dtype=np.int64)
    cfg_kw = dict(width=48, delta_capacity=64)
    ri = RIndex.bulk_load(keys, vals, RConfig(**cfg_kw))
    ti = TIndex.bulk_load(keys, vals, TConfig(device="cpu", **cfg_kw))
    queries = [keys[i] for i in rng.permutation(len(keys))] + [b"absent@x", b"x" * 60]
    rf, rv = ri.get_batch(queries)
    tf, tv = ti.get_batch(queries)
    np.testing.assert_array_equal(rf, tf)
    np.testing.assert_array_equal(rv, tv)
    assert tf[: len(keys)].all() and not tf[len(keys):].any()
    assert ti.get(keys[5]) == int(vals[5]) and ti.get(b"absent@x") is None
    assert ti.get_batch([])[0].shape == (0,)


def test_live_delta_carried_across():
    """A reference index with inserts and tombstones in its delta buffer
    (claimed out of key order, so its sorted view ``ds_order`` is no
    identity), carried into the port with convert.py, answers the same and
    takes further writes and scans the same."""
    keys = sorted(set(random_strings(np.random.default_rng(41), 300, 4, 16)))
    rb = RBuilder()
    rb.bulkload(RStringSet.from_list(keys), np.arange(len(keys), dtype=np.int64))
    rti = r_ti.freeze(rb, delta_capacity=128)
    fresh = [b"delta-%04d" % i for i in np.random.default_rng(42).permutation(80)]
    qb, ql = r_ti.pad_queries(fresh, rti.width)
    vals = np.arange(80, dtype=np.int64) * (1 << 33) + 11
    rti, ins, _ = r_ti.insert_batch(
        rti, jnp.asarray(qb), jnp.asarray(ql),
        jnp.asarray((vals & 0xFFFFFFFF).astype(np.uint32).view(np.int32)),
        jnp.asarray((vals >> 32).astype(np.int32)))
    assert int(np.asarray(ins).sum()) == 80
    gone = keys[:20] + fresh[:10]
    qb, ql = r_ti.pad_queries(gone, rti.width)
    rti, deleted, _ = r_ti.delete_batch(rti, jnp.asarray(qb), jnp.asarray(ql))
    assert np.asarray(deleted).all()
    tti = tensor_index_from_reference(*_ref_arrays(rti), device="cpu")
    _assert_same_index(rti, tti)
    queries = keys[:100] + fresh + [b"nope-%03d" % i for i in range(30)]
    qb, ql = r_ti.pad_queries(queries, rti.width)
    want = r_ti.search_batch(rti, jnp.asarray(qb), jnp.asarray(ql), backend="jnp")
    got = t_ti.search_batch(tti, torch.from_numpy(qb), torch.from_numpy(ql))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    r_lo, r_hi = r_ti.lookup_values(rti, want[1], want[2])
    t_lo, t_hi = t_ti.lookup_values(tti, got[1], got[2])
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(r_lo))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(r_hi))
    assert int(got[2].sum()) == 70                      # live delta hits
    assert not got[0][:20].any()                       # tombstones shadow the base
    order = tti.ds_order.numpy()
    assert (order[: int(tti.de_count)] != np.arange(int(tti.de_count))).any()
    # scans merge the carried delta, and later writes keep both packages equal
    qb, ql = r_ti.pad_queries(keys[::9] + [b"delta-", b""], rti.width)
    want = r_ti.scan_batch(rti, jnp.asarray(qb), jnp.asarray(ql), 12, backend="jnp")
    got = t_ti.scan_batch(tti, torch.from_numpy(qb), torch.from_numpy(ql), 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    more = [b"again-%02d" % i for i in range(5)] + fresh[:3] + keys[:2]
    qb, ql = r_ti.pad_queries(more, rti.width)
    z = np.arange(len(more), dtype=np.int32)
    rti, r_ins, r_upd = r_ti.insert_batch(rti, *(jnp.asarray(x) for x in (qb, ql, z, z)))
    tti, t_ins, t_upd = t_ti.insert_batch(tti, *(torch.from_numpy(x) for x in (qb, ql, z, z)))
    np.testing.assert_array_equal(t_ins.numpy(), np.asarray(r_ins))
    np.testing.assert_array_equal(t_upd.numpy(), np.asarray(r_upd))
    _assert_same_index(rti, tti)


def test_empty_root():
    ri = RIndex.bulk_load([])
    ti = TIndex.bulk_load([], config=TConfig(device="cpu"))
    _assert_same_index(ri.ti, ti.ti)
    assert ti.ti.root_item.item() == 0
    queries = [b"a", b"", b"abc" * 10]
    np.testing.assert_array_equal(ri.get_batch(queries)[0], ti.get_batch(queries)[0])
    assert not ti.get_batch(queries)[0].any()


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        TIndex.bulk_load([b"a", b"b"])
    with pytest.raises(RuntimeError, match="cuda"):
        TBuilder()


@functools.lru_cache(maxsize=None)
def _lost_key_builders():
    """An email set whose bulk load loses keys, built by both packages."""
    keys = synthetic.DATASETS["email"](np.random.default_rng(4), 20000)
    return (keys, *_build_both(keys))


def test_lost_keys_reproduced():
    """The reference's bulk load loses stored keys when float32 rounding makes
    a model node's positions step back (builder.py run grouping).  This email
    set loses some; the port must lose exactly the same ones."""
    keys, rb, tb = _lost_key_builders()
    r_reach = set(rb.iter_subtree(rb.root_item))
    t_reach = set(tb.iter_subtree(tb.root_item))
    assert r_reach == t_reach
    assert len(keys) - len(t_reach) > 0
    rti, tti = r_ti.freeze(rb), t_ti.freeze(tb)
    _assert_same_index(rti, tti)
    qb, ql = r_ti.pad_queries(sorted(keys), rti.width)
    rf, re, _ = r_ti.search_batch(rti, jnp.asarray(qb), jnp.asarray(ql), backend="jnp")
    tf, te, _ = t_ti.search_batch(tti, torch.from_numpy(qb), torch.from_numpy(ql))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))
    assert (~tf.numpy()).sum() > 0


def test_lost_keys_and_eid0_loss_carried_through_merge():
    """The reference's own defects pass through merges unchanged: a base put
    to entry 0 followed by another op in its batch is lost, and stays lost
    through ``sync_base_values``; the keys the bulk load lost stay missing
    to gets while the sorted order, which the merges splice, still holds
    them.  Every field, the builders' caches and the answers equal the
    reference's after each of two merges."""
    keys, rb, tb = _lost_key_builders()
    vals = np.arange(len(keys), dtype=np.int64)
    cfg = dict(delta_capacity=512, auto_merge_threshold=None)
    ri = RIndex.from_builder(copy.deepcopy(rb), RConfig(**cfg))
    ti = TIndex.from_builder(copy.deepcopy(tb), TConfig(device="cpu", **cfg))
    srt = sorted(keys)
    lost = sorted(set(keys) - {tb.key_at(e) for e in tb.iter_subtree(tb.root_item)})
    key0 = tb.key_at(0)
    old0 = int(vals[keys.index(key0)])
    assert lost and key0 not in lost
    fresh = [b"new%03d@" % i + k for i, k in enumerate(srt[::400])]
    probe = srt[::7] + lost + fresh + [b"zz-new@x.org"]

    def both(puts, pvals, dels=()):
        for ix in (ri, ti):
            ix.put_batch(puts, pvals)
            if dels:
                ix.delete_batch(dels)

    both([key0, b"zz-new@x.org"], np.array([777, 5]))
    both(fresh, np.arange(len(fresh)) + 100, srt[1::611])
    for cycle in range(2):
        ri.merge()
        ti.merge()
        _assert_same_index(ri.ti, ti.ti)
        assert ri._builder.height_bound() == ti._builder.height_bound()
        np.testing.assert_array_equal(ri._builder.sorted_eids(), ti._builder.sorted_eids())
        for a, b in zip(ri.get_batch(probe), ti.get_batch(probe)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ri.scan_batch(probe, 16), ti.scan_batch(probe, 16)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert not ti.get_batch(lost)[0].any()
        assert ti.get(key0) == old0                  # the put to entry 0 stayed lost
        in_order = {ti._builder.key_at(int(e)) for e in ti._builder.sorted_eids()}
        assert set(lost) <= in_order
        both(fresh[cycle::3], np.arange(len(fresh[cycle::3])) + 7)


def test_underflow_keys_index_equal_reference():
    """An index over keys whose GetCDF underflows, with a one-row HPT in
    which ``a`` has CDF 0 and probability 2**-7 (19 of them make ``prob``
    subnormal, and the reference flushes it): the bulk load's pools, the
    slot positions of every key at the root and the walk (levels included)
    equal the reference's."""
    from repro.core.hpt import HPT as RHPT, get_cdf_jnp, positions_jnp
    from repro_torch.core.hpt import HPT as THPT

    ct, pt = underflow_table()
    keys = underflow_keys(61, 1500)
    rb, tb = RBuilder(hpt=RHPT(ct, pt)), TBuilder(hpt=THPT(ct, pt), device="cpu")
    vals = np.arange(len(keys), dtype=np.int64)
    rb.bulkload(RStringSet.from_list(keys), vals)
    tb.bulkload(TStringSet.from_list(keys), vals)
    rti, tti = r_ti.freeze(rb), t_ti.freeze(tb)
    _assert_same_index(rti, tti)
    assert rb.height_bound() == tb.height_bound()
    qb, ql = r_ti.pad_queries(keys, rti.width)
    J = [jnp.asarray(x) for x in (ct, pt, qb, ql)]
    cdf = np.asarray(get_cdf_jnp(*J, jnp.int32(0)))
    assert cdf[keys.index(b"a" * 19 + b"b")] == 0 and (cdf > 0).any()   # underflowed
    alpha, beta = float(tb.mn_alpha.data[0]), float(tb.mn_beta.data[0])
    m = int(tb.mn_slot_cnt.data[0])
    want = np.asarray(positions_jnp(*J, jnp.int32(0), jnp.float32(alpha), jnp.float32(beta),
                                    jnp.int32(m)))
    got = t_hpt_positions(ct, pt, qb, ql, alpha, beta, m)
    np.testing.assert_array_equal(got, want)
    queries = keys + [k + b"a" for k in keys[::5]] + [k[:-1] for k in keys[::7]]
    qb, ql = r_ti.pad_queries(queries, rti.width)
    T = (torch.from_numpy(qb), torch.from_numpy(ql))
    got = [x.numpy() for x in t_ti.search_batch(tti, *T)]
    want = r_ti.search_batch(rti, jnp.asarray(qb), jnp.asarray(ql), backend="jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    _, _, levels = traverse.fused_search(tti, *T)
    _, _, r_levels = r_ops.fused_search(rti, jnp.asarray(qb), jnp.asarray(ql), interpret=True)
    np.testing.assert_array_equal(levels.numpy(), np.asarray(r_levels))


def t_hpt_positions(ct, pt, qb, ql, alpha, beta, m):
    from repro_torch.core.hpt import positions

    return positions(*(torch.from_numpy(x) for x in (ct, pt, qb, ql)), 0, alpha, beta,
                     m).numpy()


def test_value_split_and_join_equal():
    from repro.index import facade as r_facade
    from repro_torch.index import facade as t_facade

    v = np.concatenate([np.random.default_rng(51).integers(-(1 << 63), (1 << 63) - 1, 1000),
                        [0, -1, 1, (1 << 63) - 1, -(1 << 63), 1 << 32, (1 << 32) - 1]])
    r_lo, r_hi = r_facade._split_np(v)
    t_lo, t_hi = t_facade._split_np(v)
    np.testing.assert_array_equal(r_lo, t_lo)
    np.testing.assert_array_equal(r_hi, t_hi)
    np.testing.assert_array_equal(t_facade._join_values(t_lo, t_hi), v)
    np.testing.assert_array_equal(r_facade._join_values(r_lo, r_hi), v)


# -- the word-path edge cases of K4 (tests/_torch_cases.py) ----------------

@functools.lru_cache(maxsize=None)
def _word_indexes():
    """The word-path edge case in both packages, its writes applied."""
    _, rti = word_edge_indexes(RIndex, RConfig, RLITSConfig, auto_merge_threshold=None)
    _, tti = word_edge_indexes(TIndex, TConfig, TLITSConfig, device="cpu")
    return rti, tti, word_edge_case()[2]


@pytest.mark.parametrize("pools", ["whole", "trimmed"])
@pytest.mark.parametrize("B", WORD_BATCHES_CPU)
def test_search_word_edge_cases_equal(B, pools):
    """search_batch and the walk's level counts on the word-path edge cases
    (key lengths 1, 15, 16, 17 and W, the W + 1 sentinel, bytes >= 0x80,
    embedded zero bytes, a last byte off by one, prefixes both ways) at
    batch sizes around a block, over a live delta, with whole key pools and
    with pools cut to their used bytes."""
    rti, tti, queries = _word_indexes()
    if pools == "trimmed":
        rti, tti = trimmed(rti), trimmed(tti)
    assert set((tti.ent_off % 16).tolist()) == set(range(16))   # every key alignment
    qb, ql = r_ti.pad_queries(word_rows(queries, B), WORD_WIDTH)
    T = (torch.from_numpy(qb), torch.from_numpy(ql))
    got = [x.numpy() for x in t_ti.search_batch(tti, *T)]
    want = r_ti.search_batch(rti, jnp.asarray(qb), jnp.asarray(ql), backend="jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    if B <= 257:
        _, _, levels = traverse.fused_search(tti, *T)
        _, _, r_levels = r_ops.fused_search(rti, jnp.asarray(qb), jnp.asarray(ql), interpret=True)
        np.testing.assert_array_equal(levels.numpy(), np.asarray(r_levels))
    if B > 31:
        assert got[0].any() and not got[0].all()


def test_paired_table_follows_the_tables():
    """K4's interleaved (cdf, prob) table is made once per pair of table
    tensors, again after an in-place write to either, and never for another
    pair; it dies with its cdf table."""
    ct, pt = torch.rand(8, 16), torch.rand(8, 16)
    a = traverse.paired_table(ct, pt)
    assert traverse.paired_table(ct, pt) is a
    assert torch.equal(a[..., 0], ct) and torch.equal(a[..., 1], pt)
    pt.mul_(0.5)
    b = traverse.paired_table(ct, pt)
    assert b is not a and torch.equal(b[..., 1], pt)
    assert traverse.paired_table(ct, pt.clone()) is not b
    n = len(_build._DERIVED)
    del ct, a, b
    assert len(_build._DERIVED) == n - 1
