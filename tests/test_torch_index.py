"""The port's main path against the JAX package, on the CPU: bulk load →
freeze → batched point lookup.  Pools, (found, eid, is_delta, levels) and
values must be equal bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LITSBuilder as RBuilder, StringSet as RStringSet
from repro.core import tensor_index as r_ti
from repro.core.strings import random_strings
from repro.index import IndexConfig as RConfig, StringIndex as RIndex
from repro.kernels import ops as r_ops
from repro_torch.convert import tensor_index_from_reference
from repro_torch.core import tensor_index as t_ti
from repro_torch.core.builder import LITSBuilder as TBuilder
from repro_torch.core.strings import StringSet as TStringSet
from repro_torch.data import synthetic
from repro_torch.index import IndexConfig as TConfig, StringIndex as TIndex
from repro_torch.kernels import traverse

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
    """A reference index with inserts and tombstones in its delta buffer,
    carried into the port with convert.py, answers the same."""
    keys = sorted(set(random_strings(np.random.default_rng(41), 300, 4, 16)))
    rb = RBuilder()
    rb.bulkload(RStringSet.from_list(keys), np.arange(len(keys), dtype=np.int64))
    rti = r_ti.freeze(rb, delta_capacity=128)
    fresh = [b"delta-%04d" % i for i in range(80)]
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


def test_lost_keys_reproduced():
    """The reference's bulk load loses stored keys when float32 rounding makes
    a model node's positions step back (builder.py run grouping).  This email
    set loses some; the port must lose exactly the same ones."""
    keys = synthetic.DATASETS["email"](np.random.default_rng(4), 20000)
    rb, tb = _build_both(keys)
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
