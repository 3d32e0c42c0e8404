"""The port's range path against the JAX package, on the CPU: the full-key
compares, rank_batch, scan_batch (with and without a live delta), K7's plain
one-hot GetCDF, and a scan oracle over generated op sequences.  Equality is
exact throughout."""
import bisect
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (WORD_BATCHES_CPU, WORD_WIDTH, WORD_WINDOW, edge_cdf_rows, nan_equal,
                          nonfinite_tables, query_rows, scan_entries, short_orders, trimmed,
                          visited_entries, word_edge_case, word_edge_indexes, word_rows)
from repro.core import LITSBuilder as RBuilder, LITSConfig as RLITSConfig
from repro.core import StringSet as RStringSet
from repro.core import tensor_index as r_ti
from repro.core.hpt import get_cdf_jnp
from repro.core.strings import random_strings
from repro.index import IndexConfig as RConfig, StringIndex as RIndex
from repro.kernels import ops as r_ops
from repro.kernels import strops as r_strops
from repro.kernels.hpt_cdf import hpt_cdf_pallas
from repro_torch.convert import tensor_index_from_reference
from repro_torch.core import tensor_index as t_ti
from repro_torch.core.builder import LITSConfig as TLITSConfig
from repro_torch.core.walk import rank_sorted
from repro_torch.data import synthetic
from repro_torch.index import IndexConfig, StringIndex
from repro_torch.kernels import hpt_cdf, ops, rank, scan, strops
from repro_torch.kernels.strops import take


def _pair(keys, width=None, **freeze_kw):
    rb = RBuilder()
    rb.bulkload(RStringSet.from_list(list(keys)), np.arange(len(keys), dtype=np.int64),
                width=width)
    rti = r_ti.freeze(rb, **freeze_kw)
    arrays = {f: np.asarray(getattr(rti, f)) for f in t_ti.DATA_FIELDS}
    static = {f: getattr(rti, f) for f in t_ti.STATIC_FIELDS}
    return rti, tensor_index_from_reference(arrays, static, device="cpu")


def _skewed(rng):
    keys = set()
    for grp in (b"app/events/", b"app/users/", b"zz", b"app/", b"a"):
        for _ in range(150):
            keys.add(grp + (b"%05d" % int(rng.integers(0, 4000))))
    keys |= set(random_strings(rng, 200, 2, 20))
    keys = sorted(keys)
    return keys, keys[::3] + [k + b"!" for k in keys[:100]] + [b"app/", b"app", b"zzz", b""]


def _longkey(rng):
    keys = sorted(set(random_strings(rng, 400, 2, 24)))
    W = max(16, max(len(k) for k in keys) + 8)
    queries = keys[:200] + [k + b"x" * (W - len(k) + 3) for k in keys[:50]]   # > width
    return keys, queries + [(k + b"q" * W)[:W] for k in keys[:50]]            # == width


def _random(rng):
    keys = sorted(set(random_strings(rng, 600, 2, 18)))
    return keys, keys[::2] + [k[:-1] for k in keys[:80] if len(k) > 1] + [b"\xff" * 5]


def _url(rng):
    keys = synthetic.load("url", 2000, seed=int(rng.integers(0, 1000)))
    return keys, keys[::3] + [k[: len(k) // 2] for k in keys[:200]]


CORPORA = {"skewed": _skewed, "longkey": _longkey, "random": _random, "url": _url}


def _rows(queries, width):
    qb, ql = r_ti.pad_queries(queries, width)
    return (jnp.asarray(qb), jnp.asarray(ql)), (torch.from_numpy(qb), torch.from_numpy(ql))


def test_full_compares_equal_reference():
    rng = np.random.default_rng(3)
    W = 12
    a = random_strings(rng, 400, 0, W)
    b = [x if i % 4 == 0 else (x[:-1] if i % 4 == 1 else y)
         for i, (x, y) in enumerate(zip(a, random_strings(rng, 400, 0, W)))]
    pool_a = np.frombuffer(b"".join(a), np.uint8).copy()
    pool_b = np.frombuffer(b"".join(b) + b"\x07" * 3, np.uint8).copy()
    la, lb = (np.array([len(x) for x in s], np.int32) for s in (a, b))
    oa, ob = (np.concatenate([[0], np.cumsum(l)[:-1]]).astype(np.int32) for l in (la, lb))
    ob[-1] = pool_b.shape[0] - 2          # a window past the pool's end clamps
    want = r_strops.str_cmp_pools(*(jnp.asarray(x) for x in (pool_a, oa, la, pool_b, ob, lb)), W)
    got = strops.str_cmp_pools(*(torch.from_numpy(x) for x in (pool_a, oa, la, pool_b, ob, lb)), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(got.tolist()) == {-1, 0, 1}
    (jq, jl), (tq, tl) = _rows(a, W)
    tl[::7] = W + 1                       # over-width sentinel rows
    jl = jnp.asarray(tl.numpy())
    want = r_strops.str_cmp_full(jq, jl, jnp.asarray(pool_b), jnp.asarray(ob), jnp.asarray(lb))
    got = strops.str_cmp_full(tq, tl, *(torch.from_numpy(x) for x in (pool_b, ob, lb)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_rank_batch_equal(corpus):
    keys, queries = CORPORA[corpus](np.random.default_rng(77))
    rti, tti = _pair(keys)
    j, t = _rows(queries, rti.width)
    got = t_ti.rank_batch(tti, *t).numpy()
    np.testing.assert_array_equal(got, np.asarray(r_ti.rank_batch(rti, *j, backend="jnp")))
    assert got.dtype == np.int32
    for q, r in zip(queries, got.tolist()):
        if len(q) <= rti.width:
            assert r == bisect.bisect_left(keys, q)


def test_rank_equal_reference_kernel_and_empty_root():
    """K5's plain version against the reference's rank kernel (interpret
    mode), and rank on an EMPTY root (one pad entry)."""
    keys, queries = _skewed(np.random.default_rng(5))
    rti, tti = _pair(keys)
    j, t = _rows(queries[:300], rti.width)
    np.testing.assert_array_equal(rank.fused_rank(tti, *t).numpy(),
                                  np.asarray(r_ops.fused_rank(rti, *j, interpret=True)))
    rti, tti = _pair([], width=8)
    j, t = _rows([b"", b"a", b"zzzzzzzzz"], 8)
    np.testing.assert_array_equal(t_ti.rank_batch(tti, *t).numpy(),
                                  np.asarray(r_ti.rank_batch(rti, *j, backend="jnp")))


def _live_delta(rng, keys, capacity=256):
    """A reference index with unmerged inserts (some between base keys, one
    equal to a base key's prefix) and tombstones of base and delta keys,
    and the port's copy of it."""
    rti, _ = _pair(keys, delta_capacity=capacity)
    fresh = [b"dd-%03d" % i for i in rng.permutation(60)] + [keys[7][:-1] + b"\x00",
                                                             keys[11] + b"!"]
    qb, ql = r_ti.pad_queries(fresh, rti.width)
    z = jnp.zeros(len(fresh), jnp.int32)
    rti, ins, _ = r_ti.insert_batch(rti, jnp.asarray(qb), jnp.asarray(ql), z + 3, z)
    assert np.asarray(ins).all()
    dead = keys[::9][:20] + fresh[::7][:5]
    qb, ql = r_ti.pad_queries(dead, rti.width)
    rti, deleted, _ = r_ti.delete_batch(rti, jnp.asarray(qb), jnp.asarray(ql))
    assert np.asarray(deleted).all()
    arrays = {f: np.asarray(getattr(rti, f)) for f in t_ti.DATA_FIELDS}
    static = {f: getattr(rti, f) for f in t_ti.STATIC_FIELDS}
    return rti, tensor_index_from_reference(arrays, static, device="cpu"), fresh, dead


@functools.lru_cache(maxsize=None)
def _scan_case(delta):
    rng = np.random.default_rng(99)
    keys = sorted(set(random_strings(rng, 500, 2, 20)))
    if delta == "empty":
        rti, tti = _pair(keys)
        return keys, rti, tti, [], [], keys[::13] + [k[:2] for k in keys[:40]] + [b"~~~", b"a", b""]
    rti, tti, fresh, dead = _live_delta(rng, keys)
    return keys, rti, tti, fresh, dead, keys[::17] + fresh[::5] + dead[::3] + [b"", b"~~~", b"dd-"]


@pytest.mark.parametrize("delta", ["empty", "live"])
@pytest.mark.parametrize("window", [1, 11, 16])
def test_scan_batch_equal(delta, window):
    keys, rti, tti, fresh, dead, starts = _scan_case(delta)
    j, t = _rows(starts + [b"q" * 40], rti.width)
    want = r_ti.scan_batch(rti, *j, window, backend="jnp")
    got = t_ti.scan_batch(tti, *t, window)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert got[0].shape == (len(starts) + 1, window)
    assert got[2].any() == (delta == "live")
    live = sorted(set(keys) - set(dead) | set(fresh) - set(dead)) if delta == "live" else keys
    rows = scan_entries(tti, *got)
    for s, row in zip(starts, rows):
        assert [k for k, _ in row] == [k for k in live if k >= s][:window], s


def test_scan_equal_reference_kernel_with_live_delta():
    """K6's plain version against the reference's scan kernel (interpret mode)."""
    rng = np.random.default_rng(8)
    keys = sorted(set(random_strings(rng, 300, 2, 16)))
    rti, tti, fresh, dead = _live_delta(rng, keys)
    j, t = _rows(keys[::11] + fresh[::9] + [b""], rti.width)
    want = r_ops.fused_scan(rti, *j, window=7, interpret=True)
    for a, b in zip(want, scan.fused_scan(tti, *t, window=7)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_scan_delta_only_and_seam():
    """A delta-only index (EMPTY base) scans its inserts; windows straddle
    the base/delta seam; a resurrect shows once with its delta value."""
    base = [b"k-%03d" % i for i in range(0, 40, 2)]
    for keys in ([], base):
        cfg = dict(width=16, delta_capacity=64)
        ri = RIndex.bulk_load(keys, np.arange(len(keys)) * 10 + 1,
                              RConfig(auto_merge_threshold=None, **cfg))
        ti = StringIndex.bulk_load(keys, np.arange(len(keys)) * 10 + 1,
                                   IndexConfig(device="cpu", **cfg))
        odd = [b"k-%03d" % i for i in range(1, 21, 2)]
        for ix in (ri, ti):
            ix.put_batch(odd, np.arange(len(odd)) + 5000)
            ix.delete_batch([b"k-005", b"k-006"])
            ix.put_batch([b"k-006"], [777])
        starts = [b"", b"k-003", b"k-018", b"k-0061", b"z"]
        for w in (1, 4, 11):
            want = ri.scan_batch(starts, w)
            got = ti.scan_batch(starts, w)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        rows = scan_entries(ti.ti, *ti.scan_batch([b"k-003"], 5))
        want_keys = ([b"k-003", b"k-006", b"k-007", b"k-009", b"k-011"] if not keys else
                     [b"k-003", b"k-004", b"k-006", b"k-007", b"k-008"])
        assert [k for k, _ in rows[0]] == want_keys
        assert dict(rows[0])[b"k-006"] == 777


# -- a scan oracle over generated op sequences, on the port alone ---------

_PREFIXES = (b"app/ev/", b"app/ev/", b"app/ev/", b"app/us/", b"app/us/", b"zz/", b"q", b"")


def _rand_key(rng) -> bytes:
    return _PREFIXES[int(rng.integers(0, len(_PREFIXES)))] + b"%04d" % int(rng.integers(0, 60))


def test_scan_oracle_generated_sequences():
    """Generated put/delete/get/scan sequences against a host dict, with no
    merge: every op's answer and a paginated full sweep must match."""
    rng = np.random.default_rng(0xC0FFEE)
    base = sorted({_rand_key(rng) for _ in range(120)})
    vals = rng.integers(0, 1 << 40, len(base)).astype(np.int64)
    index = StringIndex.bulk_load(base, vals, IndexConfig(width=16, delta_capacity=512,
                                                          device="cpu"))
    oracle = dict(zip(base, vals.tolist()))
    for s in range(40):
        srng = np.random.default_rng(0x5EED + 7919 * s)
        for _ in range(int(srng.integers(5, 13))):
            kind = ("put", "put", "put", "delete", "delete", "get", "scan", "scan",
                    "scan")[int(srng.integers(0, 9))]
            k = _rand_key(srng)
            if kind == "put":
                v = int(srng.integers(0, 1 << 40))
                ins, upd, merged = index.put_batch([k], [v])
                assert (ins[0] or upd[0]) and not merged
                oracle[k] = v
            elif kind == "delete":
                deleted, rej, _ = index.delete_batch([k])
                assert deleted[0] == (k in oracle) and not rej[0]
                oracle.pop(k, None)
            elif kind == "get":
                found, v = index.get_batch([k])
                assert found[0] == (k in oracle) and (not found[0] or v[0] == oracle[k])
            else:
                start = (k, k[:3], b"", b"~")[int(srng.integers(0, 4))]
                row = scan_entries(index.ti, *index.scan_batch([start], 6))[0]
                assert row == [(x, oracle[x]) for x in sorted(oracle) if x >= start][:6]
    got, start = [], b""
    while True:
        page = scan_entries(index.ti, *index.scan_batch([start], 16))[0]
        got += page
        if len(page) < 16:
            break
        start = page[-1][0] + b"\x00"
    assert got == sorted(oracle.items())
    assert not index.delta_overflowed and index.delta_fill > 0


# -- K7: the one-hot GetCDF -----------------------------------------------

@pytest.mark.parametrize("max_steps", [64, 5])
def test_onehot_cdf_equals_reference_kernel_and_k2(max_steps):
    qb, ql, st, hpt = query_rows(np.random.default_rng(11), 300, 24, rows=64)
    want = hpt_cdf_pallas(jnp.asarray(qb), jnp.asarray(ql), jnp.asarray(st),
                          jnp.asarray(hpt.cdf_tab), jnp.asarray(hpt.prob_tab),
                          max_steps=max_steps, variant="onehot", interpret=True)
    args = [torch.from_numpy(x) for x in (qb, ql, st, hpt.cdf_tab, hpt.prob_tab)]
    got = hpt_cdf.hpt_cdf_onehot_plain(*args, max_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), hpt_cdf.hpt_cdf_plain(*args, max_steps).numpy())
    via_ops = ops.hpt_cdf(args[0], args[1], args[2], cdf_tab=args[3], prob_tab=args[4],
                          variant="onehot", max_steps=max_steps)
    assert torch.equal(via_ops, got)
    assert torch.get_float32_matmul_precision() == "highest"
    with pytest.raises(ValueError, match="variant"):
        ops.hpt_cdf(args[0], args[1], cdf_tab=args[3], prob_tab=args[4], variant="mxu")


def _onehot_rule_cdf(qb, ql, st, cdf_tab, prob_tab, max_steps):
    """A torch mirror of K7's rule (``csrc/hpt_cdf_onehot.cu``): K2's walk,
    each value read turned into NaN where its column's count of non-finite
    entries (:func:`hpt_cdf.nonfinite_columns`), less its own, is positive;
    subnormals flushed as K2 flushes them."""
    R, C = cdf_tab.shape
    B, L = qb.shape
    cdf, prob = torch.zeros(B), torch.ones(B)
    h = torch.zeros(B, dtype=torch.int64)
    bad = [hpt_cdf.nonfinite_columns(t) for t in (cdf_tab, prob_tab)]
    for k in range(min(max_steps, L)):
        pos = st.long() + k
        c = qb.gather(1, pos.clamp(0, L - 1)[:, None])[:, 0].long().clamp(max=C - 1)
        active = pos < ql.long()
        vals = []
        for tab, cnt in zip((cdf_tab, prob_tab), bad):
            v = hpt_cdf.flush_subnormal(tab[h & (R - 1), c])
            vals.append(torch.where(cnt[c] - (~torch.isfinite(v)).int() > 0, float("nan"), v))
        cdf = hpt_cdf.add_ftz(cdf, torch.where(active, hpt_cdf.mul_ftz(prob, vals[0]), 0.0))
        prob = hpt_cdf.mul_ftz(prob, torch.where(active, vals[1], 1.0))
        h = torch.where(active, ((h ^ c) * strops.FNV_PRIME) & strops.U32, h)
    return cdf


NONFINITE_CASES = ("used column", "unused column", "selected entry", "selected inf",
                   "both tables")


@pytest.mark.parametrize("max_steps", [64, 5])
@pytest.mark.parametrize("case", NONFINITE_CASES)
def test_onehot_cdf_nonfinite_tables_equal_reference(case, max_steps):
    """K7's plain version equals the reference's one-hot kernel (interpret
    mode) bit for bit, NaN equal to NaN, on tables with inf, -inf and NaN
    entries: in a column the queries use (in another row than the one a
    query selects), in a column no query uses, at a selected entry itself
    (NaN or inf), and in both tables at once.  So does a mirror of the count
    rule that K7 runs.  A step's value is NaN where its column holds a
    non-finite entry in another row; entries in other columns do not reach
    it."""
    qb, ql, st, hpt = query_rows(np.random.default_rng(12), 200, 16, rows=16)
    R, C = hpt.cdf_tab.shape
    idx, reads = visited_entries(qb, ql, st, R, C, max_steps)
    seen = dict(zip(((int(i) // C, int(i) % C) for i in idx), reads.tolist()))
    unused = [c for c in range(C) if c not in set((idx % C).tolist())]
    # a selected entry whose column has another row no query reads there
    rare = min((rc for rc in seen if sum(1 for r, c in seen if c == rc[1]) < R), key=seen.get)
    other = next(r for r in range(R) if (r, rare[1]) not in seen)
    cdf_tab, prob_tab = hpt.cdf_tab.copy(), hpt.prob_tab.copy()
    if case == "used column":
        cdf_tab[other, rare[1]] = np.inf
    elif case == "unused column":
        cdf_tab[3, unused[0]] = -np.inf
        prob_tab[R - 1, unused[-1]] = np.nan
    elif case == "selected entry":
        cdf_tab[rare] = np.nan
    elif case == "selected inf":
        cdf_tab[rare] = np.inf
    else:
        cdf_tab[other, rare[1]] = -np.inf
        prob_tab[rare] = np.nan
        cdf_tab[0, unused[0]] = np.inf
    want = np.asarray(hpt_cdf_pallas(*(jnp.asarray(x) for x in (qb, ql, st, cdf_tab, prob_tab)),
                                     max_steps=max_steps, variant="onehot", interpret=True))
    args = [torch.from_numpy(x) for x in (qb, ql, st, cdf_tab, prob_tab)]
    got = hpt_cdf.hpt_cdf_onehot_plain(*args, max_steps)
    assert nan_equal(got.numpy(), want)
    assert nan_equal(_onehot_rule_cdf(*args, max_steps).numpy(), want)
    n_bad = int((~np.isfinite(want)).sum())
    if case == "unused column":
        assert n_bad == 0
        np.testing.assert_array_equal(got.numpy(), hpt_cdf.hpt_cdf_plain(*args, max_steps).numpy())
    else:
        assert 0 < n_bad < want.shape[0]


@pytest.mark.parametrize("case", ["underflow", "underflow_hpt", "uniform1 non-finite"])
def test_cdf_underflow_rows_equal_reference(case):
    """Rows whose ``prob`` underflows, where the reference (XLA on the CPU)
    flushes subnormals: K2's plain version equals the reference's GetCDF
    and K7's its one-hot kernel (interpret mode), NaN equal to NaN.  On the
    one-row uniform table with the non-finite entries that
    ``nonfinite_tables`` places for all 65,536 edge rows (the card's K7
    case), rows such as 359 read an inf after more than 18 steps of 2**-7:
    0 times inf, NaN, where a kept subnormal gave inf."""
    table = case.split()[0]
    qb, ql, st, ct, pt = edge_cdf_rows(94, table)[:5]
    if case.endswith("non-finite"):
        ct, pt = nonfinite_tables(qb, ql, st, ct, pt, 64)
    n = {"underflow": 40, "underflow_hpt": 257, "uniform1": 4097}[table]
    J = [jnp.asarray(x) for x in (qb[:n], ql[:n], st[:n], ct, pt)]
    want = np.asarray(get_cdf_jnp(J[3], J[4], J[0], J[1], J[2]))
    want_onehot = np.asarray(hpt_cdf_pallas(*J, variant="onehot", interpret=True))
    T = [torch.from_numpy(x) for x in (qb[:n], ql[:n], st[:n], ct, pt)]
    assert nan_equal(hpt_cdf.hpt_cdf_plain(*T).numpy(), want)
    assert nan_equal(hpt_cdf.hpt_cdf_onehot_plain(*T).numpy(), want_onehot)
    if table == "uniform1":
        assert np.isnan(want[359]) and np.isnan(want_onehot[359])
    else:
        assert (want == 0).any() and (want > 0).any()


# -- the word-path edge cases of K6 (tests/_torch_cases.py) ----------------

@functools.lru_cache(maxsize=None)
def _word_indexes():
    """The word-path edge case in both packages: (empty delta, live delta)."""
    r = word_edge_indexes(RIndex, RConfig, RLITSConfig, auto_merge_threshold=None)
    t = word_edge_indexes(StringIndex, IndexConfig, TLITSConfig, device="cpu")
    return {"empty": (r[0], t[0]), "live": (r[1], t[1]), "trimmed": (trimmed(r[1]), trimmed(t[1]))}


@pytest.mark.parametrize("delta", ["empty", "live", "trimmed"])
@pytest.mark.parametrize("B", WORD_BATCHES_CPU)
def test_scan_word_edge_cases_equal(B, delta):
    """scan_batch and rank_batch on the word-path edge cases at batch sizes
    around a block: empty delta, live delta (a tombstone run longer than
    the window, resurrected keys shadowing their base keys at every window
    slot, a delta key equal to a base key but for a trailing zero byte), and
    the live delta with both key pools cut to their used bytes."""
    rti, tti = _word_indexes()[delta]
    qb, ql = r_ti.pad_queries(word_rows(word_edge_case()[3], B), WORD_WIDTH)
    j, t = (jnp.asarray(qb), jnp.asarray(ql)), (torch.from_numpy(qb), torch.from_numpy(ql))
    want = r_ti.scan_batch(rti, *j, WORD_WINDOW, backend="jnp")
    got = t_ti.scan_batch(tti, *t, WORD_WINDOW)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(t_ti.rank_batch(tti, *t).numpy(),
                                  np.asarray(r_ti.rank_batch(rti, *j, backend="jnp")))
    if B >= 256:
        assert bool(got[2].any()) == (delta != "empty")


def _multiway_rank(qb, ql, srt, off, ln, pool, n_live: int, G: int):
    """A torch mirror of ``csrc/lits_words.cuh::group_rank``: each step
    compares the keys at the G pivots lo + (j + 1) (hi - lo) / (G + 1) and
    narrows [lo, hi) to the part between the last pivot below the query and
    the first one not below it."""
    B = qb.shape[0]
    lo = torch.zeros(B, dtype=torch.int64)
    hi = torch.full((B,), n_live, dtype=torch.int64)
    j = torch.arange(1, G + 1)
    while bool((lo < hi).any()):
        live = lo < hi
        piv = lo[:, None] + j[None, :] * (hi - lo)[:, None] // (G + 1)
        e = take(srt, piv.clamp(max=srt.shape[0] - 1).flatten())
        below = (strops.str_cmp_full(qb.repeat_interleave(G, 0), ql.repeat_interleave(G), pool,
                                     take(off, e), take(ln, e)) > 0).view(B, G)
        c = below.sum(dim=1)
        p_lo = piv.gather(1, (c - 1).clamp(min=0)[:, None])[:, 0]
        p_hi = piv.gather(1, c.clamp(max=G - 1)[:, None])[:, 0]
        lo = torch.where(live & (c > 0), p_lo + 1, lo)
        hi = torch.where(live & (c < G), p_hi, hi)
    return lo


@pytest.mark.parametrize("G", [4, 8])
def test_multiway_rank_mirror_equals_rank_sorted(G):
    """The multi-way search that K5 and K6 run equals core.walk.rank_sorted, the
    halving search of the reference, on every order length 0..300 with
    duplicates, at the fewest halvings that cover the order
    (ceil(log2(n + 1))) and at the rank_iters freeze gives (ceil(log2 n) + 2)."""
    for keys, queries, tables in short_orders(90 + G):
        n = len(keys)
        srt, off, ln, pool = (torch.from_numpy(a) for a in tables)
        qb, ql = (torch.from_numpy(a) for a in t_ti.pad_queries(queries, 8))
        want = _multiway_rank(qb, ql, srt, off, ln, pool, n, G)
        for iters in {n.bit_length(), int(np.ceil(np.log2(max(n, 1)))) + 2}:
            got = rank_sorted(qb, ql, srt, off, ln, pool, rank_iters=iters,
                              n_live=torch.tensor(n, dtype=torch.int32))
            np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=f"n={n}")
        assert want.tolist() == [bisect.bisect_left(keys, q) for q in queries]


def test_multiway_rank_mirror_equals_rank_sorted_1m():
    """The same at the real index's size: 1,000,000 sorted entries with
    duplicates and the rank_iters that freeze gives them (22)."""
    n = 1_000_000
    rng = np.random.default_rng(91)
    words = np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint64) >> rng.integers(0, 2, n)
                    .astype(np.uint64)).astype(">u4")
    pool = np.concatenate([words.view(np.uint8), np.zeros(9, np.uint8)])
    srt = torch.arange(n, dtype=torch.int32)
    off = torch.arange(0, 4 * n, 4, dtype=torch.int32)
    ln = torch.full((n,), 4, dtype=torch.int32)
    keys = [bytes(words[i].tobytes()) for i in rng.integers(0, n, 300)]
    queries = keys + [k[:3] for k in keys[:50]] + [b"", b"\xff" * 5]
    qb, ql = (torch.from_numpy(a) for a in t_ti.pad_queries(queries, 8))
    rank_iters = int(np.ceil(np.log2(n))) + 2
    assert rank_iters == 22 and rank_iters >= n.bit_length()
    got = rank_sorted(qb, ql, srt, off, ln, torch.from_numpy(pool), rank_iters=rank_iters)
    want = _multiway_rank(qb, ql, srt, off, ln, torch.from_numpy(pool), n, 8)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_order_records_are_the_gathered_tables():
    """K6's per-rank records (entry id, key offset, key length, tombstone
    flag) are the order's gathers of the entry tables, clamped as the
    reference clips, made again when a table is written in place."""
    rti, tti = _word_indexes()["live"]
    n = int(tti.de_count)
    rec = scan.order_records(tti.ds_order, tti.de_off, tti.de_len, tti.de_tomb)
    e = tti.ds_order.long()
    assert rec.dtype == torch.int32 and rec.shape == (tti.ds_order.shape[0], 4)
    assert torch.equal(rec[:, 0], tti.ds_order)
    assert torch.equal(rec[:, 1], tti.de_off[e]) and torch.equal(rec[:, 2], tti.de_len[e])
    assert torch.equal(rec[:, 3], tti.de_tomb[e].int()) and bool(rec[:n, 3].any())
    base = scan.order_records(tti.ent_sorted, tti.ent_off, tti.ent_len)
    assert base is scan.order_records(tti.ent_sorted, tti.ent_off, tti.ent_len)
    assert not base[:, 3].any()
    off = tti.ent_off.clone()
    again = scan.order_records(tti.ent_sorted, off, tti.ent_len)
    off.add_(1)
    assert torch.equal(scan.order_records(tti.ent_sorted, off, tti.ent_len)[:, 1], again[:, 1] + 1)
    odd = torch.tensor([0, 5, -3, 10**6], dtype=torch.int32)   # out-of-range ids clamp
    rec = scan.order_records(odd, tti.ent_off, tti.ent_len)
    assert torch.equal(rec[:, 1], take(tti.ent_off, odd)) and torch.equal(rec[:, 0], odd)
