"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; without a card each skips
with its reason.  Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.  Equality
is exact for the index: a kernel that is off by one float32 ulp places a key
in another slot.  The LM cases at the end hold the model's logits on the
card to the port on the CPU within a stated tolerance (cuBLAS sums its bf16
products in another order), and the served tokens exactly; the training
cases hold a train step's loss and gradients to the CPU port within stated
tolerances, and crash-resume and the remat settings bit for bit.  The mesh
cases run on a one-rank NCCL mesh, where every collective is the identity:
each mesh result equals its no-mesh result bit for bit, the dense
tensor-parallel path's too (its sums over the model group are NCCL calls).
The last cases hold a model of bf16 parameters to the float32 model it was
cast from.
"""
import bisect
import dataclasses

import numpy as np
import pytest
import torch

from _torch_cases import (CDF_GROUP_BATCHES, CDF_TABLES, LM_CARD_TOL, LM_GRAD_RTOL, WORD_BATCHES,
                          WORD_WINDOW, cnode_probe_stats, collision_keys, compressed_vs_plain,
                          edge_cdf_rows, lm_card_vs_cpu, lm_pair, lm_train_batch,
                          lm_train_step_card_vs_cpu, mesh_train_pair, moe_block_mesh_vs_plain,
                          nan_equal, nonfinite_tables, probe_tile, query_rows, remat_grads,
                          saturation_cases, serve_mesh_vs_plain, short_orders, tie_cases,
                          tie_table, train_crash_resume, trimmed, underflow_keys, underflow_table,
                          wide_edge_case, word_edge_case, word_edge_indexes, word_rows)
from repro_torch.core.strings import StringSet
from repro_torch.core.builder import LITSBuilder, LITSConfig
from repro_torch.core.tensor_index import DATA_FIELDS, freeze, pad_queries
from repro_torch.data import synthetic
from repro_torch.kernels import _build, cnode_probe, hpt_cdf, hpt_locate, rank, traverse

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _dev(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def test_cuda_kernels_build(cuda):
    _build.build_all()
    for name in _build.SOURCES:
        assert _build.library(name) is not None


@pytest.mark.parametrize("max_steps", [64, 5])
def test_cuda_hpt_cdf_matches_plain(cuda, max_steps):
    qb, ql, st, hpt = query_rows(np.random.default_rng(1), 20000, 48)
    qb, ql, st, ct, pt = _dev(cuda, qb, ql, st, hpt.cdf_tab, hpt.prob_tab)
    before = _build.LAUNCHES["hpt_cdf"]
    out = hpt_cdf.hpt_cdf_cuda(qb, ql, st, ct, pt, max_steps)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["hpt_cdf"] == before + 1
    want = hpt_cdf.hpt_cdf_plain(qb, ql, st, ct, pt, max_steps)
    assert torch.equal(out, want)


def test_cuda_hpt_locate_matches_plain(cuda):
    rng = np.random.default_rng(2)
    qb, ql, st, hpt = query_rows(rng, 20000, 48)
    B = qb.shape[0]
    alpha = rng.uniform(1, 5e5, B).astype(np.float32)
    beta = rng.uniform(-4, 4, B).astype(np.float32)
    ns = rng.integers(8, 1 << 20, B).astype(np.int32)
    args = _dev(cuda, qb, ql, st, alpha, beta, ns, hpt.cdf_tab, hpt.prob_tab)
    out = hpt_locate.hpt_locate_cuda(*args)
    assert torch.equal(out, hpt_locate.hpt_locate_plain(*args))


@pytest.mark.parametrize("cases", [tie_cases, saturation_cases])
def test_cuda_hpt_locate_edge_cases(cuda, cases):
    """Constructed float32 FMA ties, and NaN/inf slots (saturating cast)."""
    cdf, alpha, beta = cases()
    ct, pt, qb, ql = tie_table(cdf)
    ns = np.full(cdf.shape, 1 << 30, np.int32)
    st = np.zeros(cdf.shape, np.int32)
    args = _dev(cuda, qb, ql, st, alpha, beta, ns, ct, pt)
    out = hpt_locate.hpt_locate_cuda(*args)
    assert torch.equal(out, hpt_locate.hpt_locate_plain(*args))
    if cases is tie_cases:  # the fused multiply-add lands past the midpoint
        assert (out.cpu().numpy() != np.floor(beta).astype(np.int32)).sum() >= 4


@pytest.mark.parametrize("table", CDF_TABLES)
@pytest.mark.parametrize("L,max_steps", [(94, 64), (96, 64), (94, 5), (96, 5)])
@pytest.mark.parametrize("B", CDF_GROUP_BATCHES)
def test_cuda_group_cdf_and_locate_match_plain(cuda, B, L, max_steps, table):
    """K2 and K1 (G lanes per query) equal their plain versions at batch
    sizes around a warp and a block, on rows with qlen 0, start >= qlen,
    qlen > start + 64 and the over-width sentinel, with a built, a one-row
    uniform, a 256-column table and a 1024 x 128 table fed bytes above 127,
    and on the FMA-tie and saturation cases."""
    qb, ql, st, ct, pt, alpha, beta, ns = edge_cdf_rows(L, table)
    qb, ql, st, alpha, beta, ns = _dev(cuda, *(a[:B] for a in (qb, ql, st, alpha, beta, ns)))
    ct, pt = _dev(cuda, ct, pt)
    before = dict(_build.LAUNCHES)
    cdf = hpt_cdf.hpt_cdf_cuda(qb, ql, st, ct, pt, max_steps)
    pos = hpt_locate.hpt_locate_cuda(qb, ql, st, alpha, beta, ns, ct, pt, max_steps)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["hpt_cdf"] == before["hpt_cdf"] + 1
    assert _build.LAUNCHES["hpt_locate"] == before["hpt_locate"] + 1
    assert torch.equal(cdf, hpt_cdf.hpt_cdf_plain(qb, ql, st, ct, pt, max_steps))
    assert torch.equal(pos, hpt_locate.hpt_locate_plain(qb, ql, st, alpha, beta, ns, ct, pt,
                                                        max_steps))


def test_cuda_ftz_ops_match_plain_rule(cuda, tmp_path):
    """The kernels' float ops (PTX ``.ftz`` in ``csrc/lits_walk.cuh``) equal
    the plain versions' flush rule bit for bit around 2**-126: subnormal
    operands (a raw one times a large one, or added to 2**-126), products
    and sums that round to 2**-126 or just below it, an underflowed operand
    times inf, and signs of zero."""
    import ctypes
    import subprocess
    from pathlib import Path

    src = Path(__file__).parent / "csrc" / "ftz_check.cu"
    lib = tmp_path / "libftz_check.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).lits_ftz_ops
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    t = 2.0 ** -126
    rows = [(1 - 2 ** -23, t * (1 + 2 ** -23), 0.0), (1 - 2 ** -24, t, 0.0),
            (1 - 2 ** -24, t, -0.0), (-(1 - 2 ** -24), t, 0.0),
            (2 * t, -2 * t * (1 - 2 ** -23), 0.0), (1.0, 2 * t, -2 * t * (1 - 2 ** -23)),
            (2.0 ** -130, 1.0, 0.5), (2.0 ** -133, np.inf, 0.0), (0.5, 2.0 ** -70, 2.0 ** -140),
            (2.0 ** -70, 2.0 ** -70, -0.0), (1 + 2 ** -23, t * (1 - 2 ** -23), 0.0),
            (3.0, 0.25, 1.0), (t, t, t), (2.0 ** -140, 2.0 ** 100, 0.0), (t / 2, t, 0.0)]
    a, b, c = (torch.tensor(col, dtype=torch.float32) for col in zip(*rows))
    da, db, dc = (x.to(cuda) for x in (a, b, c))
    out = torch.empty(3 * a.shape[0], device=cuda)
    err = fn(da.data_ptr(), db.data_ptr(), dc.data_ptr(), out.data_ptr(), a.shape[0],
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    got = out.cpu().view(-1, 3).T.contiguous()
    want = [hpt_cdf.mul_ftz(a, b), hpt_cdf.add_ftz(a, b), hpt_locate.fma_f32(a, b, c)]
    for name, g, w in zip(("mul", "add", "fma"), got, want):
        assert nan_equal(g.numpy(), w.numpy()), (name, g, w)


def test_cuda_wrappers_reject_bad_input(cuda):
    qb, ql, st, hpt = query_rows(np.random.default_rng(4), 64, 16)
    qb, ql, st, ct, pt = _dev(cuda, qb, ql, st, hpt.cdf_tab, hpt.prob_tab)
    with pytest.raises(ValueError, match="dtype"):
        hpt_cdf.hpt_cdf_cuda(qb, ql.long(), st, ct, pt)
    with pytest.raises(ValueError, match="on cpu"):
        hpt_cdf.hpt_cdf_cuda(qb, ql, st.cpu(), ct, pt)
    with pytest.raises(ValueError, match="contiguous"):
        hpt_cdf.hpt_cdf_cuda(qb.t().contiguous().t(), ql, st, ct, pt)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("B", [65536, 4133])
@pytest.mark.parametrize("K", [1, 3, 4, 16, 17, 33, 64])
def test_cuda_cnode_probe_matches_plain(cuda, K, B, shifted):
    """K3 (a group of lanes a row, 16-byte loads where the codes are
    aligned, passes of 16 slots past K = 16) equals its plain version: cnt
    past K and <= 0, frm up to K + 1, B not a multiple of a block's 64 rows,
    and a tile whose data pointer is 4 bytes past a 16-byte boundary."""
    args = _dev(cuda, *probe_tile(np.random.default_rng(K * 7 + B), B, K))
    if shifted:
        args[0] = _shifted(args[0], 1)
        assert args[0].is_contiguous() and args[0].data_ptr() % 16 == 4
    got = cnode_probe.cnode_probe_cuda(*args)
    want = cnode_probe.cnode_probe_plain(*args)
    assert torch.equal(got, want)
    assert bool((want >= 0).any()) and bool((want == -1).any())


def test_cuda_collision_index_matches_plain(cuda):
    """K4 on an index whose compact leaves hold equal 16-bit codes
    (``collision_keys``): stored keys behind a false match, never-stored
    keys colliding with one stored key and with several; found, eid and
    levels equal the plain walk's."""
    keys, absent = collision_keys(2, 3000)
    bg = LITSBuilder(device="cuda")
    bg.bulkload(StringSet.from_list(keys))
    tg = freeze(bg)
    qb, ql = _dev(cuda, *pad_queries(keys + absent, tg.width))
    trace = {}
    want = traverse.fused_search_plain(tg, qb, ql, trace=trace)
    st = cnode_probe_stats(tg, qb, ql, trace["item"], *want[:2])
    assert st["false"] > 0 and st["matches"] > st["met"]
    got = traverse.fused_search_cuda(tg, qb, ql)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[0][: len(keys)].all()) and not bool(got[0][len(keys):].any())


def test_cuda_bulkload_and_walk_match_plain(cuda):
    """The card builds the CPU's pools (K1/K2 inside the builder), and K4
    walks them to the plain walk's (found, eid, levels)."""
    keys = synthetic.load("url", 20000, seed=5)
    ss = StringSet.from_list(keys)
    bc, bg = LITSBuilder(device="cpu"), LITSBuilder(device="cuda")
    before = dict(_build.LAUNCHES)
    bc.bulkload(ss)
    bg.bulkload(ss)
    assert _build.LAUNCHES["hpt_cdf"] > before["hpt_cdf"]
    assert _build.LAUNCHES["hpt_locate"] > before["hpt_locate"]
    tc, tg = freeze(bc), freeze(bg)
    for f in DATA_FIELDS:
        assert torch.equal(getattr(tc, f), getattr(tg, f).cpu()), f
    rng = np.random.default_rng(6)
    queries = [keys[i] for i in rng.permutation(len(keys))[:8000]]
    queries += [k[: len(k) // 2] for k in queries[:2000]]
    queries += [k + b"x" * tg.width for k in queries[:500]]
    qb, ql = _dev(cuda, *pad_queries(queries, tg.width))
    got = traverse.fused_search_cuda(tg, qb, ql)
    want = traverse.fused_search_plain(tg, qb, ql)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cuda_get_batch_matches_cpu(cuda):
    from repro_torch.index import IndexConfig, StringIndex

    keys = synthetic.load("email", 5000, seed=7)
    vals = np.random.default_rng(8).integers(-(1 << 62), 1 << 62, len(keys), dtype=np.int64)
    queries = keys[::2] + [k[:-1] for k in keys[:500]] + [b"never@stored"]
    g = StringIndex.bulk_load(keys, vals, IndexConfig()).get_batch(queries)
    c = StringIndex.bulk_load(keys, vals, IndexConfig(device="cpu")).get_batch(queries)
    for a, b in zip(g, c):
        np.testing.assert_array_equal(a, b)


def _write_ops(keys):
    """Put and delete batches over base keys, fresh keys, duplicates and
    over-width keys, with entry 0's key put ahead of other ops."""
    fresh = [k + b"#%d" % i for i, k in enumerate(keys[:600])]
    longk = [b"w" * 200]
    return [
        ("put", [keys[0]] + fresh[:200] + keys[1:100] + longk + fresh[:5]),
        ("delete", keys[100:300] + fresh[100:150] + [b"never-stored"] + longk),
        ("put", keys[100:150] + fresh[100:120] + fresh[200:400] + keys[400:450]),
        ("delete", keys[120:130] + fresh[300:350] + keys[500:600]),
    ]


def test_cuda_write_path_matches_cpu(cuda):
    """The same op sequence on a card index (K4 base walk) and a CPU index
    (the plain walk) leaves every field, and the returned masks, equal."""
    from repro_torch.index import IndexConfig, StringIndex

    keys = synthetic.load("url", 6000, seed=9)
    vals = np.arange(len(keys), dtype=np.int64) * 7
    g = StringIndex.bulk_load(keys, vals, IndexConfig(delta_capacity=1024))
    c = StringIndex.bulk_load(keys, vals, IndexConfig(device="cpu", delta_capacity=1024))
    ops, rng = _write_ops(keys), np.random.default_rng(10)
    before = _build.LAUNCHES["fused_search"]
    for kind, batch in ops:
        if kind == "put":
            v = rng.integers(-(1 << 62), 1 << 62, len(batch))
            out = g.put_batch(batch, v), c.put_batch(batch, v)
        else:
            out = g.delete_batch(batch), c.delete_batch(batch)
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)
        for f in DATA_FIELDS:
            assert torch.equal(getattr(g.ti, f).cpu(), getattr(c.ti, f)), f
    assert _build.LAUNCHES["fused_search"] == before + len(ops)
    assert g.delta_fill == c.delta_fill > 0


def test_cuda_merge_matches_cpu(cuda):
    """Two merge cycles on a card index (K1 places the replayed keys, K2 and
    K1 build the rebuilt nodes) and on a CPU index built from the same keys
    (the plain versions) leave every field, the builders' sorted orders and
    height bounds, and the answers equal; each card merge launches K1."""
    from repro_torch.index import IndexConfig, StringIndex

    keys = synthetic.load("url", 8000, seed=21)
    vals = np.arange(len(keys), dtype=np.int64) * 5
    kw = dict(delta_capacity=2048, auto_merge_threshold=None)
    g = StringIndex.bulk_load(keys, vals, IndexConfig(**kw))
    c = StringIndex.bulk_load(keys, vals, IndexConfig(device="cpu", **kw))
    rng = np.random.default_rng(22)
    fresh = [k + b"/m%d" % i for i, k in enumerate(keys[::4])]
    for cycle in range(2):
        puts = fresh[cycle::2][:900] + keys[cycle::50]
        dels = keys[1 + cycle::37] + fresh[cycle::11]
        v = rng.integers(-(1 << 62), 1 << 62, len(puts))
        for ix in (g, c):
            ix.put_batch(puts, v)
            ix.delete_batch(dels)
        before = dict(_build.LAUNCHES)
        g.merge()
        torch.cuda.synchronize()
        assert _build.LAUNCHES["hpt_locate"] > before["hpt_locate"]
        c.merge()
        assert g.epoch == c.epoch == cycle + 1
        for f in DATA_FIELDS:
            assert torch.equal(getattr(g.ti, f).cpu(), getattr(c.ti, f)), f
        assert (g.ti.max_iters, g.ti.cdf_steps) == (c.ti.max_iters, c.ti.cdf_steps)
        assert g._builder.height_bound() == c._builder.height_bound()
        assert np.array_equal(g._builder.sorted_eids(), c._builder.sorted_eids())
        probe = keys[::3] + fresh[::3]
        for a, b in zip(g.get_batch(probe), c.get_batch(probe)):
            np.testing.assert_array_equal(a, b)


def test_cuda_underflow_index_matches_cpu(cuda):
    """An index over keys whose GetCDF underflows (the one-row HPT of
    ``underflow_table``): built on the card and on the CPU, its pools are
    equal, and K4 walks them to the plain walk's answers."""
    from repro_torch.core.hpt import HPT

    ct, pt = underflow_table()
    keys = underflow_keys(61, 3000)
    ss = StringSet.from_list(keys)
    bc = LITSBuilder(hpt=HPT(ct, pt), device="cpu")
    bg = LITSBuilder(hpt=HPT(ct, pt), device="cuda")
    bc.bulkload(ss)
    bg.bulkload(ss)
    tc, tg = freeze(bc), freeze(bg)
    for f in DATA_FIELDS:
        assert torch.equal(getattr(tc, f), getattr(tg, f).cpu()), f
    queries = keys + [k + b"a" for k in keys[::5]] + [k[:-1] for k in keys[::7]]
    qb, ql = _dev(cuda, *pad_queries(queries, tg.width))
    got = traverse.fused_search_cuda(tg, qb, ql)
    for a, b in zip(got, traverse.fused_search_plain(tg, qb, ql)):
        assert torch.equal(a, b)


def _live_index(dev):
    from repro_torch.index import IndexConfig, StringIndex

    keys = synthetic.load("url", 20000, seed=12)
    ix = StringIndex.bulk_load(keys, None, IndexConfig(delta_capacity=2048, device=dev,
                                                       auto_merge_threshold=None))
    return keys, ix


def _starts(keys, W, rng):
    s = [keys[i] for i in rng.integers(0, len(keys), 6000)]
    s += [k[: len(k) // 2] for k in s[:2000]] + [k + b"/" * W for k in s[:500]]
    return s + [keys[i] + b"\x00" for i in rng.integers(0, len(keys), 1500)] + [b"", b"\xff"]


def test_cuda_rank_and_scan_match_plain(cuda):
    """K5 and K6 equal their plain versions, with an empty and a live delta."""
    from repro_torch.kernels import rank, scan

    keys, ix = _live_index("cuda")
    ti = ix.ti
    rng = np.random.default_rng(13)
    qb, ql = _dev(cuda, *pad_queries(_starts(keys, ti.width, rng), ti.width))
    assert torch.equal(rank.fused_rank_cuda(ti, qb, ql), rank.fused_rank_plain(ti, qb, ql))
    for live in (False, True):
        if live:
            fresh = [keys[i] + b"~" for i in rng.integers(0, len(keys), 1500)]
            ix.put_batch(fresh, np.arange(len(fresh)))
            ix.delete_batch([keys[i] for i in rng.integers(0, len(keys), 400)] + fresh[::5])
            ti = ix.ti
            assert int(ti.de_count) > 0
        for window in (1, 16):
            before = _build.LAUNCHES["scan"]
            got = scan.fused_scan_cuda(ti, qb, ql, window=window)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["scan"] == before + 1
            want = scan.fused_scan_plain(ti, qb, ql, window=window)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert bool(got[2].any()) == live


def test_cuda_onehot_cdf_matches_plain_and_k2(cuda):
    """K7 equals its plain version and K2, and ops.hpt_cdf(variant="onehot")
    launches K7, never K2."""
    from repro_torch.kernels import ops

    qb, ql, st, hpt = query_rows(np.random.default_rng(14), 20000, 48)
    qb, ql, st, ct, pt = _dev(cuda, qb, ql, st, hpt.cdf_tab, hpt.prob_tab)
    got = hpt_cdf.hpt_cdf_onehot_cuda(qb, ql, st, ct, pt)
    assert torch.equal(got, hpt_cdf.hpt_cdf_onehot_plain(qb, ql, st, ct, pt))
    assert torch.equal(got, hpt_cdf.hpt_cdf_cuda(qb, ql, st, ct, pt))
    before = dict(_build.LAUNCHES)
    via = ops.hpt_cdf(qb, ql, st, cdf_tab=ct, prob_tab=pt, variant="onehot")
    torch.cuda.synchronize()
    assert torch.equal(via, got)
    assert _build.LAUNCHES["hpt_cdf_onehot"] == before["hpt_cdf_onehot"] + 1
    assert _build.LAUNCHES["hpt_cdf"] == before["hpt_cdf"]


@pytest.mark.parametrize("entries", ["finite", "non-finite"])
@pytest.mark.parametrize("table", CDF_TABLES)
@pytest.mark.parametrize("B", [1, 33, 257, 65536])
def test_cuda_onehot_cdf_edge_rows_match_plain(cuda, B, table, entries):
    """K7 equals its plain version (NaN equal to NaN) on the GetCDF edge
    rows (qlen 0, start >= qlen, qlen > start + 64, the over-width sentinel,
    bytes >= C) and tables, finite and with the inf, -inf and NaN entries of
    ``nonfinite_tables`` (at a selected entry, in another row of a column
    the queries read, in columns they do not read); on finite tables it
    equals K2 bit for bit."""
    qb, ql, st, ct, pt = edge_cdf_rows(94, table)[:5]
    qb, ql, st = (a[:B] for a in (qb, ql, st))
    if entries == "non-finite":
        ct, pt = nonfinite_tables(qb, ql, st, ct, pt, 64)
    qb, ql, st, ct, pt = _dev(cuda, qb, ql, st, ct, pt)
    before = dict(_build.LAUNCHES)
    got = hpt_cdf.hpt_cdf_onehot_cuda(qb, ql, st, ct, pt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["hpt_cdf_onehot"] == before["hpt_cdf_onehot"] + 1
    assert _build.LAUNCHES["hpt_cdf"] == before["hpt_cdf"]
    assert nan_equal(got.cpu().numpy(), hpt_cdf.hpt_cdf_onehot_plain(qb, ql, st, ct, pt).cpu().numpy())
    if entries == "finite":
        assert torch.equal(got, hpt_cdf.hpt_cdf_cuda(qb, ql, st, ct, pt))


@pytest.mark.parametrize("pools", ["whole", "trimmed", "shifted"])
def test_cuda_rank_short_orders_match_plain(cuda, pools):
    """K5 equals its plain version and bisect on sorted
    orders of every length 0..300 with duplicates (length 0 is the one-entry
    pad), at rank_iters ceil(log2(n + 1)) and ceil(log2 n) + 2, with the key
    pool padded as freeze pads it, cut to its used bytes, and shifted off
    16-byte alignment; and on an EMPTY root's one-entry pad."""
    from types import SimpleNamespace

    from repro_torch.index import IndexConfig, StringIndex

    for keys, queries, tables in short_orders(7, width=8):
        srt, off, ln, pool = _dev(cuda, *tables)
        if pools == "trimmed":
            pool = pool[: max(int(ln.sum()), 1)]
        elif pools == "shifted":
            pool = _shifted(pool, 3)
        qb, ql = _dev(cuda, *pad_queries(queries, 8))
        n = srt.shape[0]
        for iters in {n.bit_length(), int(np.ceil(np.log2(n))) + 2}:
            ti = SimpleNamespace(width=8, rank_iters=iters, ent_sorted=srt, ent_off=off,
                                 ent_len=ln, key_bytes=pool)
            got = rank.fused_rank_cuda(ti, qb, ql)
            assert torch.equal(got, rank.fused_rank_plain(ti, qb, ql)), (len(keys), iters)
            if keys:
                assert got.tolist() == [bisect.bisect_left(keys, q) for q in queries]
    ix = StringIndex.bulk_load([], np.zeros(0, np.int64), IndexConfig(device="cuda"))
    assert int(ix.ti.root_item) == 0 and ix.ti.ent_sorted.shape[0] == 1
    qb, ql = _dev(cuda, *pad_queries([b"", b"a", b"z" * (ix.ti.width + 1)], ix.ti.width))
    got = rank.fused_rank_cuda(ix.ti, qb, ql)
    assert torch.equal(got, rank.fused_rank_plain(ix.ti, qb, ql))


def test_cuda_rank_refuses_too_few_iters(cuda):
    """K5 returns the lower bound, as a halving search of at least
    ceil(log2(n + 1)) steps does: the wrapper refuses fewer steps."""
    keys, ix = _live_index("cuda")
    ti = ix.ti
    n = ti.ent_sorted.shape[0]
    qb, ql = _dev(cuda, *pad_queries(keys[::50], ti.width))
    few = dataclasses.replace(ti, rank_iters=n.bit_length() - 1)
    with pytest.raises(ValueError, match="rank_iters"):
        rank.fused_rank_cuda(few, qb, ql)
    least = dataclasses.replace(ti, rank_iters=n.bit_length())
    assert torch.equal(rank.fused_rank_cuda(least, qb, ql), rank.fused_rank_plain(least, qb, ql))


_WORD_INDEXES = {}


def _word_indexes(width, case=word_edge_case):
    """An edge case on the card: (empty delta, live delta)."""
    if (width, case) not in _WORD_INDEXES:
        from repro_torch.index import IndexConfig, StringIndex

        _WORD_INDEXES[width, case] = word_edge_indexes(StringIndex, IndexConfig, LITSConfig,
                                                       width, case, device="cuda")
    return _WORD_INDEXES[width, case]


def _shifted(t, by):
    """A contiguous view of ``t`` whose data pointer is ``by`` bytes past a
    16-byte boundary."""
    flat = torch.cat([t.new_zeros(by), t.reshape(-1)])[by:]
    return flat.view(t.shape)


@pytest.mark.parametrize("pools", ["whole", "trimmed", "shifted"])
@pytest.mark.parametrize("width", [40, 94, 200])
@pytest.mark.parametrize("B", WORD_BATCHES)
def test_cuda_word_edge_cases_match_plain(cuda, B, width, pools):
    """K4 and K6 (staged rows, word compares, K6's multi-way rank and
    merge) equal their plain versions on the word-path edge cases, at batch
    sizes that leave ragged blocks and groups, with an empty and a live
    delta, with whole key pools, with pools cut to their used bytes (the
    last keys' chunks pass the end: the byte path) and with pools and query
    rows whose data pointers are not 16-byte aligned."""
    from repro_torch.kernels import scan

    empty, live = _word_indexes(width)
    _, _, queries, starts = word_edge_case(width)
    for ti, rows in ((empty, queries), (live, queries), (empty, starts), (live, starts)):
        qb, ql = _dev(cuda, *pad_queries(word_rows(rows, B), width))
        if pools == "trimmed":
            ti = trimmed(ti)
        elif pools == "shifted":
            ti = dataclasses.replace(ti, key_bytes=_shifted(ti.key_bytes, 3),
                                     db_bytes=_shifted(ti.db_bytes, 5))
            qb = _shifted(qb, 5)
        before = dict(_build.LAUNCHES)
        got = traverse.fused_search_cuda(ti, qb, ql)
        for a, b in zip(got, traverse.fused_search_plain(ti, qb, ql)):
            assert torch.equal(a, b)
        for window in (1, WORD_WINDOW):
            got = scan.fused_scan_cuda(ti, qb, ql, window=window)
            for a, b in zip(got, scan.fused_scan_plain(ti, qb, ql, window=window)):
                assert torch.equal(a, b)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["fused_search"] == before["fused_search"] + 1
        assert _build.LAUNCHES["scan"] == before["scan"] + 2



@pytest.mark.parametrize("pools", ["whole", "trimmed", "shifted"])
@pytest.mark.parametrize("width", [40, 94, 200])
@pytest.mark.parametrize("B", WORD_BATCHES)
def test_cuda_rank_word_edge_cases_match_plain(cuda, B, width, pools):
    """K5 (staged rows, word compares, the multi-way search over the
    per-rank records K6 shares) equals its plain version on the word-path
    edge cases: rows at the width and over it (length W + 1), proper
    prefixes both ways, embedded zeros, bytes >= 0x80, at batch sizes that
    leave ragged blocks and groups, with whole key pools, pools cut to
    their used bytes and pools and rows off 16-byte alignment."""
    empty, _ = _word_indexes(width)
    _, _, queries, starts = word_edge_case(width)
    for rows in (queries, starts):
        ti = empty
        qb, ql = _dev(cuda, *pad_queries(word_rows(rows, B), width))
        if pools == "trimmed":
            ti = trimmed(ti)
        elif pools == "shifted":
            ti = dataclasses.replace(ti, key_bytes=_shifted(ti.key_bytes, 3))
            qb = _shifted(qb, 5)
        before = _build.LAUNCHES["rank"]
        got = rank.fused_rank_cuda(ti, qb, ql)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["rank"] == before + 1
        assert torch.equal(got, rank.fused_rank_plain(ti, qb, ql))


@pytest.mark.parametrize("pools", ["whole", "trimmed", "shifted"])
@pytest.mark.parametrize("width", [1000, 2000, 60000])
@pytest.mark.parametrize("B", [1, 33, 257])
def test_cuda_wide_rows_match_plain(cuda, B, width, pools):
    """K4, K5 and K6 equal their plain versions on rows so wide that a block
    stages fewer rows than its default: at width 1,000 (K5 and K6 halve
    their rows), 2,000 (K4 goes below a warp of rows) and 60,000 (one row
    passes the 48 KB a launch gets by default, and the kernels opt in to
    more), with an empty and a live delta."""
    from repro_torch.kernels import scan

    empty, live = _word_indexes(width, wide_edge_case)
    _, _, queries, starts = wide_edge_case(width)
    for ti, rows in ((empty, queries), (live, starts)):
        qb, ql = _dev(cuda, *pad_queries(word_rows(rows, B), width))
        if pools == "trimmed":
            ti = trimmed(ti)
        elif pools == "shifted":
            ti = dataclasses.replace(ti, key_bytes=_shifted(ti.key_bytes, 3),
                                     db_bytes=_shifted(ti.db_bytes, 5))
            qb = _shifted(qb, 5)
        before = dict(_build.LAUNCHES)
        for a, b in zip(traverse.fused_search_cuda(ti, qb, ql),
                        traverse.fused_search_plain(ti, qb, ql)):
            assert torch.equal(a, b)
        assert torch.equal(rank.fused_rank_cuda(ti, qb, ql), rank.fused_rank_plain(ti, qb, ql))
        for a, b in zip(scan.fused_scan_cuda(ti, qb, ql, window=WORD_WINDOW),
                        scan.fused_scan_plain(ti, qb, ql, window=WORD_WINDOW)):
            assert torch.equal(a, b)
        torch.cuda.synchronize()
        for name in ("fused_search", "rank", "scan"):
            assert _build.LAUNCHES[name] == before[name] + 1


def _stage_limit_widths(dev):
    """The widest row a block can stage in shared memory and the next width,
    which stages in device memory: ``4 * stage_stride(W)`` bytes against the
    device's opt-in limit."""
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    under = 4 * (limit // 4)
    while 4 * (((under + 3) // 4) | 1) > limit:
        under -= 1
    over = under + 1
    while 4 * (((over + 3) // 4) | 1) <= limit:
        over += 1
    return under, over


@pytest.mark.parametrize("width", ["under", "over", 240_000, 300_000])
def test_cuda_rows_past_stage_limit_match_plain(cuda, width):
    """K4, K5 and K6 equal their plain versions on rows too wide to stage in
    shared memory, which they read in place from the wrapper's padded matrix
    in device memory instead, and on the widest rows that still stage in
    shared memory ("under"; "over" is the next width), with an empty and a
    live delta: on 37 rows (a row a block) and on 141 (more rows than an
    H100's 132 SMs: two a block, the last block filled with a padding row)."""
    from repro_torch.kernels import scan

    under, over = _stage_limit_widths(cuda)
    W = {"under": under, "over": over}.get(width, width)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B in (1, 37, 141):
        for lanes in (1, 4):
            padded, (_, rows) = _build.wide_rows(
                torch.zeros(B, W, dtype=torch.uint8, device=cuda), lanes)
            assert (padded is None) == (width == "under") == (rows == 0)
            if padded is not None:
                assert rows == 1 if B <= n_sm else rows > 1
                assert padded.shape[0] % rows == 0 and padded.shape[0] - B < rows
    empty, live = _word_indexes(W, wide_edge_case)
    _, _, queries, starts = wide_edge_case(W)
    for B in (37, 141):
        for ti, rows in ((empty, queries), (live, starts)):
            qb, ql = _dev(cuda, *pad_queries(word_rows(rows, B), W))
            before = dict(_build.LAUNCHES)
            for a, b in zip(traverse.fused_search_cuda(ti, qb, ql),
                            traverse.fused_search_plain(ti, qb, ql)):
                assert torch.equal(a, b)
            assert torch.equal(rank.fused_rank_cuda(ti, qb, ql),
                               rank.fused_rank_plain(ti, qb, ql))
            for a, b in zip(scan.fused_scan_cuda(ti, qb, ql, window=WORD_WINDOW),
                            scan.fused_scan_plain(ti, qb, ql, window=WORD_WINDOW)):
                assert torch.equal(a, b)
            torch.cuda.synchronize()
            for name in ("fused_search", "rank", "scan"):
                assert _build.LAUNCHES[name] == before[name] + 1


def _mixed_requests(keys, rng, n=3000):
    """Puts of fresh keys and of stored ones, deletes, gets and scans of two
    windows, in random order."""
    from repro_torch.index import DeleteRequest, GetRequest, PutRequest, ScanRequest

    pick = rng.choice(len(keys), 800, replace=False)
    reqs = ([PutRequest(b"fresh/%05d" % i, int(v)) for i, v in enumerate(
                rng.integers(-(1 << 62), 1 << 62, 600))]
            + [PutRequest(keys[i], -int(i)) for i in pick[:500]]
            + [DeleteRequest(keys[i]) for i in pick[500:]]
            + [DeleteRequest(b"fresh/%05d" % i) for i in range(0, 600, 7)]
            + [ScanRequest(keys[i][:12], 16 if i % 2 else 64) for i in pick[:200]])
    reqs += [GetRequest(keys[i]) for i in rng.integers(0, len(keys), n - len(reqs) - 200)]
    reqs += [GetRequest(b"fresh/%05d" % i) for i in range(0, 600, 3)]
    return [reqs[i] for i in rng.permutation(len(reqs))]


def _cpu_copy(ix):
    from repro_torch.core.tensor_index import DATA_FIELDS
    from repro_torch.index import IndexConfig, StringIndex

    ti = dataclasses.replace(ix.ti, **{f: getattr(ix.ti, f).cpu() for f in DATA_FIELDS})
    return StringIndex(None, ti, dataclasses.replace(ix.config, device="cpu"))


def test_cuda_execute_matches_cpu(cuda):
    """One mixed ``execute`` batch on the card (K4 for gets and the write
    path's walk, K6 for scans) gives the results of the same batch on a CPU
    copy of the index, and leaves the same pools."""
    from repro_torch.core.tensor_index import DATA_FIELDS

    keys, ix = _live_index("cuda")
    cpu = _cpu_copy(ix)
    batch = _mixed_requests(keys, np.random.default_rng(31))
    before = dict(_build.LAUNCHES)
    got = ix.execute(batch)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_search"] > before["fused_search"]
    assert _build.LAUNCHES["scan"] == before["scan"] + 2
    want = cpu.execute(batch)
    assert got.results == want.results
    assert (got.merged, got.delta_fill) == (want.merged, want.delta_fill)
    for f in DATA_FIELDS:
        assert torch.equal(getattr(ix.ti, f).cpu(), getattr(cpu.ti, f)), f


def test_cuda_snapshot_loads_on_cpu(cuda, tmp_path):
    """A snapshot saved from the card, with a live delta and tombstones,
    loads with ``device="cpu"`` and on the card, and both answer as the
    live index does."""
    from repro_torch.core.tensor_index import DATA_FIELDS
    from repro_torch.index import IndexConfig, StringIndex

    keys, ix = _live_index("cuda")
    ix.execute(_mixed_requests(keys, np.random.default_rng(32)))
    path = str(tmp_path / "card.snap")
    ix.save(path)
    cfg = dict(auto_merge_threshold=None)
    cpu = StringIndex.load(path, IndexConfig(device="cpu", **cfg))
    card = StringIndex.load(path, IndexConfig(device="cuda", **cfg))
    for f in DATA_FIELDS:
        assert torch.equal(getattr(ix.ti, f).cpu(), getattr(cpu.ti, f)), f
    rng = np.random.default_rng(33)
    probe = [keys[i] for i in rng.integers(0, len(keys), 4000)] + [b"fresh/%05d" % i
                                                                   for i in range(600)]
    want = ix.get_batch(probe)
    for other in (cpu, card):
        for a, b in zip(want, other.get_batch(probe)):
            np.testing.assert_array_equal(a, b)
    starts = [k[:10] for k in probe[:2000]]
    want = [t.cpu() for t in ix.scan_batch(starts, 16)]
    for other in (cpu, card):
        for a, b in zip(want, other.scan_batch(starts, 16)):
            assert torch.equal(a, b.cpu())
    assert ix.scan(b"", 40) == cpu.scan(b"", 40) == card.scan(b"", 40)


def _sharded_pair(n_shards):
    """A sharded url index built on the card and on the CPU, the keys and
    values; 2,999 keys leave the shards unequal, so their orders are padded."""
    from repro_torch.distributed import build_sharded

    keys = synthetic.load("url", 2999, seed=8)
    vals = np.random.default_rng(8).integers(-(1 << 62), 1 << 62, len(keys))
    return (build_sharded(keys, vals, n_shards, device="cuda"),
            build_sharded(keys, vals, n_shards, device="cpu"), keys, vals)


def test_cuda_distributed_matches_cpu(cuda):
    """``build_sharded`` on the card (K2/K1) gives the CPU's stacked pools;
    the in-process routed lookup (router K2, each owner's K4) and
    ``scan_entries`` (K6 per shard, padded orders replayed) answer as on the
    CPU, at a capacity that holds every row and at one that overflows."""
    from repro_torch.distributed import DistributedStringIndex, make_service_fn
    from repro_torch.index import IndexConfig

    card, cpu, keys, vals = _sharded_pair(4)
    np.testing.assert_array_equal(card.boundaries, cpu.boundaries)
    assert card.sorted_lens == cpu.sorted_lens and len(set(cpu.sorted_lens)) > 1
    for f in DATA_FIELDS:
        assert torch.equal(getattr(card.stacked, f).cpu(), getattr(cpu.stacked, f)), f
    rng = np.random.default_rng(9)
    q = [keys[i] for i in rng.integers(0, len(keys), 3000)] + [k + b"/" for k in keys[:500]]
    q += [b"", b"h" * (card.width + 2), keys[0][:5], keys[-1] + b"~"] * 25
    qb, ql = pad_queries(q, card.width)
    for cap in (len(q), 150):
        before = dict(_build.LAUNCHES)
        got = make_service_fn(card, cap)(*_dev(cuda, qb, ql))
        torch.cuda.synchronize()
        assert _build.LAUNCHES["hpt_cdf"] == before["hpt_cdf"] + 1
        assert _build.LAUNCHES["fused_search"] == before["fused_search"] + 4
        want = make_service_fn(cpu, cap)(*_dev("cpu", qb, ql))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    on_card = DistributedStringIndex(card, per_dest_capacity=len(q),
                                     config=IndexConfig(device="cuda"))
    on_cpu = DistributedStringIndex(cpu, per_dest_capacity=len(q),
                                    config=IndexConfig(device="cpu"))
    for a, b in zip(on_card.get_batch(q), on_cpu.get_batch(q)):
        np.testing.assert_array_equal(a, b)
    ends = np.cumsum(cpu.sorted_lens)
    starts = [keys[min(e + d, len(keys) - 1)] for e in ends for d in (-9, -4, -1, 0)]
    starts += [k[:12] for k in q[:1500]] + [keys[-1] + b"~"]
    before = _build.LAUNCHES["scan"]
    got = on_card.scan_entries(starts, 16)
    assert _build.LAUNCHES["scan"] > before
    assert got == on_cpu.scan_entries(starts, 16)


def test_cuda_nccl_one_rank_matches_in_process(cuda):
    """The process-group form over NCCL with one rank (one card holds one
    rank): its exchanges run on the card and give the in-process answers."""
    import socket

    import torch.distributed as dist

    from repro_torch.distributed import DistributedStringIndex
    from repro_torch.index import GetRequest, IndexConfig

    card, _cpu, keys, _vals = _sharded_pair(1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        cfg = IndexConfig(device="cuda")
        rng = np.random.default_rng(10)
        q = [keys[i] for i in rng.integers(0, len(keys), 2000)] + [b"absent", b""]
        for cap in (4096, 500):
            pg = DistributedStringIndex(card, group=dist.group.WORLD, per_dest_capacity=cap,
                                        config=cfg)
            here = DistributedStringIndex(card, per_dest_capacity=cap, config=cfg)
            qb, ql = _dev(cuda, *pad_queries(q, card.width))
            for a, b in zip(pg._fn(qb, ql), here._fn(qb, ql)):
                assert torch.equal(a, b)
        assert pg.execute([GetRequest(k) for k in q[:100]]).results == \
            here.execute([GetRequest(k) for k in q[:100]]).results
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the LM serving path: each reduced arch and the engine on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["arctic-480b", "chatglm3-6b", "deepseek-7b",
                                  "falcon-mamba-7b", "h2o-danube-3-4b", "hubert-xlarge",
                                  "hymba-1.5b", "internvl2-76b", "llama4-scout-17b-a16e",
                                  "nemotron-4-15b"])
def test_cuda_reduced_arch_matches_cpu(cuda, arch):
    """Prefill and two decode steps (hubert, encoder-only: its forward) on the
    card against the port on the CPU with the same weights, within ``LM_CARD_TOL``
    (MoE routing can differ on a near-tie, so the MoE archs are held on their
    logits, not on their tokens)."""
    def close(what, got, want):
        assert torch.isfinite(got).all(), what
        torch.testing.assert_close(got.cpu(), want, rtol=LM_CARD_TOL, atol=LM_CARD_TOL)

    lm_card_vs_cpu(arch, cuda, close)


def test_cuda_engine_serves_a_repeated_batch_from_the_cache(cuda):
    """The engine on the card: the second serve of a batch is a cache hit (K4
    walks the prompt keys) and generates the same tokens, bit for bit."""
    from repro_torch.serve import ServeEngine

    cfg, _cpu, card = lm_pair("falcon-mamba-7b", cuda)
    eng = ServeEngine(card, cache_capacity=8, max_len=64)
    try:
        prompts = np.random.default_rng(4).integers(0, cfg.vocab, (3, 16)).astype(np.int32)
        before = _build.LAUNCHES["fused_search"]
        first = eng.generate(prompts, n_steps=8)["generated"]
        again = eng.generate(prompts, n_steps=8)["generated"]
        assert _build.LAUNCHES["fused_search"] > before
        assert eng.stats.prefills == 3 and eng.stats.cached_prefills == 3
        assert np.array_equal(first, again)
    finally:
        eng.prefix_cache.close()


def test_cuda_engine_stored_state_is_unchanged_by_decoding(cuda):
    """The states the engine stores are copies: after the batch's decode steps
    each still equals a fresh prefill of its prompt, bit for bit."""
    from repro_torch.serve import ServeEngine

    cfg, _cpu, card = lm_pair("hymba-1.5b", cuda)
    eng = ServeEngine(card, cache_capacity=8, max_len=64)
    try:
        prompts = np.random.default_rng(5).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
        eng.generate(prompts, n_steps=12)
        cache, logits = card.prefill({"tokens": torch.from_numpy(prompts).to(cuda)}, max_len=23)
        keys = [ServeEngine._prompt_key(prompts[i], 23) for i in range(2)]
        hit, slots = eng.prefix_cache.lookup(keys)
        assert hit.all()
        for i, s in enumerate(slots):
            st = eng.prefix_cache.get_state(s)
            assert torch.equal(st["logits"], logits[i])
            for k, v in cache.items():
                assert torch.equal(st["cache"][k], v[:, i]), k
    finally:
        eng.prefix_cache.close()


# ---------------------------------------------------------------------------
# LM training on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["arctic-480b", "chatglm3-6b", "deepseek-7b",
                                  "falcon-mamba-7b", "h2o-danube-3-4b", "hubert-xlarge",
                                  "hymba-1.5b", "internvl2-76b", "llama4-scout-17b-a16e",
                                  "nemotron-4-15b"])
def test_cuda_train_step_matches_cpu(cuda, arch):
    """One train step of each reduced arch on the card against the CPU port
    with the same weights and batch: the loss within ``LM_CARD_TOL``, the grad
    norm within ``LM_GRAD_RTOL``, every gradient within ``grad_errors``'
    bound, and the parameters after the step within 2.02 · lr (step 1 moves
    each by ±lr where its gradient is not zero)."""
    r = lm_train_step_card_vs_cpu(arch, cuda)
    assert abs(r["card"]["loss"] - r["cpu"]["loss"]) <= LM_CARD_TOL
    assert r["card"]["grad_norm"] == pytest.approx(r["cpu"]["grad_norm"], rel=LM_GRAD_RTOL)
    for name, (err, bound) in r["grads"].items():
        assert err <= bound, (name, err, bound)
    assert r["param_err"] <= 2.02 * r["cpu"]["lr"]


def test_cuda_crash_resume_bitwise(cuda, tmp_path):
    """test_fault_tolerance.py's run on the card: killed at step 7, resumed
    from the step-6 checkpoint, bit for bit the uninterrupted run."""
    out, resumed, clean = train_crash_resume(cuda, str(tmp_path))
    assert out["resumed_from"] == 6
    for name, p in clean.items():
        assert torch.equal(resumed[name], p), name


@pytest.mark.parametrize("arch", ["deepseek-7b", "hymba-1.5b", "falcon-mamba-7b",
                                  "arctic-480b", "internvl2-76b"])
def test_cuda_remat_settings_give_bitwise_equal_grads(cuda, arch):
    cfg, _cpu, card = lm_pair(arch, cuda)
    batch = {k: v.to(cuda) for k, v in lm_train_batch(cfg, np.random.default_rng(1), 2,
                                                       16).items()}
    grads = remat_grads(card, batch)
    for policy in ("none", "dots"):
        for name, g in grads["off"].items():
            assert torch.equal(grads[policy][name], g), (policy, name)


# ---------------------------------------------------------------------------
# the device mesh on one rank (chip_smoke.py's phase mesh at reduced size)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL ``("data", "model")`` mesh, its group ended after the
    test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device=cuda)
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["chatglm3-6b", "llama4-scout-17b-a16e"])
def test_cuda_mesh_train_steps_bitwise(cuda, nccl_mesh, arch):
    """Two steps through ``train_loop.train`` under the one-rank mesh and
    without: every loss, grad norm and parameter equal; every local shard
    the shape ``param_shardings`` gives it."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig

    r = ARCHS[arch].reduced()
    pipe = TokenPipeline(PipelineConfig(vocab=r.vocab, seq_len=64, global_batch=2))
    runs = mesh_train_pair(r, cuda, nccl_mesh, pipe.batch_at, AdamWConfig(),
                           TrainConfig(steps=2, accum=2))
    assert runs["plain"]["differ"] == []
    for key in ("loss", "grad_norm"):
        assert [h[key] for h in runs["mesh"]["history"]] == \
            [h[key] for h in runs["plain"]["history"]]
    assert all(got == want and same for got, want, same in runs["mesh"]["layout"].values())


def test_cuda_mesh_moe_block_and_serving_bitwise(cuda, nccl_mesh):
    """The reduced llama4's MoE block forward and backward in ``ag`` and
    ``ws``, and a prefill with 4 decode steps, under the mesh and without."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import LMModel

    r = ARCHS["llama4-scout-17b-a16e"].reduced()
    model = LMModel(r, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    x = torch.randn((2, 32, r.d_model), generator=torch.Generator(cuda).manual_seed(3),
                    device=cuda).to(torch.bfloat16)
    for mode in ("ag", "ws"):
        assert moe_block_mesh_vs_plain(model, nccl_mesh, x, mode) == [], mode
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, r.vocab, (4, 48)).astype(
        np.int32)).to(cuda)
    assert serve_mesh_vs_plain(model, nccl_mesh, tokens, 4) == []


def test_cuda_compressed_step_bitwise(cuda, nccl_mesh):
    """``make_compressed_dp_step`` over the one-rank data axis: the plain
    update on each gradient's ``dequantize(quantize(g))``, and the error
    state ``g32 - dequantize(q, scale)``."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import LMModel
    from repro_torch.train.optimizer import AdamWConfig

    r = ARCHS["deepseek-7b"].reduced()
    model = LMModel(r, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    batch = {k: v.to(cuda) for k, v in lm_train_batch(r, np.random.default_rng(6), 2,
                                                      32).items()}
    got = compressed_vs_plain(model, nccl_mesh, batch, AdamWConfig())
    assert got["params_differ"] == [] and got["err_differ"] == []
    assert got["compressed"]["loss"] == got["plain"]["loss"]
    assert got["compressed"]["grad_norm"] == got["plain"]["grad_norm"]


# ---------------------------------------------------------------------------
# dense tensor parallelism on one rank, and bf16 parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["chatglm3-6b", "arctic-480b", "falcon-mamba-7b",
                                  "hymba-1.5b"])
def test_cuda_tp_serving_bitwise_on_one_rank(cuda, nccl_mesh, arch):
    """A prefill and 4 decode steps under the one-rank NCCL mesh and without:
    bit for bit, the tensor-parallel path (each rank's heads, mamba channels
    and vocabulary rows, here all of them) summing over the model group
    with NCCL all-reduces."""
    import torch.distributed as dist

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import LMModel

    r = ARCHS[arch].reduced()
    model = LMModel(r, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, r.vocab, (4, 24)).astype(
        np.int32)).to(cuda)
    group, real, calls = nccl_mesh.get_group("model"), dist.all_reduce, []

    def counted(t, *a, **kw):
        calls.append(kw.get("group") is group)
        return real(t, *a, **kw)

    dist.all_reduce = counted
    try:
        assert serve_mesh_vs_plain(model, nccl_mesh, tokens, 4) == []
    finally:
        dist.all_reduce = real
    assert sum(calls) > 0


@pytest.mark.parametrize("arch", ["deepseek-7b", "hymba-1.5b", "arctic-480b"])
def test_cuda_bf16_parameters_match_their_float32_model(cuda, arch):
    """``LMModel(param_dtype=torch.bfloat16)`` with the float32 model's
    weights cast: prefill and two greedy decode steps, the logits within
    ``LM_CARD_TOL`` and the greedy tokens equal (both run the products on
    the same bf16 weights)."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import LMModel

    r = ARCHS[arch].reduced()
    f32 = LMModel(r, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    bf = LMModel(r, device=cuda, param_dtype=torch.bfloat16, init=False)
    with torch.no_grad():
        for q, p in zip(bf.parameters(), f32.parameters()):
            q.copy_(p)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, r.vocab, (2, 16)).astype(
        np.int32)).to(cuda)
    (cf, lf), (cb, lb) = (m.prefill({"tokens": toks}, max_len=20) for m in (f32, bf))
    for step in range(3):
        assert torch.allclose(lb.float(), lf.float(), rtol=LM_CARD_TOL, atol=LM_CARD_TOL)
        tf, tb = (torch.argmax(x[:, : r.vocab], -1).to(torch.int32) for x in (lf, lb))
        assert torch.equal(tf, tb), step
        if step < 2:
            cf, lf = f32.decode_step(cf, tf, 16 + step)
            cb, lb = bf.decode_step(cb, tb, 16 + step)
