"""The port's distributed index service against the JAX package, on the CPU.

* ``build_sharded`` for 1, 3 and 4 shards: the boundaries bit for bit, every
  stacked field and the static meta against the reference's.
* The in-process routed lookup: ``(found, lo, hi, overflow)`` against the
  reference's owner-shard search (its router GetCDF, ``searchsorted``,
  ``base_search_impl`` of the owner's slice, ``lookup_values``) and against
  the oracle; at a capacity that overflows, each sender's dropped rows
  against the owner histogram.  One subprocess runs the reference's
  ``make_service_fn`` over four fake XLA devices on the same inputs.
* ``scan_entries`` against the reference's on a one-device mesh (where its
  scan runs), windows straddling shards and starts past the last key,
  including the reference's padded-order windows.
* ``execute`` statuses, and against the reference's on one shard.
* The process-group form: four gloo CPU processes give the in-process
  form's answers and overflow counts.
"""
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hpt import get_cdf_impl
from repro.core.strings import random_strings
from repro.core.tensor_index import base_search_impl, lookup_values as r_lookup_values
from repro.distributed import index_service as R
from repro.index import (
    DeleteRequest as RDelete, GetRequest as RGet, PutRequest as RPut, ScanRequest as RScan,
)
from repro_torch.core.hpt import HPT, get_cdf_np64
from repro_torch.core.strings import StringSet
from repro_torch.core.tensor_index import DATA_FIELDS, STATIC_FIELDS, pad_queries
from repro_torch.distributed import index_service as T
from repro_torch.index import (
    DeleteRequest, GetRequest, IndexConfig, PutRequest, ScanRequest, Status,
)

SHARDS = (1, 3, 4)
CPU = IndexConfig(device="cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(21)
    keys = sorted(set(random_strings(rng, 1500, 2, 24)))
    vals = rng.integers(-(1 << 62), 1 << 62, len(keys))
    return keys, vals


@pytest.fixture(scope="module")
def built(corpus):
    """Per shard count: (the reference's ShardedIndex, the port's)."""
    keys, vals = corpus
    return {n: (R.build_sharded(keys, vals, n), T.build_sharded(keys, vals, n, device="cpu"))
            for n in SHARDS}


def _build_shard_of(keys, ts):
    """Each key's build shard: the host float64 GetCDF cast to float32,
    bucketed against the boundaries, as ``build_sharded`` partitions."""
    hpt = HPT(ts.stacked.cdf_tab[0].numpy(), ts.stacked.prob_tab[0].numpy())
    cdfs = get_cdf_np64(hpt, StringSet.from_list(keys)).astype(np.float32)
    return np.searchsorted(ts.boundaries, cdfs, side="right")


def _queries(keys, ts, rng, n_rows):
    """Stored keys, misses, the empty key, over-width keys and the keys on
    either side of every boundary, ``n_rows`` of them, shuffled."""
    shard_of = _build_shard_of(keys, ts)
    edge = np.flatnonzero(np.diff(shard_of)) + 1
    q = [keys[i] for j in edge for i in (j - 2, j - 1, j, j + 1) if 0 <= i < len(keys)]
    q += [b"", b"q" * (ts.width + 3), keys[0][:1], keys[-1] + b"~"]
    q += [k + b"!" for k in keys[::41]]
    q += [keys[i] for i in rng.integers(0, len(keys), n_rows - len(q))]
    return [q[i] for i in rng.permutation(len(q))]


def _ref_owner_search(rs, qb, ql):
    """The reference's program for one sender, shard by shard: router GetCDF
    from character 0, ``searchsorted(side="right")``, then each owner's
    ``base_search_impl`` and ``lookup_values``, ``found &= qlen > 0``."""
    ti0 = R._slice_shard(rs.stacked, 0)
    cdf = get_cdf_impl(ti0.cdf_tab, ti0.prob_tab, jnp.asarray(qb), jnp.asarray(ql), 0)
    owner = np.asarray(jnp.searchsorted(jnp.asarray(rs.boundaries), cdf, side="right"))
    found = np.zeros(len(ql), bool)
    lo, hi = np.zeros(len(ql), np.int32), np.zeros(len(ql), np.int32)
    for s in range(rs.n_shards):
        m = owner == s
        f, l, h = (np.asarray(a)[m] for a in _ref_search(R._slice_shard(rs.stacked, s),
                                                          jnp.asarray(qb), jnp.asarray(ql)))
        f = f & (ql[m] > 0)
        found[m], lo[m], hi[m] = f, np.where(f, l, 0), np.where(f, h, 0)
    return found, lo, hi, owner


@jax.jit
def _ref_search(ti, qb, ql):
    """The reference's owner-side search of every row: (found, lo, hi)."""
    found, eid = base_search_impl(ti, qb, ql, "jnp")
    return (found, *r_lookup_values(ti, eid, jnp.zeros_like(found)))


def _kept(owner, n, capacity):
    """Per row, whether its sender's packing keeps it: each sender's rows
    go to their owner in row order, the first ``capacity`` of each kept."""
    senders = owner.reshape(n, -1)
    kept = np.zeros_like(senders, dtype=bool)
    for s, row in enumerate(senders):
        for d in range(n):
            idx = np.flatnonzero(row == d)
            kept[s, idx[:capacity]] = True
    return kept.reshape(-1)


@pytest.mark.parametrize("n", SHARDS)
def test_build_sharded_equals_reference(built, n):
    rs, ts = built[n]
    assert ts.boundaries.dtype == np.float32 and rs.boundaries.dtype == np.float32
    np.testing.assert_array_equal(rs.boundaries.view(np.uint32), ts.boundaries.view(np.uint32))
    assert (rs.n_shards, rs.width) == (ts.n_shards, ts.width)
    for f in DATA_FIELDS:
        a, b = np.asarray(getattr(rs.stacked, f)), getattr(ts.stacked, f).numpy()
        assert a.shape == b.shape and (a.astype(np.float64) == b.astype(np.float64)).all(), f
    for f in STATIC_FIELDS:
        assert getattr(rs.stacked, f) == getattr(ts.stacked, f), f
    es = ts.stacked.ent_sorted.numpy()
    for s, m in enumerate(ts.sorted_lens):
        assert (es[s, m:] == 0).all() and m <= es.shape[1]


@pytest.mark.parametrize("n", SHARDS)
def test_routed_lookup_equals_owner_search_and_oracle(corpus, built, n):
    keys, vals = corpus
    rs, ts = built[n]
    q = _queries(keys, ts, np.random.default_rng(n), 96 * n)
    qb, ql = pad_queries(q, ts.width)
    fn = T.make_service_fn(ts, per_dest_capacity=len(q), device="cpu")
    found, lo, hi, overflow = (t.numpy() for t in fn(torch.from_numpy(qb), torch.from_numpy(ql)))
    w_found, w_lo, w_hi, owner = _ref_owner_search(rs, qb, ql)
    np.testing.assert_array_equal(found, w_found)
    np.testing.assert_array_equal(lo, w_lo)
    np.testing.assert_array_equal(hi, w_hi)
    np.testing.assert_array_equal(overflow, np.zeros(n, np.int64))
    # the oracle: a stored key misses only where the router sends it to a
    # shard that does not hold it, or its own shard's build lost it
    kv = dict(zip(keys, vals.tolist()))
    dsi = T.DistributedStringIndex(ts, per_dest_capacity=len(q), config=CPU)
    g_found, g_vals = dsi.get_batch(q)
    np.testing.assert_array_equal(g_found, found)
    shard_of = dict(zip(keys, _build_shard_of(keys, ts).tolist()))
    for k, f, v, o in zip(q, g_found.tolist(), g_vals.tolist(), owner.tolist()):
        if f:
            assert kv[k] == v
        elif k in kv and o == shard_of[k]:
            lone = T.make_service_fn(ts, per_dest_capacity=n, device="cpu")
            row = pad_queries([k] * n, ts.width)
            assert not lone(*(torch.from_numpy(a) for a in row))[0].any()  # lost in its build
        else:
            assert v == 0


def test_routed_overflow_counts_and_statuses(corpus, built):
    keys, vals = corpus
    rs, ts = built[4]
    q = _queries(keys, ts, np.random.default_rng(9), 4 * 150)
    qb, ql = pad_queries(q, ts.width)
    cap = 24
    found, lo, hi, overflow = (t.numpy() for t in T.make_service_fn(ts, cap, device="cpu")(
        torch.from_numpy(qb), torch.from_numpy(ql)))
    w_found, w_lo, w_hi, owner = _ref_owner_search(rs, qb, ql)
    hist = [np.bincount(o, minlength=4) for o in owner.reshape(4, -1)]
    np.testing.assert_array_equal(overflow, [np.maximum(h - cap, 0).sum() for h in hist])
    assert overflow.sum() > 0
    kept = _kept(owner, 4, cap)
    np.testing.assert_array_equal(found, w_found & kept)
    np.testing.assert_array_equal(lo, np.where(kept, w_lo, 0))
    np.testing.assert_array_equal(hi, np.where(kept, w_hi, 0))
    dsi = T.DistributedStringIndex(ts, per_dest_capacity=cap, config=CPU)
    with pytest.raises(T.RoutingOverflowError, match=f"{overflow.sum()} queries exceeded"):
        dsi.get_batch(q)
    res = dsi.execute([GetRequest(k) for k in q] + [PutRequest(b"x", 1), DeleteRequest(keys[0])])
    assert res.statuses() == [Status.ROUTING_OVERFLOW] * len(q) + [Status.UNSUPPORTED] * 2
    assert dsi.get_batch([]) == (pytest.approx(np.zeros(0)), pytest.approx(np.zeros(0)))


_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses as dc
import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.tensor_index import STATIC_FIELDS, pad_queries
from repro.distributed.index_service import build_sharded, make_service_fn

z = np.load(sys.argv[1])
unpack = lambda m, l: [bytes(r[:n]) for r, n in zip(m, l)]
sidx = build_sharded(unpack(z["kb"], z["kl"]), z["vals"], 4)
mesh = jax.make_mesh((4,), ("data",))
put = lambda a: jax.device_put(a, NamedSharding(mesh, P("data")))
stk = type(sidx.stacked)(**{f.name: getattr(sidx.stacked, f.name) if f.name in STATIC_FIELDS
                            else put(getattr(sidx.stacked, f.name))
                            for f in dc.fields(sidx.stacked)})
sidx = dc.replace(sidx, stacked=stk)
qb, ql = pad_queries(unpack(z["qb"], z["ql"]), sidx.width)
out = {}
for cap in z["caps"].tolist():
    res = make_service_fn(sidx, mesh, per_dest_capacity=cap)(stk, put(qb), put(ql))
    for name, a in zip(("found", "lo", "hi", "overflow"), res):
        out[f"{name}_{cap}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
"""


def test_routed_lookup_equals_reference_on_four_devices(corpus, built, tmp_path):
    """The reference's ``make_service_fn`` over four fake XLA devices (a
    subprocess: the device count is fixed before JAX starts) and the port's
    in-process routed lookup answer alike, at a capacity that holds every
    row and at one that overflows."""
    keys, vals = corpus
    _, ts = built[4]
    q = _queries(keys, ts, np.random.default_rng(4), 4 * 160)
    caps = [len(q), 30]
    kb = StringSet.from_list(keys)
    qs = StringSet.from_list(q, width=max(len(k) for k in q))
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, kb=kb.bytes, kl=kb.lens, vals=vals, qb=qs.bytes, ql=qs.lens, caps=caps)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    run = subprocess.run([sys.executable, "-c", _SCRIPT, str(inp), str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    want = np.load(out)
    qb, ql = (torch.from_numpy(a) for a in pad_queries(q, ts.width))
    for cap in caps:
        got = T.make_service_fn(ts, cap, device="cpu")(qb, ql)
        for name, g in zip(("found", "lo", "hi", "overflow"), got):
            np.testing.assert_array_equal(g.numpy(), want[f"{name}_{cap}"].astype(g.numpy().dtype),
                                          err_msg=f"{name} at capacity {cap}")
    assert want[f"overflow_{caps[1]}"].sum() > 0 and want[f"overflow_{caps[0]}"].sum() == 0


@pytest.mark.parametrize("n", SHARDS)
def test_scan_entries_equal_reference_one_device_mesh(corpus, built, n):
    keys, vals = corpus
    rs, ts = built[n]
    ref = R.DistributedStringIndex(rs, jax.make_mesh((1,), ("data",)))
    port = T.DistributedStringIndex(ts, config=CPU)
    ends = np.cumsum(ts.sorted_lens)
    starts = [keys[min(max(e + d, 0), len(keys) - 1)] for e in ends for d in (-6, -3, -1, 0)]
    starts += [b"", keys[0], keys[-1], keys[-2], keys[-1] + b"~", b"\x7f\x7f"]
    starts += [keys[i][: 1 + i % 4] for i in range(0, len(keys), 97)]
    kv = dict(zip(keys, vals.tolist()))
    naive_differs = 0
    for window in (1, 7, 16):
        want = ref.scan_entries(starts, window)
        assert port.scan_entries(starts, window) == want
        for s, w in zip(starts, want):
            naive_differs += w != [(k, kv[k]) for k in keys if k >= s][:window]
    # a shard shorter than the longest scans its padded order, as the
    # reference does (ROADMAP Queue 3): windows then differ from sorted order
    padded = len(set(ts.sorted_lens)) > 1
    assert (naive_differs > 0) == padded
    assert padded == (n == 3)  # this corpus splits into 499, 498, 499 keys at n = 3


def test_execute_equals_reference_on_one_shard(corpus, built):
    keys, vals = corpus
    rs, ts = built[1]
    ref = R.DistributedStringIndex(rs, jax.make_mesh((1,), ("data",)), per_dest_capacity=64)
    port = T.DistributedStringIndex(ts, per_dest_capacity=64, config=CPU)
    ops = [("get", keys[3]), ("get", b"missing"), ("get", b""), ("get", b"w" * (ts.width + 1)),
           ("put", b"x"), ("delete", keys[4]), ("scan", (keys[10], None)), ("scan", (b"", 3)),
           ("get", keys[-1]), ("scan", (keys[-1] + b"~", 5))]
    rmap = {"get": RGet, "put": lambda k: RPut(k, 1), "delete": RDelete,
            "scan": lambda a: RScan(*a)}
    tmap = {"get": GetRequest, "put": lambda k: PutRequest(k, 1), "delete": DeleteRequest,
            "scan": lambda a: ScanRequest(*a)}
    want = ref.execute([rmap[o](a) for o, a in ops])
    got = port.execute([tmap[o](a) for o, a in ops])
    assert [(int(r.status), r.value, r.entries) for r in want.results] == \
        [(int(r.status), r.value, r.entries) for r in got.results]
    assert (want.n_get, want.n_put, want.n_scan, want.n_delete) == \
        (got.n_get, got.n_put, got.n_scan, got.n_delete)
    assert got.statuses()[:6] == [Status.OK, Status.NOT_FOUND, Status.NOT_FOUND,
                                  Status.REJECTED_OVER_WIDTH, Status.UNSUPPORTED,
                                  Status.UNSUPPORTED]
    # more rows than the capacity holds: every get overflows, as data
    over = port.execute([GetRequest(k) for k in keys[:65]] + [ScanRequest(keys[0], 2)])
    assert over.statuses() == [Status.ROUTING_OVERFLOW] * 65 + [Status.OK]
    assert over.results[-1].entries == tuple(zip(keys[:2], vals[:2].tolist()))


def test_defaults_to_the_card(corpus, built, monkeypatch):
    keys, vals = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        T.DistributedStringIndex(built[1][1])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        T.DistributedStringIndex.build(keys[:50], vals[:50], 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_process_group_form_equals_in_process(corpus, built, tmp_path):
    """Four gloo CPU processes, rank r holding shard r and sending block r
    of the batch, give the in-process form's answers on the concatenated
    batch: lookups, each sender's overflow count, the overflow error and
    statuses, scan windows and a mixed ``execute``."""
    import torch.multiprocessing as mp

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_gloo import rank_main

    keys, vals = corpus
    _, ts = built[4]
    rng = np.random.default_rng(17)
    q = _queries(keys, ts, rng, 4 * 40)
    starts = [keys[i][: 1 + i % 5] for i in rng.integers(0, len(keys), 4 * 6)]
    blocks = {"keys": [q[40 * r: 40 * (r + 1)] for r in range(4)],
              "starts": [starts[6 * r: 6 * (r + 1)] for r in range(4)]}
    # each rank's gets are its block, so the in-process execute of the
    # concatenated batch gives every sender the same rows
    blocks["batch"] = batch = [[GetRequest(k) for k in blocks["keys"][r]] + [PutRequest(b"p", 1)]
                               + [ScanRequest(s, 1 + r) for s in starts[r::4]] for r in range(4)]
    cap, small = 64, 6
    sidx_path, blocks_path = tmp_path / "sidx.pt", tmp_path / "blocks.pkl"
    torch.save(ts, sidx_path)
    with open(blocks_path, "wb") as f:
        pickle.dump(blocks, f)
    ctx = mp.start_processes(rank_main, args=(4, _free_port(), str(sidx_path), str(blocks_path),
                                              str(tmp_path), cap, small),
                             nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not finish in 240 s")
    ranks = []
    for r in range(4):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    here = T.DistributedStringIndex(ts, per_dest_capacity=cap, config=CPU)
    found, got = here.get_batch(q)
    np.testing.assert_array_equal(np.concatenate([x["found"] for x in ranks]), found)
    np.testing.assert_array_equal(np.concatenate([x["vals"] for x in ranks]), got)
    assert [x["held"] for x in ranks] == [[0], [1], [2], [3]]
    assert sum((x["windows"] for x in ranks), []) == here.scan_entries(starts, 5)
    flat = [r for b in batch for r in b]
    want = here.execute(flat).results
    assert sum((x["results"] for x in ranks), []) == want
    tight = T.DistributedStringIndex(ts, per_dest_capacity=small, config=CPU)
    qb, ql = (torch.from_numpy(a) for a in pad_queries(q, ts.width))
    t_found, t_lo, t_hi, t_over = (t.numpy() for t in tight._fn(qb, ql))
    for i, name_want in enumerate((t_found, t_lo, t_hi)):
        np.testing.assert_array_equal(np.concatenate([x["route"][i] for x in ranks]), name_want)
    np.testing.assert_array_equal(np.concatenate([x["route"][3] for x in ranks]), t_over)
    assert t_over.sum() > 0
    assert all(x["raised"] == f"{t_over.sum()} queries exceeded per_dest_capacity={small} on "
               "their owner shard; raise the capacity or split the batch" for x in ranks)
    for x in ranks:
        assert [r.status for r in x["tight_results"][:40]] == [Status.ROUTING_OVERFLOW] * 40
        assert x["tight_results"][40:] == x["results"][40:]
        assert [len(a) for a in x["empty"]] == [0, 0]
