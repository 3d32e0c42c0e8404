"""The port's host substrate against the JAX package: strings, GPKL, PMSS,
HPT construction, the synthetic generators and the string primitives on
tensors.  Same inputs, equal outputs."""
import importlib
import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hpt as r_hpt, pmss as r_pmss, strings as r_strings
from repro.data import synthetic as r_synth
from repro.kernels import strops as r_strops
from repro_torch.core import gpkl as t_gpkl, hpt as t_hpt, pmss as t_pmss, strings as t_strings
from repro_torch.data import synthetic as t_synth
from repro_torch.kernels import strops as t_strops

r_gpkl = importlib.import_module("repro.core.gpkl")  # repro.core re-exports a function of that name


def _keys(seed, n=400, lo=1, hi=30):
    return r_strings.random_strings(np.random.default_rng(seed), n, lo, hi)


def test_random_strings_same_stream():
    a = r_strings.random_strings(np.random.default_rng(7), 300, 2, 40)
    b = t_strings.random_strings(np.random.default_rng(7), 300, 2, 40)
    assert a == b


@pytest.mark.parametrize("seed", [0, 1])
def test_strings_functions_equal(seed):
    keys = _keys(seed) + [b"dup", b"dup", b"a", b"ab"]
    rs, ts = r_strings.StringSet.from_list(keys), t_strings.StringSet.from_list(keys)
    np.testing.assert_array_equal(rs.bytes, ts.bytes)
    ro, to = r_strings.sort_order(rs), t_strings.sort_order(ts)
    np.testing.assert_array_equal(ro, to)
    rss, tss = rs.take(ro), ts.take(to)
    np.testing.assert_array_equal(r_strings.dedup_sorted(rss), t_strings.dedup_sorted(tss))
    assert r_strings.group_cpl(rss) == t_strings.group_cpl(tss)
    np.testing.assert_array_equal(r_strings.pairwise_cpl(rss.bytes[:-1], rss.bytes[1:]),
                                  t_strings.pairwise_cpl(tss.bytes[:-1], tss.bytes[1:]))
    np.testing.assert_array_equal(r_strings.key_hash16(rs.bytes, rs.lens),
                                  t_strings.key_hash16(ts.bytes, ts.lens))
    np.testing.assert_array_equal(r_strings.compare_to(rs, b"m"), t_strings.compare_to(ts, b"m"))
    np.testing.assert_array_equal(r_strings.pack_prefix_u64(rs.bytes),
                                  t_strings.pack_prefix_u64(ts.bytes))
    np.testing.assert_array_equal(r_strings.strip_prefix(rs, 3).bytes,
                                  t_strings.strip_prefix(ts, 3).bytes)
    assert rs.pad_to(64).tolist() == ts.pad_to(64).tolist() == keys


def test_gpkl_equal():
    ss = r_strings.StringSet.from_list(_keys(3, 500))
    srt = ss.take(r_strings.sort_order(ss))
    np.testing.assert_array_equal(r_gpkl.pkl(srt), t_gpkl.pkl(srt))
    assert r_gpkl.gpkl(srt) == t_gpkl.gpkl(srt)
    assert r_gpkl.local_gpkl(srt, 32) == t_gpkl.local_gpkl(srt, 32)


def test_pmss_decisions_equal():
    rp, tp = r_pmss.PMSS(tables=r_pmss._seed_tables()), t_pmss.PMSS()
    assert rp.tables == tp.tables
    for g in np.linspace(1.0, 25.0, 37):
        for n in (2, 17, 100, 5000, 1 << 20, 1 << 27):
            assert rp.latency("lit", g, n) == tp.latency("lit", g, n)
            assert rp.decide(g, n) == tp.decide(g, n)


@pytest.mark.parametrize("rows,smoothing", [(256, 0.5), (1024, 0.0)])
def test_build_hpt_equal(rows, smoothing):
    ss = r_strings.StringSet.from_list(_keys(4, 800, 1, 70))
    a = r_hpt.build_hpt(ss, rows=rows, cols=128, smoothing=smoothing)
    b = t_hpt.build_hpt(ss, rows=rows, cols=128, smoothing=smoothing)
    np.testing.assert_array_equal(a.cdf_tab, b.cdf_tab)
    np.testing.assert_array_equal(a.prob_tab, b.prob_tab)
    u, v = r_hpt.uniform_hpt(4, 128), t_hpt.uniform_hpt(4, 128)
    np.testing.assert_array_equal(u.cdf_tab, v.cdf_tab)


@pytest.mark.parametrize("name", ["email", "url"])
def test_generators_same_keys(name):
    a = r_synth.DATASETS[name](np.random.default_rng(9), 700)
    b = t_synth.DATASETS[name](np.random.default_rng(9), 700)
    assert a == b


def test_load_is_sorted_and_seeded_by_name():
    keys = t_synth.load("url", 500, seed=3)
    rng = np.random.default_rng((zlib.crc32(b"url") & 0xFFFF, 3))
    assert keys == sorted(r_synth.gen_url(rng, 500))
    assert keys == sorted(set(keys))


def test_load_same_in_every_process():
    """The reference seeds from hash(name), which changes with
    PYTHONHASHSEED; the port's load does not."""
    code = ("import hashlib, repro_torch.data.synthetic as s;"
            "print(hashlib.sha256(b'|'.join(s.load('email', 300, 1))).hexdigest())")
    outs = set()
    for hs in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hs,
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        outs.add(subprocess.run([sys.executable, "-c", code], env=env, check=True,
                                capture_output=True, text=True, timeout=120).stdout)
    assert len(outs) == 1


def _pool_case(seed, B=300, W=24):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 128, size=500).astype(np.uint8)
    # offsets near both ends exercise the clamped gather
    off = np.concatenate([rng.integers(0, 500, B - 20), np.full(10, 495), np.full(10, 499)])
    klen = rng.integers(0, W + 1, B).astype(np.int32)
    q = np.zeros((B, W), np.uint8)
    ql = rng.integers(0, W + 2, B).astype(np.int32)  # W + 1: the over-width sentinel
    for i in range(B):
        if i % 3 == 0:  # an exact copy of the pool key
            n = min(klen[i], max(0, 500 - off[i]))
            q[i, :n] = pool[off[i]: off[i] + n]
            ql[i] = klen[i] if n == klen[i] else ql[i]
        else:
            n = min(ql[i], W)
            q[i, :n] = rng.integers(1, 128, n)
    return pool, off.astype(np.int32), klen, q, ql


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_strops_equal(seed):
    pool, off, klen, q, ql = _pool_case(seed)
    J = [jnp.asarray(x) for x in (pool, off, klen, q, ql)]
    T = [torch.from_numpy(x) for x in (pool, off, klen, q, ql)]
    W = q.shape[1]
    np.testing.assert_array_equal(np.asarray(r_strops.gather_bytes(J[0], J[1], W)),
                                  t_strops.gather_bytes(T[0], T[1], W).numpy())
    np.testing.assert_array_equal(np.asarray(r_strops.str_eq(J[3], J[4], J[0], J[1], J[2])),
                                  t_strops.str_eq(T[3], T[4], T[0], T[1], T[2]).numpy())
    assert t_strops.str_eq(T[3], T[4], T[0], T[1], T[2]).any()
    np.testing.assert_array_equal(np.asarray(r_strops.str_cmp_prefix(J[3], J[0], J[1], J[2])),
                                  t_strops.str_cmp_prefix(T[3], T[0], T[1], T[2]).numpy())
    np.testing.assert_array_equal(np.asarray(r_strops.hash16(J[3], J[4])),
                                  t_strops.hash16(T[3], T[4]).numpy())
    np.testing.assert_array_equal(np.asarray(r_strops.hash32(J[3], J[4])).astype(np.int64),
                                  t_strops.hash32(T[3], T[4]).numpy())
