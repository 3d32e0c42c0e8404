"""The h-pointer probe of compact leaves (CNODEs), on the CPU: K4's
one-thread probe and its bit walk (``csrc/lits_walk.cuh``) against loops
written from the reference, built with g++; and an index whose compact
leaves hold equal 16-bit codes, looked up by stored keys behind a false
match and by never-stored keys that collide with one stored key or with
several, against the JAX package bit for bit."""
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import cnode_probe_stats, collision_keys
from repro.core import tensor_index as r_ti
from repro.index import IndexConfig as RConfig, StringIndex as RIndex
from repro.kernels import ops as r_ops
from repro.kernels.cnode_probe import cnode_probe_pallas
from repro_torch.core import tensor_index as t_ti
from repro_torch.core.builder import TAG_CNODE
from repro_torch.core.walk import item_payload, item_tag
from repro_torch.index import IndexConfig as TConfig, StringIndex as TIndex
from repro_torch.kernels import cnode_probe, traverse
from repro_torch.kernels.strops import hash16


def test_probe_mask_and_bit_walk_match_reference_loops(tmp_path):
    """``lits::probe_mask`` bit for bit and ``lits::probe_first`` (the first
    hash match, and K4's first key match with the keys compared in order)
    against loops written from ``repro/kernels/cnode_probe.py`` and
    ``repro/core/walk.py``: caps 1-70 across the 32-slot chunks, cnt <= 0
    and past the cap, frm < 0 and past the end, every base alignment and
    bases near the pool's end (``tests/csrc/probe_check.cpp``)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    root = Path(__file__).resolve().parents[1]
    exe = tmp_path / "probe_check"
    subprocess.run([cxx, "-std=c++17", "-O1", "-I", str(root / "tests/csrc/host"),
                    "-I", str(root / "src/repro_torch/kernels/csrc"),
                    str(root / "tests/csrc/probe_check.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    run = subprocess.run([str(exe), "100"], capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    probes, multi, bad = (int(x) for x in re.findall(r"\d+", run.stdout.splitlines()[-1]))
    assert bad == 0 and probes > 1_000_000 and multi > probes // 20


@pytest.fixture(scope="module", params=[0, 1])
def collision(request):
    """Both packages' indexes over :func:`collision_keys`, the queries (every
    stored key, then every never-stored one) and the port's plain walk."""
    keys, absent = collision_keys(request.param, 1500)
    vals = np.random.default_rng(request.param).integers(-(1 << 62), 1 << 62, len(keys))
    ri = RIndex.bulk_load(keys, vals, RConfig())
    ti = TIndex.bulk_load(keys, vals, TConfig(device="cpu"))
    queries = keys + absent
    qb, ql = t_ti.pad_queries(queries, ti.ti.width)
    trace = {}
    found, eid, _ = traverse.fused_search_plain(ti.ti, torch.from_numpy(qb),
                                                torch.from_numpy(ql), trace=trace)
    return {"keys": keys, "absent": absent, "ri": ri, "ti": ti, "queries": queries,
            "qb": qb, "ql": ql, "found": found, "eid": eid, "item": trace["item"]}


def test_collision_index_has_colliding_cnodes(collision):
    """The frozen pools hold compact leaves with equal codes, and the
    queries reach them: stored keys found behind a false match, never-stored
    keys that meet one hash match and ones that meet several."""
    ti = collision["ti"].ti
    base, cnt, codes = ti.cn_base.numpy(), ti.cn_cnt.numpy(), ti.ch_hash.numpy()
    repeated = sum(len(set(codes[b: b + c])) < c for b, c in zip(base, cnt))
    assert repeated > 0
    st = cnode_probe_stats(ti, torch.from_numpy(collision["qb"]),
                           torch.from_numpy(collision["ql"]), collision["item"],
                           collision["found"], collision["eid"])
    n = len(collision["keys"])
    matches = torch.zeros(len(collision["queries"]), dtype=torch.long)
    false = torch.zeros_like(matches)
    matches[st["at"]], false[st["at"]] = st["q_matches"], st["q_false"]
    found = collision["found"]
    assert bool(found[:n].all()) and not bool(found[n:].any())
    assert int((false[:n] > 0).sum()) > 0             # stored, behind a false match
    assert int((matches[n:] == 1).sum()) > 0          # never stored, one collision
    assert int((matches[n:] >= 2).sum()) > 0          # never stored, several
    assert st["false"] == int(false.sum())
    assert st["met"] == st["false"] + int(found[st["at"]].sum())


def test_collision_index_get_batch_equals_reference(collision):
    """``get_batch`` (found, values) and ``search_batch`` (found, eid,
    is_delta) of the port equal the reference's bit for bit."""
    ri, ti, queries = collision["ri"], collision["ti"], collision["queries"]
    for g, w in zip(ti.get_batch(queries), ri.get_batch(queries)):
        np.testing.assert_array_equal(g, np.asarray(w))
    qb, ql = collision["qb"], collision["ql"]
    got = t_ti.search_batch(ti.ti, torch.from_numpy(qb), torch.from_numpy(ql))
    want = r_ti.search_batch(ri.ti, jnp.asarray(qb), jnp.asarray(ql), backend="jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_collision_index_fused_search_equals_pallas(collision):
    """The port's fused search (the plain version of K4) equals the
    reference's Pallas fused kernel, run in interpret mode, in found, eid
    and levels."""
    qb, ql = collision["qb"], collision["ql"]
    got = traverse.fused_search(collision["ti"].ti, torch.from_numpy(qb), torch.from_numpy(ql))
    want = r_ops.fused_search(collision["ri"].ti, jnp.asarray(qb), jnp.asarray(ql),
                              interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_collision_tiles_cnode_probe_equals_pallas(collision):
    """K3's plain version on the (queries, cnode_cap) code tiles of the
    compact leaves the queries reach, with ``frm`` from 0 past the cap,
    equals the reference's Pallas probe (interpret mode)."""
    ti = collision["ti"].ti
    item = collision["item"]
    at = item_tag(item) == TAG_CNODE
    cid = item_payload(item[at]).long()
    K = ti.cnode_cap
    slots = (ti.cn_base[cid].long()[:, None] + torch.arange(K)[None, :])
    hashes = ti.ch_hash[slots.clamp(max=ti.ch_hash.shape[0] - 1)].numpy()
    rows = at.numpy()
    qh = hash16(torch.from_numpy(collision["qb"][rows]),
                torch.from_numpy(collision["ql"][rows])).numpy()
    cnt = ti.cn_cnt[cid].numpy()
    frm = np.random.default_rng(3).integers(0, K + 2, len(cnt)).astype(np.int32)
    frm[::2] = 0
    args = [np.ascontiguousarray(a, np.int32) for a in (hashes, qh, cnt, frm)]
    got = cnode_probe.cnode_probe(*[torch.from_numpy(a) for a in args]).numpy()
    want = np.asarray(cnode_probe_pallas(*[jnp.asarray(a) for a in args], interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (got[frm == 0] >= 0).sum() > 0 and (got == -1).sum() > 0
