"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; without a card each skips
with its reason.  Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.  Equality
is exact throughout: a kernel that is off by one float32 ulp places a key
in another slot.
"""
import numpy as np
import pytest
import torch

from _torch_cases import query_rows, saturation_cases, tie_cases, tie_table
from repro_torch.core.strings import StringSet
from repro_torch.core.builder import LITSBuilder
from repro_torch.core.tensor_index import DATA_FIELDS, freeze, pad_queries
from repro_torch.data import synthetic
from repro_torch.kernels import _build, cnode_probe, hpt_cdf, hpt_locate, traverse

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


def test_cuda_wrappers_reject_bad_input(cuda):
    qb, ql, st, hpt = query_rows(np.random.default_rng(4), 64, 16)
    qb, ql, st, ct, pt = _dev(cuda, qb, ql, st, hpt.cdf_tab, hpt.prob_tab)
    with pytest.raises(ValueError, match="dtype"):
        hpt_cdf.hpt_cdf_cuda(qb, ql.long(), st, ct, pt)
    with pytest.raises(ValueError, match="on cpu"):
        hpt_cdf.hpt_cdf_cuda(qb, ql, st.cpu(), ct, pt)
    with pytest.raises(ValueError, match="contiguous"):
        hpt_cdf.hpt_cdf_cuda(qb.t().contiguous().t(), ql, st, ct, pt)


def test_cuda_cnode_probe_matches_plain(cuda):
    rng = np.random.default_rng(3)
    B, K = 65536, 16
    h = rng.integers(0, 1 << 16, size=(B, K)).astype(np.int32)
    qh = np.where(rng.random(B) < 0.6, h[np.arange(B), rng.integers(0, K, B)],
                  rng.integers(0, 1 << 16, B)).astype(np.int32)
    cnt = rng.integers(0, K + 1, B).astype(np.int32)
    frm = rng.integers(0, 3, B).astype(np.int32)
    args = _dev(cuda, h, qh, cnt, frm)
    assert torch.equal(cnode_probe.cnode_probe_cuda(*args), cnode_probe.cnode_probe_plain(*args))


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
