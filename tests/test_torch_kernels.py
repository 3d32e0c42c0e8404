"""Each kernel module of the port against the JAX package, on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; these
must equal the reference's jnp functions and its Pallas kernels (run in
interpret mode) bit for bit.  The CUDA kernels are held against the same
plain versions on the card (test_torch_cuda.py).
"""
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (CDF_TABLES, edge_cdf_rows, exact_fma_f32, query_rows,
                          saturation_cases, tie_cases, tie_table)
from repro.core.hpt import get_cdf_jnp, positions_jnp
from repro.kernels import ref as r_ref
from repro.kernels.cnode_probe import cnode_probe_pallas
from repro.kernels.hpt_cdf import hpt_cdf_pallas
from repro.kernels.hpt_locate import hpt_locate_pallas
from repro_torch.core import hpt as t_hpt
from repro_torch.kernels import ops
from repro_torch.kernels.hpt_cdf import add_ftz, mul_ftz
from repro_torch.kernels.hpt_locate import fma_f32


@pytest.fixture(scope="module")
def rows():
    """20,000 query rows with start offsets and over-width rows."""
    return query_rows(np.random.default_rng(21), 20000, 40)


@pytest.mark.parametrize("max_steps", [64, 9])
def test_get_cdf_equals_reference(rows, max_steps):
    qb, ql, st, hpt = rows
    want = np.asarray(get_cdf_jnp(jnp.asarray(hpt.cdf_tab), jnp.asarray(hpt.prob_tab),
                                  jnp.asarray(qb), jnp.asarray(ql), jnp.asarray(st),
                                  max_steps=max_steps))
    pallas = np.asarray(hpt_cdf_pallas(jnp.asarray(qb), jnp.asarray(ql), jnp.asarray(st),
                                       jnp.asarray(hpt.cdf_tab), jnp.asarray(hpt.prob_tab),
                                       block_b=2048, max_steps=max_steps, interpret=True))
    got = t_hpt.get_cdf(torch.from_numpy(hpt.cdf_tab), torch.from_numpy(hpt.prob_tab),
                        torch.from_numpy(qb), torch.from_numpy(ql), torch.from_numpy(st),
                        max_steps=max_steps).numpy()
    assert (ql > qb.shape[1]).sum() > 1000  # over-width rows are in the batch
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_get_cdf_scalar_start(rows):
    qb, ql, _, hpt = rows
    want = np.asarray(get_cdf_jnp(jnp.asarray(hpt.cdf_tab), jnp.asarray(hpt.prob_tab),
                                  jnp.asarray(qb), jnp.asarray(ql), jnp.int32(3)))
    got = ops.hpt_cdf(torch.from_numpy(qb), torch.from_numpy(ql), 3,
                      cdf_tab=torch.from_numpy(hpt.cdf_tab),
                      prob_tab=torch.from_numpy(hpt.prob_tab)).numpy()
    np.testing.assert_array_equal(got, want)


def test_positions_equal_reference(rows):
    qb, ql, st, hpt = rows
    rng = np.random.default_rng(22)
    B = qb.shape[0]
    alpha = rng.uniform(1, 5e5, B).astype(np.float32)
    beta = rng.uniform(-4, 4, B).astype(np.float32)
    ns = rng.integers(8, 1 << 20, B).astype(np.int32)
    J = [jnp.asarray(x) for x in (hpt.cdf_tab, hpt.prob_tab, qb, ql, st, alpha, beta, ns)]
    want = np.asarray(positions_jnp(*J))
    pallas = np.asarray(hpt_locate_pallas(J[2], J[3], J[4], J[5], J[6], J[7], J[0], J[1],
                                          block_b=2048, interpret=True))
    got = t_hpt.positions(*[torch.from_numpy(x) for x in
                            (hpt.cdf_tab, hpt.prob_tab, qb, ql, st, alpha, beta, ns)]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_fma_emulation_exact_on_ties_and_random():
    c, a, b = tie_cases()
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(c), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, exact_fma_f32(a, c, b))
    naive = (a.astype(np.float64) * c + b).astype(np.float32)
    assert (naive != got).sum() >= 4  # the ties are real
    rng = np.random.default_rng(23)
    a = rng.uniform(-3e4, 3e4, 3000).astype(np.float32)
    c = rng.uniform(0, 1, 3000).astype(np.float32)
    b = rng.uniform(-1e3, 1e3, 3000).astype(np.float32)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(c), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, exact_fma_f32(a, c, b))


def test_fma_flushes_subnormals_as_xla():
    """``fma_f32`` flushes as XLA on the CPU does, bit for bit (sign of zero
    included): subnormal operands count as zeros, and a result is flushed
    when its 24-bit rounding with an unbounded exponent is below 2**-126,
    so an exact 2**-126 (1 - 2**-46) is kept and 2**-126 - 2**-150 is not;
    the same product from a subnormal operand is 0."""
    t = 2.0 ** -126
    rows = [(1 - 2 ** -23, t * (1 + 2 ** -23), 0.0), (1 - 2 ** -24, t, 0.0),
            (1 - 2 ** -24, t, -0.0), (-(1 - 2 ** -24), t, 0.0),
            (1.0, 2 * t, -2 * t * (1 - 2 ** -23)), (2.0 ** -130, 1.0, 0.5),
            (2.0 ** -133, np.inf, 0.0), (0.5, 2.0 ** -70, 2.0 ** -140),
            (2.0 ** -70, 2.0 ** -70, -0.0), (3.0, 0.25, 1.0), (1 + 2 ** -23, t * (1 - 2 ** -23), 0.0)]
    a, b, c = (np.array(col, np.float32) for col in zip(*rows))
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0] == t and got[1] == 0 and np.isnan(got[6]) and got[10] == 0


def test_mul_add_flush_subnormals_as_xla():
    """``mul_ftz`` and ``add_ftz`` equal XLA's float32 ``*`` and ``+`` on the
    CPU bit for bit: a raw subnormal operand counts as a zero of its sign
    (2**-140 * 2**100 is 0, 2**-127 + 2**-126 is 2**-126), and a product that
    rounds up to 2**-126 is kept while one that rounds below it is not."""
    t = 2.0 ** -126
    rows = [(2.0 ** -140, 2.0 ** 100), (t / 2, t), (-t / 2, 2.0 ** 30), (1 - 2 ** -24, t),
            (-(1 - 2 ** -24), t), (1 - 2 ** -23, t * (1 + 2 ** -23)), (2 * t, -2 * t * (1 - 2 ** -23)),
            (2.0 ** -133, np.inf), (2.0 ** -70, 2.0 ** -70), (-(2.0 ** -70), 2.0 ** -70), (3.0, 0.25)]
    a, b = (np.array(col, np.float32) for col in zip(*rows))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for want_fn, got in ((lambda x, y: x * y, mul_ftz(ta, tb)), (lambda x, y: x + y, add_ftz(ta, tb))):
        want = np.asarray(jax.jit(want_fn)(a, b))
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert mul_ftz(ta, tb)[0] == 0 and add_ftz(ta, tb)[1] == t


def test_positions_fma_ties_equal_reference():
    """Constructed float32 ties: the reference contracts alpha*cdf+beta to one
    FMA, in jnp and in its Pallas kernel; the port's plain locate matches."""
    cdf, alpha, beta = tie_cases()
    ct, pt, qb, ql = tie_table(cdf)
    ns = np.full(cdf.shape, 1 << 30, np.int32)
    st = np.zeros(cdf.shape, np.int32)
    J = [jnp.asarray(x) for x in (ct, pt, qb, ql, st, alpha, beta, ns)]
    want = np.asarray(positions_jnp(*J))
    pallas = np.asarray(hpt_locate_pallas(J[2], J[3], J[4], J[5], J[6], J[7], J[0], J[1],
                                          interpret=True))
    got = t_hpt.positions(*[torch.from_numpy(x) for x in (ct, pt, qb, ql, st, alpha, beta, ns)])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(want, np.floor(exact_fma_f32(alpha, cdf, beta)))


def test_positions_saturate_like_xla():
    """NaN and infinite fma results convert as XLA's saturating cast does."""
    cdf, alpha, beta = saturation_cases()
    ct, pt, qb, ql = tie_table(cdf)
    ns = np.full(4, 1000, np.int32)
    st = np.zeros(4, np.int32)
    want = np.asarray(positions_jnp(*[jnp.asarray(x) for x in (ct, pt, qb, ql, st, alpha, beta, ns)]))
    got = t_hpt.positions(*[torch.from_numpy(x) for x in (ct, pt, qb, ql, st, alpha, beta, ns)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("table", CDF_TABLES)
@pytest.mark.parametrize("L,max_steps", [(94, 64), (96, 64), (94, 5), (96, 5)])
def test_cdf_edge_rows_equal_reference(L, max_steps, table):
    """The plain GetCDF and locate, which the card's K2/K1 are held to
    (test_torch_cuda.py), equal the reference on the same edge rows: qlen 0,
    start >= qlen, qlen > start + 64, the over-width sentinel, a one-row
    uniform, a 256-column table and a 1024 x 128 table fed bytes above
    127, the FMA-tie and saturation cases."""
    arrays = edge_cdf_rows(L, table)  # qb, ql, st, cdf_tab, prob_tab, alpha, beta, nslots
    J = [jnp.asarray(x) for x in arrays]
    want_cdf = np.asarray(get_cdf_jnp(J[3], J[4], J[0], J[1], J[2], max_steps=max_steps))
    want_pos = np.asarray(positions_jnp(J[3], J[4], J[0], J[1], J[2], J[5], J[6], J[7],
                                        max_steps=max_steps))
    T = [torch.from_numpy(x) for x in arrays]
    got_cdf = t_hpt.get_cdf(T[3], T[4], T[0], T[1], T[2], max_steps=max_steps).numpy()
    got_pos = t_hpt.positions(T[3], T[4], T[0], T[1], T[2], T[5], T[6], T[7],
                              max_steps=max_steps).numpy()
    np.testing.assert_array_equal(got_cdf, want_cdf)
    np.testing.assert_array_equal(got_pos, want_pos)
    if table != "ties":
        assert (got_cdf == 0).any() and (got_cdf > 0).any()


@pytest.mark.parametrize("K", [8, 16, 32])
@pytest.mark.parametrize("B", [1, 65, 4096])
def test_cnode_probe_equals_reference(B, K):
    rng = np.random.default_rng(B * 31 + K)
    h = rng.integers(0, 1 << 16, size=(B, K)).astype(np.int32)
    qh = np.where(rng.random(B) < 0.6, h[np.arange(B), rng.integers(0, K, B)],
                  rng.integers(0, 1 << 16, B)).astype(np.int32)
    cnt = rng.integers(0, K + 1, B).astype(np.int32)
    frm = rng.integers(0, 3, B).astype(np.int32)
    J = [jnp.asarray(x) for x in (h, qh, cnt, frm)]
    pallas = np.asarray(cnode_probe_pallas(*J, interpret=True))
    ref = np.asarray(r_ref.cnode_probe_ref(*J))
    got = ops.cnode_probe(*[torch.from_numpy(x) for x in (h, qh, cnt, frm)]).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref)
    got0 = ops.cnode_probe(*[torch.from_numpy(x) for x in (h, qh, cnt)]).numpy()
    np.testing.assert_array_equal(got0, np.asarray(r_ref.cnode_probe_ref(*J[:3])))


def test_word_primitives_match_byte_loops(tmp_path):
    """K4's and K6's row staging, word-wide compares, hash and GetCDF
    (``csrc/lits_words.cuh``) equal byte loops written from the reference's
    semantics, at every key alignment, with pools that cut keys' chunks and
    rows with bytes past their length: ``tests/csrc/words_check.cpp``,
    built with the host's C++ compiler against stand-ins for the CUDA
    intrinsics (``tests/csrc/host/cuda_runtime.h``)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    root = Path(__file__).resolve().parents[1]
    exe = tmp_path / "words_check"
    subprocess.run([cxx, "-std=c++17", "-O1", "-I", str(root / "tests/csrc/host"),
                    "-I", str(root / "src/repro_torch/kernels/csrc"),
                    str(root / "tests/csrc/words_check.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    run = subprocess.run([str(exe), "3000"], capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    cases, word_path, bad = (int(x) for x in re.findall(r"\d+", run.stdout.splitlines()[-1]))
    assert bad == 0 and cases > 300_000 and word_path > cases // 3


def _threads(n, fn):
    """Run ``fn(i)`` in ``n`` threads released together, with the switch
    interval shortened so that they interleave; each must end."""
    import sys
    import threading

    barrier = threading.Barrier(n, timeout=60)
    out = [None] * n

    def run(i):
        barrier.wait()
        out[i] = fn(i)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    return out


def test_derived_table_made_once_across_threads():
    """Eight threads asking at once for the table of one set of sources get
    one table, made once."""
    import time

    from repro_torch.kernels import _build

    srcs = (torch.arange(5000, dtype=torch.float32), torch.ones(5000))
    made = []

    def make(a, b):
        made.append(1)
        time.sleep(0.01)  # a slow make: the other threads arrive meanwhile
        return torch.stack([a, b], dim=-1).contiguous()

    tables = _threads(8, lambda i: _build.derived("thread_test", srcs, make))
    assert len(made) == 1 and all(t is tables[0] for t in tables)


def test_launch_counts_exact_across_threads():
    """Counts added from eight threads at once lose no launch."""
    from repro_torch.kernels import _build

    _build.reset_launches()
    try:
        _threads(8, lambda i: [_build.count_launch("scan") for _ in range(5000)])
        assert _build.LAUNCHES["scan"] == 8 * 5000
    finally:
        _build.reset_launches()
