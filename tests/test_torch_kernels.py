"""Each kernel module of the port against the JAX package, on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; these
must equal the reference's jnp functions and its Pallas kernels (run in
interpret mode) bit for bit.  The CUDA kernels are held against the same
plain versions on the card (test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import exact_fma_f32, query_rows, saturation_cases, tie_cases, tie_table
from repro.core.hpt import get_cdf_jnp, positions_jnp
from repro.kernels import ref as r_ref
from repro.kernels.cnode_probe import cnode_probe_pallas
from repro.kernels.hpt_cdf import hpt_cdf_pallas
from repro.kernels.hpt_locate import hpt_locate_pallas
from repro_torch.core import hpt as t_hpt
from repro_torch.kernels import ops
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
