"""The port's LM building blocks (``repro_torch.models.layers`` and
``repro_torch.models.ssm``) against the JAX reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages (bf16
inputs are rounded from the same float32 arrays by both, bit for bit).  The
reference functions run eagerly, op by op, as the port does.

Tolerances: int8 quantisation, ``cast_tree`` and the routing tie rule are
exact, ``softplus`` within two float32 ulps.  The others are held to
``BF16_TOL`` (rtol = atol = 2^-7, one bf16 ulp at magnitude 1): the port
rounds each bf16 op as the reference's eager ops do, and what is left is
float32 summation order in the products, which can move a bf16 result by
one ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.models import ssm as RS
from repro_torch.configs.registry import ARCHS
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _pair(a: np.ndarray, dtype: str = "bfloat16"):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or BF16_TOL))


def _exact(got, want):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype or (g.dtype == np.float32 and w.dtype == np.float32)
    np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# int8 KV, cast_tree, norms, rope
# ---------------------------------------------------------------------------

def test_quantize_kv_bit_exact():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)) * rng.uniform(0.01, 8, (2, 5, 3, 1))
    x[0, 0, 0] = 0.0                        # an all-zero vector: the 1e-8 scale floor
    x[1, 2, 1, :4] = [2.5, -2.5, 0.5, -0.5]  # ties: round half to even
    jx, tx = _pair(x)
    rq, rs = RL.quantize_kv(jx)
    tq, ts = TL.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(), np.asarray(rs).view(np.int16))
    _exact(TL.dequantize_kv(tq, ts), RL.dequantize_kv(rq, rs))


def test_cast_tree_bit_exact():
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((4, 8)).astype(np.float32),
         "i": np.arange(6, dtype=np.int32)}
    ref = RL.cast_tree({k: jnp.asarray(v) for k, v in p.items()})
    got = TL.cast_tree({k: torch.from_numpy(v) for k, v in p.items()})
    assert got["w"].dtype == torch.bfloat16 and got["i"].dtype == torch.int32
    for k in p:
        _exact(got[k], ref[k])


def test_rms_norm():
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((2, 7, 64)) * 3)
    js, ts = _pair(rng.standard_normal(64) * 0.1, "float32")
    _close(TL.rms_norm(tx, ts, 1e-5), RL.rms_norm(jx, js, 1e-5))


@pytest.mark.parametrize("variant", ["full", "partial", "none"])
@pytest.mark.parametrize("pos_shape", ["1d", "2d"])
def test_apply_rope(variant, pos_shape):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.standard_normal((2, 9, 4, 16)))
    pos = np.arange(9, dtype=np.int32) + 3
    if pos_shape == "2d":
        pos = np.stack([pos, pos * 5 + 1000])
    _close(TL.apply_rope(tx, torch.from_numpy(pos), variant),
           RL.apply_rope(jx, jnp.asarray(pos), variant))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # name: (H, KV, S, causal, window, q_offset, q_chunk, kv_chunk)
    "causal_gqa_chunks": (4, 2, 32, True, 0, 0, 8, 16),
    "bidirectional_mha": (4, 4, 24, False, 0, 0, 8, 8),
    "swa_window": (4, 2, 32, True, 8, 0, 8, 8),
    "swa_offset": (4, 1, 16, True, 6, 5, 4, 8),
    "uneven_chunk_halving": (2, 2, 12, True, 0, 0, 8, 5),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention(case):
    H, KV, S, causal, window, q_offset, qc, kc = FLASH_CASES[case]
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng.standard_normal((2, S, H, 16)))
    jk, tk = _pair(rng.standard_normal((2, S, KV, 16)))
    jv, tv = _pair(rng.standard_normal((2, S, KV, 16)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=qc, kv_chunk=kc)
    assert TL._chunk_sizes(S, S, qc, kc) == RL._chunk_sizes(S, S, qc, kc)
    _close(TL.flash_attention(tq, tk, tv, **kw), RL.flash_attention(jq, jk, jv, **kw))


@pytest.mark.parametrize("window,pos", [(0, 0), (0, 11), (8, 3), (8, 7), (8, 8), (8, 13)])
def test_decode_attention(window, pos):
    """Full cache (``window`` 0, 16 slots) and ring buffer (8 slots) with the
    new token before, at and past the window."""
    W = window or 16
    rng = np.random.default_rng(5)
    jq, tq = _pair(rng.standard_normal((3, 4, 16)))
    jk, tk = _pair(rng.standard_normal((3, W, 2, 16)))
    jv, tv = _pair(rng.standard_normal((3, W, 2, 16)))
    _close(TL.decode_attention(tq, tk, tv, pos, window=window),
           RL.decode_attention(jq, jk, jv, jnp.int32(pos), window=window))


# ---------------------------------------------------------------------------
# MLPs and MoE
# ---------------------------------------------------------------------------

def _mats(rng, shapes):
    out_j, out_t = {}, {}
    for name, shape in shapes.items():
        fan_in = shape[-2]
        out_j[name], out_t[name] = _pair(rng.standard_normal(shape) / np.sqrt(fan_in))
    return out_j, out_t


@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp_apply(act):
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.standard_normal((2, 6, 64)) * 2)
    shapes = {"wi0": (64, 128), "wo": (128, 64)}
    if act == "swiglu":
        shapes["wi1"] = (64, 128)
    jp, tp = _mats(rng, shapes)
    _close(TL.mlp_apply(tx, tp, act), RL.mlp_apply(jx, jp, act))


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to ``approximate=True``; the exact erf form
    (torch's default) differs from it by far more than a bf16 ulp here."""
    x = np.linspace(-4, 4, 401).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = TL._act(torch.from_numpy(x), "gelu", torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_top_k_ties_take_the_lower_index():
    g = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                  [0.3, 0.2, 0.3, 0.2]], np.float32)
    for k in (1, 2, 3):
        rv, ri = jax.lax.top_k(jnp.asarray(g), k)
        tv, ti = TL._top_k(torch.from_numpy(g), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("top_k,act", [(1, "swiglu"), (2, "swiglu"), (2, "sq_relu")])
@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
def test_moe_apply(top_k, act, capacity_factor):
    """Top-1 and top-2 routing over 4 experts; capacity factor 0.5 forces
    drops (C = max(int(0.5·T·k/E), 4) rows an expert for T = 32 tokens),
    8.0 drops nothing."""
    rng = np.random.default_rng(7 + top_k)
    E, d, f = 4, 64, 32
    jx, tx = _pair(rng.standard_normal((2, 16, d)))
    shapes = {"router": (d, E), "wi0": (E, d, f), "wo": (E, f, d)}
    if act == "swiglu":
        shapes["wi1"] = (E, d, f)
    jp, tp = _mats(rng, shapes)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, act=act)
    _close(TL.moe_apply(tx, tp, **kw), RL.moe_apply(jx, jp, **kw))


def test_moe_capacity_drops_rows():
    """At capacity factor 0.5 some token's output is zero (all its expert
    rows dropped), as in the reference; at 8.0 none is."""
    rng = np.random.default_rng(8)
    E, d, f = 4, 64, 32
    jx, tx = _pair(rng.standard_normal((1, 32, d)))
    jp, tp = _mats(rng, {"router": (d, E), "wi0": (E, d, f), "wi1": (E, d, f),
                         "wo": (E, f, d)})
    for cf, dropped in ((0.5, True), (8.0, False)):
        kw = dict(top_k=1, capacity_factor=cf, act="swiglu")
        got, want = TL.moe_apply(tx, tp, **kw), RL.moe_apply(jx, jp, **kw)
        zero_rows = (_np(got)[0] == 0).all(-1)
        np.testing.assert_array_equal(zero_rows, (_np(want)[0] == 0).all(-1))
        assert zero_rows.any() == dropped


# ---------------------------------------------------------------------------
# mamba
# ---------------------------------------------------------------------------

def _mamba_params(rng, cfg):
    d, di, N, dtr, ck = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    shapes = {"in_proj": (d, 2 * di), "conv_w": (ck, di), "x_proj": (di, dtr + 2 * N),
              "dt_proj": (dtr, di), "out_proj": (di, d)}
    jp, tp = _mats(rng, shapes)
    for name, val in (("conv_b", rng.standard_normal(di) * 0.1),
                      ("dt_bias", np.full(di, -4.0) + rng.standard_normal(di)),
                      ("A_log", np.log(np.arange(1, N + 1))[None].repeat(di, 0)),
                      ("D", np.ones(di))):
        jp[name], tp[name] = _pair(val)
    return jp, tp


def test_softplus_is_logaddexp():
    """``logaddexp(x, 0)`` on both sides: within two float32 ulps, and past 20
    not the identity switch of ``F.softplus`` (which agrees there only
    because float32 rounds log1p(exp(-x)) away).  XLA on the CPU flushes
    the subnormal result at -100 to 0, torch keeps it (atol: the smallest
    normal float32)."""
    x = np.array([-100, -20, -1, 0, 1e-3, 1, 15, 20, 25, 88, 1e4], np.float32)
    np.testing.assert_allclose(TS._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=2 ** -22, atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("carried", [False, True])
def test_mamba_forward(carried):
    """Full sequence, from zero state or from a carried ``h0``/``conv_state``,
    with the state it leaves.  The reference's time loop is a ``lax.scan``,
    compiled even here, and XLA keeps the bf16 product dt·u in float32 inside
    it; the port rounds it to bf16 as the reference's source says.  So the
    float32 state agrees to bf16 rounding (``BF16_TOL``), not to float32's."""
    cfg = ARCHS["falcon-mamba-7b"].reduced()
    rng = np.random.default_rng(9)
    jp, tp = _mamba_params(rng, cfg)
    jx, tx = _pair(rng.standard_normal((2, 10, cfg.d_model)))
    kw_j, kw_t = {}, {}
    if carried:
        jh, th = _pair(rng.standard_normal((2, cfg.d_inner, cfg.ssm_state)), "float32")
        jc, tc = _pair(rng.standard_normal((2, cfg.ssm_conv - 1, cfg.d_inner)))
        kw_j, kw_t = dict(h0=jh, conv_state=jc), dict(h0=th, conv_state=tc)
    ro, rh, rc = RS.mamba_forward(jx, jp, cfg, return_state=True, **kw_j)
    to, th, tc = TS.mamba_forward(tx, tp, cfg, return_state=True, **kw_t)
    _close(to, ro)
    _close(th, rh)
    _exact(tc, rc)


def test_mamba_decode_step():
    cfg = ARCHS["hymba-1.5b"].reduced()
    rng = np.random.default_rng(10)
    jp, tp = _mamba_params(rng, cfg)
    jx, tx = _pair(rng.standard_normal((3, cfg.d_model)))
    jh, th = _pair(rng.standard_normal((3, cfg.d_inner, cfg.ssm_state)), "float32")
    jc, tc = _pair(rng.standard_normal((3, cfg.ssm_conv - 1, cfg.d_inner)))
    ro, rh, rc = RS.mamba_decode_step(jx, jp, cfg, jh, jc)
    to, th2, tc2 = TS.mamba_decode_step(tx, tp, cfg, th, tc)
    _close(to, ro)
    _close(th2, rh, rtol=1e-5, atol=1e-5)
    _exact(tc2, rc)
