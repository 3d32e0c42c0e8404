"""The port's configs and ``LMModel`` against the JAX reference's, on the CPU.

* Config arithmetic (every derived property, parameter counts, the skip
  matrix, cache and input specs) for the 10 published configs: exact.
* Every reduced arch with the reference's parameters carried across
  (``lm_params_from_reference``): ``forward``, ``prefill`` (cache and
  logits) and ``decode_step`` from the reference's own cache
  (``lm_cache_from_reference``), against the reference run op by op
  (``jax.disable_jit``), which rounds every bf16 op as the port does:
  logits within ``LOGIT_TOL`` (the reference's own prefill tolerance,
  rtol = atol = 2e-2), bf16 caches within one bf16 ulp (rtol = atol = 2^-7).
* The non-MoE archs against the reference's compiled (``jax.jit``)
  functions, within rtol = atol = 6e-2 (the reference's own decode
  tolerance).  Compiled, XLA keeps bf16 intermediates in float32 inside its
  fusions (excess precision), which moves the logits of these 2-layer
  models by up to ≈0.05 against any op-by-op run, the reference's own
  included.  For an MoE arch such a move can flip a near-tied top-k routing
  choice (a top-2/top-3 gate margin of 0.001 occurs at these sizes), after
  which the token's output is another expert's; the MoE archs are held op
  by op above, where the routing agrees.
* The reference's own prefill/decode consistency and int8-KV tests, on the
  port.
* Decode against forward at depth: the reduced deepseek at 2 and 30
  layers in both packages, op by op; the reference's own gap grows with
  depth as the port's does, and both stay under ``LM_DEPTH_TOL``, the bound
  ``chip_smoke.py`` puts on the full-width model's 30 layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from _torch_cases import LM_DEPTH_TOL
from repro.models import LMModel as RModel
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_cache_from_reference, lm_params_from_reference
from repro_torch.models import LMModel

ARCH_NAMES = sorted(treg.ARCHS)
DECODERS = [a for a in ARCH_NAMES if treg.ARCHS[a].decoder]
LOGIT_TOL = dict(rtol=2e-2, atol=2e-2)
CACHE_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
COMPILED_TOL = dict(rtol=6e-2, atol=6e-2)

_TORCH_DTYPE = {torch.bfloat16: "bfloat16", torch.int8: "int8", torch.float32: "float32",
                torch.int32: "int32"}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _tree_np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), t)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

PROPS = ("hd", "n_heads_padded", "n_kv_padded", "vocab_padded", "d_inner", "dt_rank",
         "has_attn", "has_mamba", "has_moe", "sub_quadratic")


def _specs_np(specs):
    """{name: (shape, dtype name)} of a (nested) spec dict of either package."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _specs_np(v).items()})
        elif isinstance(v, torch.Tensor):
            assert v.device.type == "meta"
            out[k] = (tuple(v.shape), _TORCH_DTYPE[v.dtype])
        else:
            out[k] = (tuple(v.shape), np.dtype(v.dtype).name)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_config_matches_reference(arch):
    t, r = treg.get_arch(arch), rreg.get_arch(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    for cfg_t, cfg_r in ((t, r), (t.reduced(), r.reduced())):
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_r)
        for p in PROPS:
            assert getattr(cfg_t, p) == getattr(cfg_r, p), p
        assert cfg_t.param_count() == cfg_r.param_count()
        assert cfg_t.param_count(padded=True) == cfg_r.param_count(padded=True)
        assert cfg_t.active_param_count() == cfg_r.active_param_count()
        for batch, seq in ((2, 64), (128, 32768)):
            assert _specs_np(tbase.cache_specs(cfg_t, batch, seq)) == \
                _specs_np(rbase.cache_specs(cfg_r, batch, seq))
    for name in tbase.SHAPES:
        st, sr = tbase.SHAPES[name], rbase.SHAPES[name]
        assert dataclasses.asdict(st) == dataclasses.asdict(sr)
        assert tbase.cell_skip_reason(t, st) == rbase.cell_skip_reason(r, sr)
        assert _specs_np(tbase.input_specs(t, st)) == _specs_np(rbase.input_specs(r, sr))
    assert [s.name for s in tbase.runnable_cells(t)] == [s.name for s in rbase.runnable_cells(r)]


def test_registry_matches_reference():
    assert list(treg.ARCHS) == list(rreg.ARCHS)
    cells_t = [(c.name, s.name, why) for c, s, why in treg.all_cells()]
    cells_r = [(c.name, s.name, why) for c, s, why in rreg.all_cells()]
    assert cells_t == cells_r
    assert sum(why is None for *_, why in cells_t) == 32
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch("no-such-arch")


def test_deepseek_full_width_is_unpadded():
    """The full-width arch chip_smoke.py serves needs no TP padding: its
    numbers are the published model's."""
    c = treg.get_arch("deepseek-7b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd, c.d_ff, c.vocab) == \
        (30, 4096, 32, 32, 128, 11008, 102400)
    assert (c.n_heads_padded, c.n_kv_padded, c.vocab_padded) == (32, 32, 102400)
    assert c.param_count() == c.param_count(padded=True) == 6_910_365_696


# ---------------------------------------------------------------------------
# the parameter table and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_table_matches_reference(arch):
    r = treg.ARCHS[arch].reduced()
    m = LMModel(r, device="cpu")
    ref = RModel(rreg.ARCHS[arch].reduced()).abstract_params()
    want = {k: tuple(v.shape) for k, v in ref.items() if k != "blocks"}
    want.update({"blocks." + k: tuple(v.shape) for k, v in ref["blocks"].items()})
    assert {k: tuple(v.shape) for k, v in m.params().items()} == want
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert sum(p.numel() for p in m.parameters()) == sum(int(np.prod(s)) for s in want.values())


def test_init_follows_the_reference_initialisers():
    """Same initialisers as the reference (zeros, ones, dt_bias, a_log exactly;
    normal·1/√fan_in in distribution), and the same generator seed gives the
    same parameters."""
    r = treg.ARCHS["hymba-1.5b"].reduced()
    a = LMModel(r, device="cpu", generator=torch.Generator().manual_seed(3))
    b = LMModel(r, device="cpu", generator=torch.Generator().manual_seed(3))
    ref = _tree_np(RModel(rreg.ARCHS["hymba-1.5b"].reduced()).init(jax.random.PRNGKey(0)))
    flat_ref = {k: v for k, v in ref.items() if k != "blocks"}
    flat_ref.update({"blocks." + k: v for k, v in ref["blocks"].items()})
    defs = {**a.top_defs(), **{"blocks." + k: v for k, v in a.layer_defs().items()}}
    for name, p in a.params().items():
        assert torch.equal(p, b.params()[name])
        if defs[name].init == "normal":
            fan_in = defs[name].shape[-2] if len(defs[name].shape) >= 2 else defs[name].shape[-1]
            std = float(p.detach().std())
            assert abs(std * np.sqrt(fan_in) - 1) < 0.1, name
        else:
            np.testing.assert_array_equal(_np(p), flat_ref[name], err_msg=name)


# ---------------------------------------------------------------------------
# every reduced arch against the reference, op by op
# ---------------------------------------------------------------------------

def _carried(arch, kv_cache_dtype="bf16"):
    """The reduced arch's reference model and parameters, and the port's
    model holding the same parameters."""
    r_cfg = dataclasses.replace(rreg.ARCHS[arch].reduced(), kv_cache_dtype=kv_cache_dtype)
    t_cfg = dataclasses.replace(treg.ARCHS[arch].reduced(), kv_cache_dtype=kv_cache_dtype)
    rm = RModel(r_cfg)
    params = rm.init(jax.random.PRNGKey(1))
    m = lm_params_from_reference(_tree_np(params), LMModel(t_cfg, device="cpu"))
    return rm, params, m


def _batches(cfg, rng, B, S):
    if cfg.frontend == "frame":
        fr = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
        return ({"frames": jnp.asarray(fr, jnp.bfloat16)},
                {"frames": torch.from_numpy(fr).to(torch.bfloat16)})
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    rb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.frontend == "patch":
        pt = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        rb["patches"] = jnp.asarray(pt, jnp.bfloat16)
        tb["patches"] = torch.from_numpy(pt).to(torch.bfloat16)
    return rb, tb


def _close_caches(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert _TORCH_DTYPE[got[k].dtype] == w.dtype.name, k
        assert tuple(got[k].shape) == w.shape, k
        if w.dtype.name == "int8":
            # one int8 step where a bf16 rounding moved the scaled value
            np.testing.assert_allclose(_np(got[k]), w, atol=1, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(_np(got[k]), _np(w), err_msg=k, **CACHE_TOL)


ARCH_CASES = [(a, "bf16") for a in ARCH_NAMES] + [("deepseek-7b", "int8")]


@pytest.mark.parametrize("arch,kv", ARCH_CASES, ids=[f"{a}-{kv}" for a, kv in ARCH_CASES])
def test_reduced_arch_matches_reference_op_by_op(arch, kv):
    rm, params, m = _carried(arch, kv)
    cfg = m.cfg
    B, S = 2, 12
    P = cfg.n_frontend_tokens if cfg.frontend == "patch" else 0   # patch positions
    rb, tb = _batches(cfg, np.random.default_rng(0), B, S)
    with jax.disable_jit():
        want = rm.forward(params, rb, remat=False)
        if cfg.decoder:
            rc, rl = rm.prefill(params, rb, max_len=P + S + 4)
            nxt = jnp.argmax(rl[:, : cfg.vocab], -1).astype(jnp.int32)
            rc2, rdl = rm.decode_step(params, rc, nxt, jnp.int32(P + S))
    with torch.no_grad():
        got = m.forward(tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, cfg.vocab_padded)
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    if not cfg.decoder:
        return
    tc, tl = m.prefill(tb, max_len=P + S + 4)
    np.testing.assert_allclose(_np(tl), _np(rl), **LOGIT_TOL)
    _close_caches(tc, _tree_np(rc))
    # decode_step alone, from the reference's own cache
    cache = lm_cache_from_reference(_tree_np(rc), "cpu")
    tc2, tdl = m.decode_step(cache, torch.from_numpy(np.array(nxt)), P + S)
    assert tc2 is cache
    np.testing.assert_allclose(_np(tdl), _np(rdl), **LOGIT_TOL)
    _close_caches(tc2, _tree_np(rc2))


@pytest.mark.parametrize("S", [5, 8, 13])
def test_swa_ring_buffer_matches_reference(S):
    """The sliding-window cache (window 8 in the reduced danube) below, at
    and above the window: prefill's padded or rolled ring buffer, then two
    decode steps that wrap it."""
    rm, params, m = _carried("h2o-danube-3-4b")
    W = m.cfg.swa_window
    rb, tb = _batches(m.cfg, np.random.default_rng(S), 2, S)
    with jax.disable_jit():
        rc, rl = rm.prefill(params, rb, max_len=S + 4)
    tc, tl = m.prefill(tb, max_len=S + 4)
    assert tc["k"].shape[2] == W
    _close_caches(tc, _tree_np(rc))
    for step in range(2):
        tok = jnp.argmax(rl[:, : m.cfg.vocab], -1).astype(jnp.int32)
        with jax.disable_jit():
            rc, rl = rm.decode_step(params, rc, tok, jnp.int32(S + step))
        tc, tl = m.decode_step(tc, torch.from_numpy(np.array(tok)), S + step)
        np.testing.assert_allclose(_np(tl), _np(rl), **LOGIT_TOL)
        _close_caches(tc, _tree_np(rc))


NON_MOE = [a for a in ARCH_NAMES if not treg.ARCHS[a].has_moe]


@pytest.mark.parametrize("arch", NON_MOE)
def test_reduced_arch_matches_compiled_reference(arch):
    rm, params, m = _carried(arch)
    cfg = m.cfg
    B, S = 2, 12
    P = cfg.n_frontend_tokens if cfg.frontend == "patch" else 0
    rb, tb = _batches(cfg, np.random.default_rng(0), B, S)
    want = jax.jit(lambda p, b: rm.forward(p, b, remat=False))(params, rb)
    with torch.no_grad():
        np.testing.assert_allclose(_np(m.forward(tb)), _np(want), **COMPILED_TOL)
    if not cfg.decoder:
        return
    rc, rl = jax.jit(rm.prefill, static_argnames="max_len")(params, rb, max_len=P + S + 4)
    tc, tl = m.prefill(tb, max_len=P + S + 4)
    np.testing.assert_allclose(_np(tl), _np(rl), **COMPILED_TOL)
    nxt = jnp.argmax(rl[:, : cfg.vocab], -1).astype(jnp.int32)
    _, rdl = jax.jit(rm.decode_step)(params, rc, nxt, jnp.int32(P + S))
    _, tdl = m.decode_step(tc, torch.from_numpy(np.array(nxt)), P + S)
    np.testing.assert_allclose(_np(tdl), _np(rdl), **COMPILED_TOL)


# ---------------------------------------------------------------------------
# the reference's own model tests, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS)
def test_reduced_prefill_decode_consistency(arch):
    """Greedy decode after prefill == teacher-forced forward argmax
    (tests/test_models_smoke.py's test, its tolerances)."""
    r = treg.ARCHS[arch].reduced()
    m = LMModel(r, device="cpu", generator=torch.Generator().manual_seed(1))
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, r.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        full = m.forward({"tokens": toks}, remat=False)
    cache, logits_last = m.prefill({"tokens": toks}, max_len=S + 4)
    np.testing.assert_allclose(_np(full[:, -1]), _np(logits_last), rtol=2e-2, atol=2e-2)
    nxt = torch.argmax(logits_last[:, : r.vocab], -1).to(torch.int32)
    cache2, dec_logits = m.decode_step(cache, nxt, S)
    with torch.no_grad():
        full2 = m.forward({"tokens": torch.cat([toks, nxt[:, None]], 1)}, remat=False)
    np.testing.assert_allclose(_np(full2[:, -1]), _np(dec_logits), rtol=6e-2, atol=6e-2)


def test_int8_kv_cache_decode_close_to_bf16():
    """int8 KV cache decode stays within quantization tolerance
    (tests/test_models_smoke.py's test, its bound)."""
    r = dataclasses.replace(treg.ARCHS["deepseek-7b"].reduced(), kv_cache_dtype="int8")
    m = LMModel(r, device="cpu", generator=torch.Generator().manual_seed(3))
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, r.vocab, (B, S)).astype(np.int32))
    cache, ll = m.prefill({"tokens": toks}, max_len=S + 4)
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.bfloat16
    nxt = torch.argmax(ll[:, : r.vocab], -1).to(torch.int32)
    cache2, dl = m.decode_step(cache, nxt, S)
    assert cache2["k"].dtype == torch.int8
    with torch.no_grad():
        full = m.forward({"tokens": torch.cat([toks, nxt[:, None]], 1)}, remat=False)
    err = float((full[:, -1] - dl).abs().max())
    assert err < 0.15, err


@pytest.mark.parametrize("n_layers", [2, 30])
def test_decode_vs_forward_gap_grows_with_depth_as_in_reference(n_layers):
    """The first decode step's logits against forward's on S+1 tokens
    (``test_reduced_prefill_decode_consistency``'s comparison) with the
    reduced deepseek cut to ``n_layers``, in both packages run op by op on
    the same weights and tokens.  The gap is the bf16 rounding of one-token
    against whole-sequence products, and it grows with depth in the
    reference as in the port: the two gaps stay within ``LOGIT_TOL`` of each
    other and under ``LM_DEPTH_TOL``.  Prints both packages' largest and
    mean gap and the largest logit difference between the packages
    (``pytest -s``)."""
    r_cfg = dataclasses.replace(rreg.ARCHS["deepseek-7b"].reduced(), n_layers=n_layers)
    t_cfg = dataclasses.replace(treg.ARCHS["deepseek-7b"].reduced(), n_layers=n_layers)
    rm = RModel(r_cfg)
    params = rm.init(jax.random.PRNGKey(1))
    m = lm_params_from_reference(_tree_np(params), LMModel(t_cfg, device="cpu"))
    B, S = 2, 12
    toks = np.random.default_rng(0).integers(0, t_cfg.vocab, (B, S)).astype(np.int32)
    with jax.disable_jit():
        rc, rl = rm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=S + 4)
        nxt = np.array(jnp.argmax(rl[:, : r_cfg.vocab], -1).astype(jnp.int32))
        _, r_dec = rm.decode_step(params, rc, jnp.asarray(nxt), jnp.int32(S))
        r_fwd = rm.forward(params, {"tokens": jnp.asarray(np.concatenate(
            [toks, nxt[:, None]], 1))}, remat=False)[:, -1]
    tc, _ = m.prefill({"tokens": torch.from_numpy(toks)}, max_len=S + 4)
    _, t_dec = m.decode_step(tc, torch.from_numpy(nxt), S)
    with torch.no_grad():
        t_fwd = m.forward({"tokens": torch.from_numpy(np.concatenate(
            [toks, nxt[:, None]], 1))}, remat=False)[:, -1]
    # op by op the packages part only where one bf16 rounding falls the
    # other way (a summation order); through depth such a flip spreads as
    # the decode-vs-forward gap does, so the logits are held to LM_DEPTH_TOL
    across = max(np.abs(_np(t_dec) - _np(r_dec)).max(), np.abs(_np(t_fwd) - _np(r_fwd)).max())
    r_gap = np.abs(_np(r_dec) - _np(r_fwd))
    t_gap = np.abs(_np(t_dec) - _np(t_fwd))
    print(f"decode vs forward, {n_layers} layers: max / mean |diff| reference "
          f"{r_gap.max():.5f} / {r_gap.mean():.5f}, port {t_gap.max():.5f} / {t_gap.mean():.5f}; "
          f"port vs reference {across:.5f}")
    assert across < LM_DEPTH_TOL
    assert abs(t_gap.max() - r_gap.max()) <= LOGIT_TOL["atol"]
    assert r_gap.max() < LM_DEPTH_TOL and t_gap.max() < LM_DEPTH_TOL
