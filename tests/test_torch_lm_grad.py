"""The port's LM backward (``repro_torch.models``) against the JAX
reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
model holds the reference's parameters (``convert.lm_params_from_reference``).
The reference runs op by op (``jax.disable_jit``), rounding every bf16 op as
the port does, except where a test says it runs compiled.

* The flash attention's backward (``layers._Flash``) against the reference's
  ``_flash`` custom VJP at the five shapes of
  ``test_attention_and_optim.py::test_flash_fwd_bwd_matches_naive``, float32:
  dq/dk/dv within ``FLASH_GRAD_ATOL`` (that test's 5e-5); in bf16 within one
  bf16 ulp.  It keeps only ``(q, k, v, out, lse)``.
* The chunked SSM scan: chunked equals unchunked and checkpointed equals
  plain, bit for bit; its gradients against the reference's within
  ``BF16_TOL``.
* ``loss`` and the gradient of every parameter of every reduced arch
  against ``jax.value_and_grad(model.loss)``: the loss within 1e-4, each
  gradient within ``LM_GRAD_RTOL`` = 2e-2 of its norm, plus
  ``LM_GRAD_NOISE`` (1e-6) of the whole gradient's norm for the one tensor
  that is rounding noise in both packages (a top-1 router, whose gate is
  divided by itself: zero in exact arithmetic; the reference compiled
  against itself op by op differs by more than half its norm there,
  ``test_top1_router_grad_is_rounding_noise``).
* The embedding's gradient with a repeated token: the whole table cast to
  bf16 and then gathered, so repeats sum in bf16, as the reference's do.
* Remat off, ``none`` and ``dots``: bit-identical gradients; ``dots``
  saves exactly the weight products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_cases import LM_GRAD_NOISE, grad_errors
from repro.configs import registry as rreg
from repro.models import LMModel as RModel
from repro.models import layers as RL
from repro.models import ssm as RS
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import LMModel
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

ARCH_NAMES = sorted(treg.ARCHS)
FLASH_SHAPES = [
    (64, 4, 2, 16, True, 0),
    (128, 8, 2, 32, True, 24),
    (64, 4, 4, 8, False, 0),
    (96, 6, 2, 16, True, 0),
    (32, 2, 1, 8, True, 8),
]
FLASH_GRAD_ATOL = 5e-5
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
LOSS_ATOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _tree_np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), t)


def _flat(tree) -> dict:
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({"blocks." + k: v for k, v in tree["blocks"].items()})
    return out


def _zero_grads(m):
    for p in m.parameters():
        p.grad = torch.zeros_like(p)


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

def _qkvd(rng, B, S, H, KV, hd):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]


@pytest.mark.parametrize("S,H,KV,hd,causal,window", FLASH_SHAPES)
def test_flash_backward_matches_reference_vjp(S, H, KV, hd, causal, window):
    q, k, v, do = _qkvd(np.random.default_rng(S + H), 2, S, H, KV, hd)
    kw = dict(causal=causal, window=window, q_chunk=32, kv_chunk=32)
    out, vjp = jax.vjp(lambda *a: RL.flash_attention(*a, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = TL.flash_attention(tq, tk, tv, **kw)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(got), np.asarray(out), atol=2e-5)
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=FLASH_GRAD_ATOL)


def test_flash_backward_bf16_matches_reference_op_by_op():
    """bf16 inputs (the model's): each gradient comes back in bf16, within one
    bf16 ulp of the reference's."""
    q, k, v, do = _qkvd(np.random.default_rng(7), 2, 32, 4, 2, 16)
    kw = dict(causal=True, window=0, q_chunk=16, kv_chunk=16)
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda *a: RL.flash_attention(*a, **kw),
                           *[jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)])
        want = vjp(jnp.asarray(do, jnp.bfloat16))
    tq, tk, tv = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    got = TL.flash_attention(tq, tk, tv, **kw)
    got.backward(torch.from_numpy(do).to(torch.bfloat16))
    np.testing.assert_array_equal(_np(got), _np(out))
    for t, w in zip((tq, tk, tv), want):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(t.grad), _np(w), **BF16_TOL)


def test_flash_keeps_only_its_residuals():
    """Autograd records nothing of the forward loop: the tensors saved for
    the backward are ``(qg, kk, vv, out, lse)``, none of them (S, T)."""
    B, S, H, KV, hd = 1, 64, 4, 2, 8
    q, k, v, _ = [torch.from_numpy(x).requires_grad_()
                  for x in _qkvd(np.random.default_rng(1), B, S, H, KV, hd)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(tuple(t.shape)) or t,
                                                  lambda t: t):
        TL.flash_attention(q, k, v, q_chunk=16, kv_chunk=16)
    assert sorted(saved) == sorted([(B, KV, H // KV, S, hd), (B, KV, S, hd), (B, KV, S, hd),
                                    (B, KV, H // KV, S, hd), (B, KV, H // KV, S)])


# ---------------------------------------------------------------------------
# the chunked SSM scan
# ---------------------------------------------------------------------------

def _ssm_inputs(rng, B=2, S=24, di=8, N=4):
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, di)).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    D = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32)
    return u, dt, Bc, Cc, A, D, h0


def _ssm_torch(arrays, grad=False):
    u, dt, Bc, Cc, A, D, h0 = arrays
    bf = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(grad) for x in (u, dt, Bc, Cc)]
    f32 = [torch.from_numpy(x.copy()).requires_grad_(grad) for x in (A, D, h0)]
    return bf + f32


@pytest.mark.parametrize("chunk", [4, 6, 16, 64])
def test_chunked_ssm_scan_equals_unchunked_bitwise(chunk):
    """Chunks of ``chunk`` (16 halves to 8 on 24 steps) against one chunk of
    the whole sequence, with gradients recorded (so each chunk runs under
    its checkpoint): y, the last state and every input's gradient equal."""
    arrays = _ssm_inputs(np.random.default_rng(chunk))
    outs = []
    for c in (chunk, 24):
        ins = _ssm_torch(arrays, grad=True)
        y, h = TS._ssm_inner(*ins, chunk=c)
        (y.float().square().sum() + h.square().sum()).backward()
        outs.append([y, h] + [t.grad for t in ins])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_ssm_chunk_checkpoints_change_no_gradient(monkeypatch):
    """The same scan with each chunk's checkpoint replaced by a plain call:
    every gradient bit for bit."""
    arrays = _ssm_inputs(np.random.default_rng(3))
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(TS, "checkpoint", lambda fn, *a, **kw: fn(*a))
        ins = _ssm_torch(arrays, grad=True)
        y, h = TS._ssm_inner(*ins, chunk=4)
        (y.float().square().sum() + h.square().sum()).backward()
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_ssm_scan_grads_match_reference():
    arrays = _ssm_inputs(np.random.default_rng(5))
    u, dt, Bc, Cc, A, D, h0 = arrays

    def ref_loss(u, dt, Bc, Cc, A, D, h0):
        y, h = RS._ssm_inner(u, dt, Bc, Cc, A, D, h0, chunk=4)
        return jnp.sum(jnp.square(y.astype(jnp.float32))) + jnp.sum(jnp.square(h))

    with jax.disable_jit():
        want = jax.grad(ref_loss, argnums=tuple(range(7)))(
            *[jnp.asarray(x, jnp.bfloat16) for x in (u, dt, Bc, Cc)],
            *[jnp.asarray(x) for x in (A, D, h0)])
    ins = _ssm_torch(arrays, grad=True)
    y, h = TS._ssm_inner(*ins, chunk=4)
    (y.float().square().sum() + h.square().sum()).backward()
    for t, w in zip(ins, want):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(_np(t.grad), _np(w), **BF16_TOL)


# ---------------------------------------------------------------------------
# loss and every parameter's gradient, every reduced arch
# ---------------------------------------------------------------------------

def _carried(arch):
    rm = RModel(rreg.ARCHS[arch].reduced())
    params = rm.init(jax.random.PRNGKey(1))
    m = lm_params_from_reference(_tree_np(params), LMModel(treg.ARCHS[arch].reduced(),
                                                           device="cpu"))
    return rm, params, m


def _train_batches(cfg, rng, B=2, S=8):
    """A labelled batch in both packages; two labels masked (-1) and a token
    repeated across rows."""
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :2] = -1
    rb, tb = {"labels": jnp.asarray(labels)}, {"labels": torch.from_numpy(labels)}
    if cfg.frontend == "frame":
        fr = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
        rb["frames"], tb["frames"] = jnp.asarray(fr, jnp.bfloat16), torch.from_numpy(fr).to(
            torch.bfloat16)
        return rb, tb
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    toks[1, 3] = toks[1, 5] = toks[0, 7] = toks[1, 6]
    rb["tokens"], tb["tokens"] = jnp.asarray(toks), torch.from_numpy(toks)
    if cfg.frontend == "patch":
        pt = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        rb["patches"], tb["patches"] = jnp.asarray(pt, jnp.bfloat16), torch.from_numpy(pt).to(
            torch.bfloat16)
    return rb, tb


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_grads_match_reference_op_by_op(arch):
    rm, params, m = _carried(arch)
    rb, tb = _train_batches(m.cfg, np.random.default_rng(0))
    with jax.disable_jit():
        (rloss, rmet), rgrad = jax.value_and_grad(rm.loss, has_aux=True)(params, rb)
    _zero_grads(m)
    loss, met = m.loss(tb)
    loss.backward()
    assert abs(float(loss) - float(rloss)) <= LOSS_ATOL
    assert float(met["tokens"]) == float(rmet["tokens"]) == 14.0
    errs = grad_errors({k: p.grad for k, p in m.params().items()}, _flat(rgrad))
    for name, (err, bound) in errs.items():
        assert err <= bound, f"{name}: |g - ref| {err:.3g} over {bound:.3g}"


def test_top1_router_grad_is_rounding_noise():
    """The witness behind ``LM_GRAD_NOISE``: llama4-scout's reduced config routes
    top-1, so each token's gate is divided by itself and the router's
    gradient is zero in exact arithmetic.  In the reference it is rounding
    noise under 1e-6 of the whole gradient's norm, and the reference
    compiled against itself op by op differs there by more than half its
    norm."""
    arch = "llama4-scout-17b-a16e"
    assert rreg.ARCHS[arch].reduced().top_k == 1
    rm, params, m = _carried(arch)
    rb, _ = _train_batches(m.cfg, np.random.default_rng(0))
    with jax.disable_jit():
        _, eager = jax.value_and_grad(rm.loss, has_aux=True)(params, rb)
    _, compiled = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(params, rb)
    total = np.sqrt(sum(float(np.sum(_np(w).astype(np.float64) ** 2))
                        for w in _flat(eager).values()))
    a, b = _np(eager["blocks"]["moe.router"]), _np(compiled["blocks"]["moe.router"])
    assert np.linalg.norm(a) < LM_GRAD_NOISE * total
    assert np.linalg.norm(a - b) > 0.5 * np.linalg.norm(a)


def test_embedding_repeated_token_grad_matches_reference():
    """``_embed_inputs``' backward with one token at 20 of 32 positions and
    the same bf16 cotangent in both packages: the reference casts the table
    to bf16 and then gathers, so a repeated token's gradients are summed in
    bf16; the port does the same, bit for bit.  Gathered and then cast, as
    the serving slice had it, the sum runs in float32 and comes out
    otherwise."""
    rm, params, m = _carried("deepseek-7b")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, m.cfg.vocab, (2, 16)).astype(np.int32)
    toks[:, ::2] = 7
    toks[0, 1:4] = 7
    ct = rng.standard_normal((2, 16, m.cfg.d_model)).astype(np.float32)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda e: rm._embed_inputs({**params, "embed": e},
                                                    {"tokens": jnp.asarray(toks)})[0],
                         params["embed"])
        (want,) = vjp(jnp.asarray(ct, jnp.bfloat16))
    want = _np(want)
    _zero_grads(m)
    x, _, _ = m._embed_inputs({"tokens": torch.from_numpy(toks)})
    x.backward(torch.from_numpy(ct).to(torch.bfloat16))
    np.testing.assert_array_equal(m.top["embed"].grad.numpy(), want)
    table = m.top["embed"].detach().requires_grad_()
    table[torch.from_numpy(toks).long()].to(torch.bfloat16).backward(
        torch.from_numpy(ct).to(torch.bfloat16))
    assert not np.array_equal(table.grad[7].numpy(), want[7])
    others = np.ones(len(want), bool)
    others[7] = False
    np.testing.assert_array_equal(table.grad.numpy()[others], want[others])


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _grads_under(m, tb, policy, monkeypatch):
    """Every parameter's gradient of ``loss`` with remat off or under
    ``REPRO_REMAT_POLICY=policy``."""
    if policy != "off":
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
    _zero_grads(m)
    loss, _ = m.loss(tb, remat=policy != "off")
    loss.backward()
    return {n: p.grad.clone() for n, p in m.params().items()}


@pytest.mark.parametrize("arch", ["deepseek-7b", "hymba-1.5b", "falcon-mamba-7b",
                                  "arctic-480b", "internvl2-76b"])
def test_remat_settings_give_bitwise_equal_grads(arch, monkeypatch):
    m = LMModel(treg.ARCHS[arch].reduced(), device="cpu",
                generator=torch.Generator().manual_seed(2))
    _, tb = _train_batches(m.cfg, np.random.default_rng(1))
    off = _grads_under(m, tb, "off", monkeypatch)
    for policy in ("none", "dots"):
        got = _grads_under(m, tb, policy, monkeypatch)
        for n in off:
            assert torch.equal(got[n], off[n]), (policy, n)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_dots_policy_saves_the_weight_products(monkeypatch):
    """Under ``dots`` the backward runs no weight product of the forward
    again: its ``aten.mm`` are the products' own gradients, two for each of
    the 7 a layer (reduced deepseek: wq, wk, wv, wo, wi0, wi1, wo).  Under
    ``none`` the recompute runs them again (all but the last of a block,
    whose output no backward needs: the checkpoint stops before it)."""
    m = LMModel(treg.ARCHS["deepseek-7b"].reduced(), device="cpu")
    _, tb = _train_batches(m.cfg, np.random.default_rng(1))
    counts = {}
    for policy in ("none", "dots"):
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        _zero_grads(m)
        loss, _ = m.loss(tb)
        with _CountMM() as c:
            loss.backward()
        counts[policy] = c.mm
    assert counts["dots"] == 2 * 7 * m.cfg.n_layers
    assert counts["none"] == counts["dots"] + 6 * m.cfg.n_layers


def test_stacked_grad_buffer_takes_each_layer_in_place():
    """With a ``.grad`` buffer on the stacked parameters each layer's gradient
    lands in its slice of that same buffer, equal to what autograd gives
    through the plain views (no buffer)."""
    m = LMModel(treg.ARCHS["hymba-1.5b"].reduced(), device="cpu")
    _, tb = _train_batches(m.cfg, np.random.default_rng(1))
    for p in m.parameters():
        p.grad = None
    m.loss(tb)[0].backward()
    plain = {n: p.grad.clone() for n, p in m.params().items()}
    _zero_grads(m)
    ptrs = {n: p.grad.data_ptr() for n, p in m.params().items()}
    m.loss(tb)[0].backward()
    for n, p in m.params().items():
        assert p.grad.data_ptr() == ptrs[n], n
        assert torch.equal(p.grad, plain[n]), n


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_match_reference(arch):
    got = LMModel(treg.ARCHS[arch].reduced(), device="cpu").abstract_params()
    want = RModel(rreg.ARCHS[arch].reduced()).abstract_params()
    flat_got, flat_want = _flat(got), _flat(want)
    assert set(flat_got) == set(flat_want)
    for k, v in flat_got.items():
        assert v.device.type == "meta" and v.dtype == torch.float32
        assert tuple(v.shape) == tuple(flat_want[k].shape), k
