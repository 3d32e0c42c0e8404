"""The port's LM training (``repro_torch.train``, ``repro_torch.launch.steps``
and ``repro_torch.launch.train``) against the JAX reference's, on the CPU.

* AdamW: the reference's own optimizer tests on the port; ``apply_updates``
  over 3 steps against the reference's run op by op (``jax.disable_jit``),
  float32 and bf16 moments: parameters, moments and learning rate bit for
  bit at ``clip_norm`` 1e9.  With clipping on they part only through the
  global norm, whose float32 sum runs in another order (the reference's
  norm handed to the port makes them equal again).  ``schedule`` bit for
  bit; ``choose_accum`` equal.
* One train step (accum 1 and 2) on the reduced deepseek against the
  reference's ``make_train_step`` op by op, same weights and batch: loss,
  tokens and lr equal, the grad norm within 1e-3 relative, every parameter
  within ``2.02 · lr`` (step 1 moves a weight by ±lr wherever its gradient
  is not zero, so a near-zero gradient whose sign the packages' rounding
  sets differently parts them by 2·lr).  The
  reference's accumulation and per-arch train-step tests on the port.
* Checkpoints: round trip, rotation, the reference's file layout, files
  crossing both ways, bf16 leaves (the port restores them, the reference
  raises).
* The loop: crash and resume bit for bit, loss decreasing (the reference's
  test), the history's keys; the launcher on ``--device cpu``; an import
  guard.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.launch import steps as rsteps
from repro.models import LMModel as RModel
from repro.train import checkpoint as rckpt
from repro.train import optimizer as ropt
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import steps as tsteps
from repro_torch.models import LMModel
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.train_loop import TrainConfig, train

HISTORY_KEYS = {"loss", "tokens", "grad_norm", "lr", "step", "step_time_s", "stragglers"}
_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _tree_np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), t)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_impl():
    """One AdamW step vs a straight-line numpy reference
    (test_attention_and_optim.py's test, its bound)."""
    cfg = topt.AdamWConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                           clip_norm=1e9, state_dtype=torch.float32,
                           warmup_steps=1, total_steps=10, min_lr_frac=1.0)
    w = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    gw = np.array([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    st = topt.init_state(p, cfg)
    newp, st2, _ = topt.apply_updates(p, {"w": torch.from_numpy(gw)}, st, cfg)
    m, v = 0.1 * gw, 0.001 * gw ** 2
    mh, vh = m / 0.1, v / 0.001
    ref = w - 0.1 * (mh / (np.sqrt(vh) + 1e-8) + 0.01 * w)
    np.testing.assert_allclose(newp["w"].numpy(), ref, rtol=1e-5)
    assert newp["w"] is p["w"]          # in place
    assert int(st2["step"]) == 1 and st2["step"].dtype == torch.int32


def test_grad_clipping():
    cfg = topt.AdamWConfig(lr=1e-3, clip_norm=1.0, state_dtype=torch.float32)
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 100.0)}
    assert float(topt.global_norm(g)) > 1.0
    newp, st, metrics = topt.apply_updates(p, g, topt.init_state(p, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0, rel=1e-3)
    assert torch.isfinite(newp["w"]).all()


_SHAPES = {"blocks": {"w": (3, 40, 24), "b": (3, 24)}, "embed": (50, 16), "final_ln": (16,)}


def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in _flat(_SHAPES).items()}
    gs = [{k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-6, 1, s)).astype(np.float32)
           for k, s in _flat(_SHAPES).items()} for _ in range(3)]
    return p0, gs


def _nest(flat, to):
    out = {"blocks": {}}
    for k, v in flat.items():
        if k.startswith("blocks/"):
            out["blocks"][k[7:]] = to(v)
        else:
            out[k] = to(v)
    return out


def _three_steps(dtype, clip, monkeypatch=None):
    """3 ``apply_updates`` steps in both packages; yields (step, port, ref)
    with each side's (params, state, metrics)."""
    jdt, tdt = _DTYPES[dtype]
    kw = dict(lr=1e-2, clip_norm=clip, warmup_steps=2, total_steps=6)
    rcfg, tcfg = ropt.AdamWConfig(state_dtype=jdt, **kw), topt.AdamWConfig(state_dtype=tdt, **kw)
    p0, gs = _opt_case()
    rp = _nest(p0, jnp.asarray)
    rs = ropt.init_state(rp, rcfg)
    tp = _nest(p0, lambda a: torch.from_numpy(a.copy()))
    ts = topt.init_state(tp, tcfg)
    for i, g in enumerate(gs):
        with jax.disable_jit():
            rp, rs, rm = ropt.apply_updates(rp, _nest(g, jnp.asarray), rs, rcfg)
        if monkeypatch is not None:   # the reference's norm, handed to the port
            monkeypatch.setattr(topt, "global_norm",
                                lambda _, n=np.asarray(rm["grad_norm"]): torch.tensor(n))
        tp, ts, tm = topt.apply_updates(tp, _nest(g, torch.from_numpy), ts, tcfg)
        yield i, (tp, ts, tm), (rp, rs, rm)


def _assert_bitwise(port, ref):
    (tp, ts, tm), (rp, rs, rm) = port, ref
    for tree_t, tree_r in ((tp, rp), (ts["m"], rs["m"]), (ts["v"], rs["v"])):
        ft, fr = _flat(tree_t), _flat(tree_r)
        for k in fr:
            assert str(ft[k].dtype).split(".")[-1] == np.asarray(fr[k]).dtype.name, k
            np.testing.assert_array_equal(_np(ft[k]), _np(fr[k]), err_msg=k)
    assert int(ts["step"]) == int(rs["step"])
    assert np.float32(tm["lr"]) == np.asarray(rm["lr"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_bitwise_against_reference(dtype):
    for i, port, ref in _three_steps(dtype, 1e9):
        _assert_bitwise(port, ref)
        assert float(port[2]["grad_norm"]) == pytest.approx(float(ref[2]["grad_norm"]), rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clipped_updates_part_only_through_the_norm(dtype, monkeypatch):
    """At clip_norm 1.0 the packages' global norms differ in the last bits
    (another summation order), and so does everything the clip scales; with
    the reference's norm every bit is equal again."""
    differs = False
    for i, (tp, ts, tm), (rp, rs, rm) in _three_steps(dtype, 1.0):
        differs |= any(not np.array_equal(_np(a), _np(b))
                       for a, b in zip(_flat(tp).values(), _flat(rp).values()))
    assert differs
    for i, port, ref in _three_steps(dtype, 1.0, monkeypatch):
        _assert_bitwise(port, ref)


def test_schedule_matches_reference_bitwise():
    for kw in (dict(warmup_steps=7, total_steps=50, min_lr_frac=0.1, lr=3e-4),
               dict(warmup_steps=1, total_steps=10, min_lr_frac=1.0, lr=0.1),
               dict(warmup_steps=0, total_steps=0, min_lr_frac=0.0, lr=1e-3)):
        rcfg, tcfg = ropt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
        with jax.disable_jit():
            want = [np.asarray(ropt.schedule(rcfg, jnp.int32(s))) for s in range(60)]
        got = [topt.schedule(tcfg, torch.tensor(s, dtype=torch.int32)) for s in range(60)]
        for s, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.float32 and np.float32(g) == w, (kw, s)


def test_choose_accum_matches_reference():
    for name in treg.ARCHS:
        for shape in tbase.SHAPES:
            for shards in (1, 16, 32):
                for budget in (4e9, 1e8):
                    assert tsteps.choose_accum(treg.ARCHS[name], tbase.SHAPES[shape], shards,
                                               budget) == \
                        rsteps.choose_accum(rreg.ARCHS[name], rbase.SHAPES[shape], shards,
                                            budget)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _deepseek(seed=2):
    rm = RModel(rreg.ARCHS["deepseek-7b"].reduced())
    params = rm.init(jax.random.PRNGKey(seed))
    m = lm_params_from_reference(_tree_np(params),
                                 LMModel(treg.ARCHS["deepseek-7b"].reduced(), device="cpu"))
    return rm, params, m


def test_apply_updates_in_slices_bitwise(monkeypatch):
    """The update a slice at a time (flat pieces of contiguous leaves, rows
    of a leaf with a non-contiguous tensor) gives the parameters and moments
    of the update in one piece, bit for bit."""
    shapes = {"stack": (2, 5, 6), "mat": (7, 3), "vec": (13,), "scalar": ()}
    cfg = topt.AdamWConfig(state_dtype=torch.bfloat16, warmup_steps=1, total_steps=4)

    def leaves(seed):
        r = np.random.default_rng(seed)
        return {k: torch.from_numpy(r.standard_normal(v).astype(np.float32))
                for k, v in shapes.items()}

    out = []
    for chunk in (1 << 25, 4):
        monkeypatch.setattr(topt, "UPDATE_CHUNK", chunk)
        p, g = leaves(1), leaves(2)
        g["mat"] = g["mat"].t().contiguous().t()       # a non-contiguous gradient
        st = topt.init_state(p, cfg)
        for _ in range(2):
            topt.apply_updates(p, g, st, cfg)
        out.append((p, st))
    for k in shapes:
        assert torch.equal(out[0][0][k], out[1][0][k]), k
        for mom in ("m", "v"):
            assert torch.equal(out[0][1][mom][k], out[1][1][mom][k]), (mom, k)


def _lm_batch(cfg, rng, B, S):
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return toks, labels


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    rm, params, m = _deepseek()
    toks, labels = _lm_batch(m.cfg, np.random.default_rng(0), 4, 16)
    rcfg, tcfg = ropt.AdamWConfig(state_dtype=jnp.float32), topt.AdamWConfig(
        state_dtype=torch.float32)
    with jax.disable_jit():
        rp, rs, rmet = rsteps.make_train_step(rm, rcfg, accum=accum)(
            params, ropt.init_state(params, rcfg),
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    ts, tmet = tsteps.make_train_step(m, tcfg, accum=accum)(
        topt.init_state(m.param_tree(), tcfg),
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert set(tmet) == set(rmet)
    assert float(tmet["loss"]) == pytest.approx(float(rmet["loss"]), abs=1e-6)
    assert float(tmet["tokens"]) == float(rmet["tokens"]) == 64 / accum
    assert np.float32(tmet["lr"]) == np.asarray(rmet["lr"])
    assert float(tmet["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=1e-3)
    assert int(ts["step"]) == 1
    lr = float(rmet["lr"])
    want = _flat(rp)
    for name, p in _flat(m.param_tree()).items():
        np.testing.assert_allclose(_np(p), _np(want[name]), rtol=0, atol=2.02 * lr,
                                   err_msg=name)


def test_grad_accumulation_equivalence():
    """accum=2 must match accum=1 on the same global batch
    (test_models_smoke.py's test, its bounds)."""
    _, _, m1 = _deepseek()
    _, _, m2 = _deepseek()
    toks, labels = _lm_batch(m1.cfg, np.random.default_rng(2), 4, 16)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    cfg = topt.AdamWConfig(state_dtype=torch.float32)
    _, met1 = tsteps.make_train_step(m1, cfg, accum=1)(topt.init_state(m1.param_tree(), cfg),
                                                       batch)
    _, met2 = tsteps.make_train_step(m2, cfg, accum=2)(topt.init_state(m2.param_tree(), cfg),
                                                       batch)
    assert abs(float(met1["loss"]) - float(met2["loss"])) < 1e-2
    for a, b in zip(m1.parameters(), m2.parameters()):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_reduced_train_step(arch):
    """test_models_smoke.py's train step on the port: finite loss, a positive
    grad norm, and the parameters moved."""
    r = treg.ARCHS[arch].reduced()
    m = LMModel(r, device="cpu")
    rng = np.random.default_rng(0)
    B, S = 2, 16
    batch = {"labels": torch.from_numpy(rng.integers(0, r.vocab, (B, S)).astype(np.int32))}
    if r.frontend == "frame":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, S, r.frontend_dim)).astype(np.float32)).to(torch.bfloat16)
    else:
        batch["tokens"] = torch.from_numpy(rng.integers(0, r.vocab, (B, S)).astype(np.int32))
        if r.frontend == "patch":
            batch["patches"] = torch.from_numpy(rng.standard_normal(
                (B, r.n_frontend_tokens, r.frontend_dim)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        logits = m.forward(batch)
    assert logits.shape == (B, S, r.vocab_padded) and torch.isfinite(logits).all()
    before = [p.detach().clone() for p in m.parameters()]
    cfg = topt.AdamWConfig(state_dtype=torch.float32)
    _, metrics = tsteps.make_train_step(m, cfg)(topt.init_state(m.param_tree(), cfg), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0
    assert any(not torch.allclose(a, b) for a, b in zip(before, m.parameters()))


def test_train_step_refuses_a_bf16_accumulator():
    """A bf16 accumulator on float32 parameters, once refused, now sums the
    microbatches' gradients in bf16 as the reference's does (op by op): the
    loss, the grad norm of the bf16 sum and every parameter as in
    ``test_train_step_matches_reference``."""
    rm, params, m = _deepseek()
    toks, labels = _lm_batch(m.cfg, np.random.default_rng(0), 4, 16)
    rcfg, tcfg = ropt.AdamWConfig(state_dtype=jnp.float32), topt.AdamWConfig(
        state_dtype=torch.float32)
    with jax.disable_jit():
        rp, _, rmet = rsteps.make_train_step(rm, rcfg, accum=2, grad_dtype=jnp.bfloat16)(
            params, ropt.init_state(params, rcfg),
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    _, tmet = tsteps.make_train_step(m, tcfg, accum=2, grad_dtype=torch.bfloat16)(
        topt.init_state(m.param_tree(), tcfg),
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert float(tmet["loss"]) == pytest.approx(float(rmet["loss"]), abs=1e-6)
    assert float(tmet["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=1e-3)
    assert all(p.grad.dtype == torch.float32 for p in m.parameters())
    lr = float(rmet["lr"])
    want = _flat(rp)
    for name, p in _flat(m.param_tree()).items():
        np.testing.assert_allclose(_np(p), _np(want[name]), rtol=0, atol=2.02 * lr,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(m, cfg):
    return {"params": m.param_tree(), "opt": topt.init_state(m.param_tree(), cfg)}


def test_checkpoint_roundtrip(tmp_path):
    m = LMModel(treg.ARCHS["deepseek-7b"].reduced(), device="cpu")
    cfg = topt.AdamWConfig()                       # bf16 moments
    state = _state(m, cfg)
    for leaf in _flat(state["opt"]["m"]).values():
        leaf.normal_()
    state["opt"]["step"].fill_(5)
    ckpt.save(str(tmp_path), 7, state, extra={"note": "x"})
    restored, meta = ckpt.restore_latest(str(tmp_path), state)
    assert meta == {"step": 7, "note": "x"}
    got, want = _flat(restored), _flat(state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k] is not want[k]
        assert torch.equal(got[k], want[k]), k


def test_checkpoint_rotation(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, {"w": torch.zeros(4)}, keep=2)
    assert ckpt.list_steps(str(tmp_path)) == [4, 5]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]


def test_checkpoint_has_the_reference_layout(tmp_path):
    """Same directory, file names, leaf keys (in the same order), dtypes and
    meta as the reference's checkpoint of the same state."""
    rm, params, m = _deepseek()
    rcfg = ropt.AdamWConfig()
    rckpt.save(str(tmp_path / "ref"), 3, {"params": params, "opt": ropt.init_state(params, rcfg)})
    ckpt.save(str(tmp_path / "port"), 3, _state(m, topt.AdamWConfig()))
    for side in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / side / "step_00000003")) == ["meta.json",
                                                                        "state.npz"]
    with np.load(tmp_path / "ref" / "step_00000003" / "state.npz") as r, \
            np.load(tmp_path / "port" / "step_00000003" / "state.npz") as t:
        assert list(t.files) == list(r.files)
        assert "params/blocks/attn.wq" in r.files and "opt/m/embed" in r.files
        for k in r.files:
            assert t[k].dtype == r[k].dtype and t[k].shape == r[k].shape, k
            assert t[k].tobytes() == r[k].tobytes(), k
    for side in ("ref", "port"):
        with open(tmp_path / side / "step_00000003" / "meta.json") as f:
            assert json.load(f) == {"step": 3}


def test_checkpoints_cross_between_packages(tmp_path):
    """A float32 checkpoint of the reference restores in the port and one of
    the port in the reference, every leaf equal; bf16 leaves written by the
    reference restore in the port."""
    rm, params, m = _deepseek()
    f32 = ropt.AdamWConfig(state_dtype=jnp.float32)
    rstate = {"params": params, "opt": ropt.init_state(params, f32)}
    rstate["opt"]["m"] = jax.tree_util.tree_map(lambda a: a + 0.5, rstate["opt"]["m"])
    rckpt.save(str(tmp_path / "ref"), 4, rstate)
    m2 = LMModel(m.cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    got, meta = ckpt.restore_latest(str(tmp_path / "ref"),
                                    _state(m2, topt.AdamWConfig(state_dtype=torch.float32)))
    assert meta["step"] == 4
    want = _flat(_tree_np(rstate))
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(_np(v), _np(want[k]), err_msg=k)
    # the port's file in the reference
    ckpt.save(str(tmp_path / "port"), 6, got)
    back, meta = rckpt.restore_latest(str(tmp_path / "port"), rstate)
    assert meta["step"] == 6
    for k, v in _flat(_tree_np(back)).items():
        np.testing.assert_array_equal(_np(v), _np(want[k]), err_msg=k)
    # the reference's bf16 moments in the port
    bf = ropt.AdamWConfig()
    rbf = {"params": params, "opt": ropt.init_state(params, bf)}
    rbf["opt"]["v"] = jax.tree_util.tree_map(lambda a: (a + 0.3).astype(jnp.bfloat16),
                                             rbf["opt"]["v"])
    rckpt.save(str(tmp_path / "refbf"), 2, rbf)
    got, _ = ckpt.restore_latest(str(tmp_path / "refbf"), _state(m2, topt.AdamWConfig()))
    for k, v in _flat(got["opt"]["v"]).items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(v), _np(_flat(_tree_np(rbf["opt"]["v"]))[k]))


def test_bf16_leaves_restore_in_the_port_while_the_reference_raises(tmp_path):
    """Found while planning: the reference writes a bf16 leaf as raw 2-byte
    void records and its restore casts them with ``astype``, which numpy
    refuses.  The port reads the bytes as bf16."""
    tree = {"m": jnp.asarray([1.5, -2.0, 3.0], jnp.bfloat16)}
    rckpt.save(str(tmp_path / "ref"), 1, tree)
    with np.load(tmp_path / "ref" / "step_00000001" / "state.npz") as z:
        assert z["m"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="No cast function"):
        rckpt.restore_latest(str(tmp_path / "ref"), tree)
    template = {"m": torch.zeros(3, dtype=torch.bfloat16)}
    got, _ = ckpt.restore_latest(str(tmp_path / "ref"), template)
    assert got["m"].dtype == torch.bfloat16 and got["m"].tolist() == [1.5, -2.0, 3.0]
    ckpt.save(str(tmp_path / "port"), 1, got)
    with pytest.raises(ValueError, match="No cast function"):
        rckpt.restore_latest(str(tmp_path / "port"), tree)
    again, _ = ckpt.restore_latest(str(tmp_path / "port"), template)
    assert torch.equal(again["m"], got["m"])


# ---------------------------------------------------------------------------
# the training loop and the launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    r = treg.ARCHS["deepseek-7b"].reduced()
    m = LMModel(r, device="cpu")
    pipe = TokenPipeline(PipelineConfig(vocab=r.vocab, seq_len=16, global_batch=4))
    opt = topt.AdamWConfig(lr=1e-3, state_dtype=torch.float32, warmup_steps=2, total_steps=20)
    return m, pipe, opt


def _params(out):
    return [p.detach().clone() for p in _flat(out["params"]).values()]


def test_crash_resume_bitwise_identical(tmp_path, setup):
    """Kill at step 7, restart, final params == uninterrupted run
    (test_fault_tolerance.py's test)."""
    m, pipe, opt = setup
    d1, d2 = str(tmp_path / "run_crash"), str(tmp_path / "run_clean")
    with pytest.raises(RuntimeError, match="injected failure"):
        train(m, pipe.batch_at, opt, TrainConfig(steps=10, ckpt_every=3, ckpt_dir=d1,
                                                 fail_at_step=7))
    out_resumed = train(m, pipe.batch_at, opt, TrainConfig(steps=10, ckpt_every=3, ckpt_dir=d1))
    assert out_resumed["resumed_from"] == 6
    assert [h["step"] for h in out_resumed["history"]] == [6, 7, 8, 9]
    resumed = _params(out_resumed)
    out_clean = train(m, pipe.batch_at, opt, TrainConfig(steps=10, ckpt_every=3, ckpt_dir=d2))
    assert out_clean["resumed_from"] == 0
    for a, b in zip(resumed, _params(out_clean)):
        assert torch.equal(a, b), "resume must replay identically"
    assert ckpt.list_steps(d1) == ckpt.list_steps(d2) == [6, 9, 10]


def test_loss_decreases(setup):
    m, pipe, _ = setup
    opt = topt.AdamWConfig(lr=3e-3, state_dtype=torch.float32, warmup_steps=3,
                           total_steps=60, min_lr_frac=1.0)
    out = train(m, pipe.batch_at, opt, TrainConfig(steps=50))
    first = np.mean([h["loss"] for h in out["history"][:5]])
    last = np.mean([h["loss"] for h in out["history"][-5:]])
    assert last < first - 0.05, f"no learning: {first} -> {last}"


def test_history_and_restart_from_the_same_weights(setup):
    """The history has the reference's keys; ``on_step`` sees each step; with
    no ``params`` each run starts from the generator's weights (seeded 0
    when none is given), whatever the model held; ``params`` are loaded."""
    m, pipe, opt = setup
    seen = []
    a = train(m, pipe.batch_at, opt, TrainConfig(steps=3),
              on_step=lambda s, h: seen.append((s, set(h))))
    assert [s for s, _ in seen] == [0, 1, 2]
    assert all(keys == HISTORY_KEYS for _, keys in seen)
    assert set(a["history"][0]) == HISTORY_KEYS and a["resumed_from"] == 0
    assert set(a["opt_state"]) == {"m", "v", "step"} and int(a["opt_state"]["step"]) == 3
    after_a = _params(a)
    b = train(m, pipe.batch_at, opt, TrainConfig(steps=3))
    assert [h["loss"] for h in a["history"]] == [h["loss"] for h in b["history"]]
    for x, y in zip(after_a, _params(b)):
        assert torch.equal(x, y)
    c = train(m, pipe.batch_at, opt, TrainConfig(steps=3),
              generator=torch.Generator().manual_seed(5))
    assert c["history"][0]["loss"] != a["history"][0]["loss"]
    start = {k: v.detach().clone() for k, v in _flat(m.param_tree()).items()}
    d = train(m, pipe.batch_at, opt, TrainConfig(steps=1), params=_nest(start, lambda t: t))
    e = train(m, pipe.batch_at, opt, TrainConfig(steps=1),
              params=_nest(start, lambda t: t.numpy()))
    assert d["history"][0]["loss"] == e["history"][0]["loss"]


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launcher

    out = launcher.main(["--arch", "deepseek-7b", "--steps", "4", "--batch", "4", "--seq", "8",
                         "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                         "--accum", "2"])
    text = capsys.readouterr().out
    assert "step     0 loss=" in text and "done: loss" in text and "on cpu" in text
    assert len(out["history"]) == 4 and out["history"][0]["tokens"] == 16.0
    assert all(p.device.type == "cpu" for p in _flat(out["params"]).values())
    assert ckpt.list_steps(str(tmp_path)) == [2, 4]
    assert out["opt_state"]["m"]["embed"].dtype == torch.float32
    # --use-mesh trains under a one-rank host mesh, whose group it ends
    meshed = launcher.main(["--arch", "deepseek-7b", "--steps", "4", "--batch", "4", "--seq",
                            "8", "--device", "cpu", "--accum", "2", "--use-mesh"])
    assert [h["loss"] for h in meshed["history"]] == [h["loss"] for h in out["history"]]
    assert all(p.device.type == "cpu" for p in _flat(meshed["params"]).values())
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            launcher.main(["--arch", "deepseek-7b", "--steps", "1"])


def test_train_modules_import_no_jax():
    """``repro_torch.train``, the launchers, the mesh and the distributed
    training modules load neither ``jax`` nor the reference package."""
    code = ("import sys; import repro_torch.train.train_loop, repro_torch.train.checkpoint, "
            "repro_torch.launch.train, repro_torch.launch.steps, repro_torch.launch.mesh, "
            "repro_torch.distributed.sharding, repro_torch.distributed.compression; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
