"""Dense tensor parallelism over ``model`` against the reference, on
``("data", "model")`` meshes of shapes (2, 2) and (1, 4).

The reference runs on four fake XLA CPU devices in two subprocesses, one a
mesh (Auto axes, backend optimisation off, one thread each), as in
``tests/test_torch_mesh.py``; its parameters are laid out by
``param_shardings``, its batch and caches by ``batch_shardings`` and
``cache_shardings``, and its steps are jitted.  The port runs as one spawn
of four gloo ranks (``tests/_torch_tp_rank.py``) at the same time.  Archs:
the reduced chatglm3 (with the reference smoke's ``tp=2``, 4 query heads
and 2 KV heads: on (1, 4) a rank takes the KV head its query head reads),
arctic (MoE with its dense residual; its router zeroed, so that every
token's top-2 ties exactly and both packages route it to experts 0 and 1:
with a random router some token's gates sit within rounding of a tie, and
the packages' roundings, which differ under a mesh, route it apart),
falcon-mamba and hymba.  Every case
compares the two packages on the same parameters and inputs:

* the forward logits, each rank's rows and vocabulary columns, within
  ``LM_TOL`` (6e-2, the compiled reference's tolerance of the LM tests);
* the loss within ``LM_TOL`` and every gradient within ``LM_GRAD_RTOL`` of
  its norm (``_torch_cases.grad_errors``), or, where the reference's own
  compiled gradient on the mesh is farther than that from its compiled
  gradient without one, within that distance: the reference's rounding on
  the mesh (hymba's ``dt`` path on (1, 4) moves by about twice
  ``LM_GRAD_RTOL`` between the reference's two runs);
* one train step (float32 moments): loss and grad norm, and every parameter
  within 2.02·lr, as in ``tests/test_torch_mesh.py``;
* a prefill's last logits and its cache (each rank's rows, KV heads and
  channels), and a decode step on that cache;
* on (2, 2), a B = 1 decode step on a cache from the inputs whose window is
  split over ``data`` (each rank's slots), chatglm3 and hymba (a sliding
  window);
* each rank's local shapes: H/m query heads and d_inner/m mamba channels in
  the computation, V/m logits, the weights' compute pieces, and its stored
  shards against the reference's ``param_shardings``.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from repro.configs.registry import ARCHS

sys.path.insert(0, os.path.dirname(__file__))
from _torch_cases import LM_GRAD_RTOL, grad_errors  # noqa: E402
from _torch_tp_rank import (ARCH_NAMES, B, B1_ARCHS, B1_POS, DEC_POS, MESHES,  # noqa: E402
                            S)
from repro_torch.train import _tree  # noqa: E402

LM_TOL = 6e-2
LR = 1e-3              # _torch_tp_rank.OPT's, the reference script's
TAGS = ["x".join(map(str, m)) for m in MESHES]
B1_WINDOW = 16         # the B = 1 cache's slots (hymba: its sliding window)

_REF_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs.base import ShapeSpec
from repro.configs.registry import ARCHS
from repro.distributed.sharding import set_mesh
from repro.launch import steps as rsteps
from repro.models import LMModel
from repro.train.optimizer import AdamWConfig, init_state

inp = dict(np.load(sys.argv[1]))
tag = sys.argv[3]
shape = tuple(int(a) for a in tag.split("x"))
B, S, DEC_POS = (int(a) for a in sys.argv[4].split(","))
b1 = dict(a.split("=") for a in sys.argv[5].split(",")) if shape[0] > 1 else {}
mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
set_mesh(mesh)
opt = AdamWConfig(lr=1e-3, state_dtype=jnp.float32, warmup_steps=1, total_steps=10)
out = {}


def tree_of(arch):
    tree = {"blocks": {}}
    for k, v in inp.items():
        if k.startswith(f"init/{arch}/"):
            name = k[len(f"init/{arch}/"):]
            if name.startswith("blocks/"):
                tree["blocks"][name[len("blocks/"):]] = jnp.asarray(v)
            else:
                tree[name] = jnp.asarray(v)
    return tree


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


for arch in sys.argv[6].split(","):
    cfg = ARCHS[arch].reduced()
    if arch == "chatglm3-6b":
        cfg = dataclasses.replace(cfg, tp=2)
    m = LMModel(cfg)
    ps = rsteps.param_shardings(m)
    params = jax.device_put(tree_of(arch), ps)
    bsh = rsteps.batch_shardings(cfg, ShapeSpec("t", S, B, "train"))
    batch = jax.device_put({k: jnp.asarray(inp[f"batch/{arch}/{k}"]) for k in ("tokens", "labels")},
                           {k: bsh[k] for k in ("tokens", "labels")})
    key = f"{tag}/{arch}"
    set_mesh(None)
    plain = {k: jnp.asarray(inp[f"batch/{arch}/{k}"]) for k in ("tokens", "labels")}
    _, grads = jax.jit(jax.value_and_grad(m.loss, has_aux=True))(tree_of(arch), plain)
    for k, g in flat(grads):
        out[f"{key}/grad_no_mesh/{k}"] = f32(g)
    set_mesh(mesh)
    out[f"{key}/logits"] = f32(jax.jit(lambda p, b: m.forward(p, b))(params, batch))
    (loss, _), grads = jax.jit(jax.value_and_grad(m.loss, has_aux=True))(params, batch)
    out[f"{key}/loss"] = np.float32(loss)
    for k, g in flat(grads):
        out[f"{key}/grad/{k}"] = f32(g)
    for k, s in flat(ps):
        out[f"{key}/shard/{k}"] = np.asarray(s.shard_shape(inp[f"init/{arch}/{k}"].shape))
    cache, last = jax.jit(lambda p, b: m.prefill(p, b, max_len=S + 2))(
        params, {"tokens": batch["tokens"]})
    out[f"{key}/prefill/logits"] = f32(last)
    for k, v in cache.items():
        out[f"{key}/prefill/cache/{k}"] = f32(v)
    tok = jnp.asarray(inp[f"batch/{arch}/decode"])
    _, dec = jax.jit(m.decode_step)(params, cache, tok, jnp.int32(DEC_POS))
    out[f"{key}/decode/logits"] = f32(dec)
    if arch in b1:
        csh = rsteps.cache_shardings(cfg, 1)
        c1 = {}
        for k in csh:
            v = inp[f"b1/{arch}/cache/{k}"]
            v = jnp.asarray(v.view(jnp.bfloat16) if v.dtype == np.int16 else v)
            c1[k] = jax.device_put(v, csh[k])
        step = jax.jit(m.decode_step, in_shardings=(ps, csh, None, None))
        _, dec1 = step(params, c1, jnp.asarray(inp[f"b1/{arch}/token"]), jnp.int32(int(b1[arch])))
        out[f"{key}/b1/logits"] = f32(dec1)
    train = jax.jit(rsteps.make_train_step(m, opt))
    new, _, met = train(params, init_state(params, opt), batch)
    out[f"{key}/step/loss"] = np.float32(met["loss"])
    out[f"{key}/step/grad_norm"] = np.float32(met["grad_norm"])
    for k, v in flat(new):
        out[f"{key}/step/params/{k}"] = f32(v)
np.savez(sys.argv[2], **out)
"""


def _cfg(arch):
    cfg = ARCHS[arch].reduced()
    return dataclasses.replace(cfg, tp=2) if arch == "chatglm3-6b" else cfg


def _inputs(path) -> None:
    """The reference's initial parameters of every arch, batches, decode
    tokens and the B = 1 caches, made with numpy from a seed."""
    from repro.models import LMModel

    rng = np.random.default_rng(0)
    inp = {}
    for arch in ARCH_NAMES:
        cfg = _cfg(arch)
        for k, v in _tree.items(LMModel(cfg).init(jax.random.PRNGKey(0))):
            inp[f"init/{arch}/{k}"] = np.asarray(v)
        if cfg.has_moe:
            # every gate ties exactly: each token's top-2 is experts 0 and 1 in
            # both packages; a random router leaves some token's gates within
            # rounding of a tie, which the two packages then break apart
            inp[f"init/{arch}/blocks/moe.router"] = np.zeros_like(
                inp[f"init/{arch}/blocks/moe.router"])
        for k in ("tokens", "labels"):
            inp[f"batch/{arch}/{k}"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        inp[f"batch/{arch}/labels"][0, :3] = -1
        inp[f"batch/{arch}/decode"] = rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
        if arch in B1_ARCHS:
            L = cfg.n_layers
            W = min(B1_WINDOW, cfg.swa_window) if cfg.swa_window else B1_WINDOW
            bf16 = lambda a: np.asarray(jax.numpy.asarray(a, jax.numpy.bfloat16)).view(np.int16)
            for k in ("k", "v"):
                inp[f"b1/{arch}/cache/{k}"] = bf16(rng.standard_normal(
                    (L, 1, W, cfg.n_kv_padded, cfg.hd)).astype(np.float32))
            if cfg.has_mamba:
                inp[f"b1/{arch}/cache/ssm"] = (0.1 * rng.standard_normal(
                    (L, 1, cfg.d_inner, cfg.ssm_state))).astype(np.float32)
                inp[f"b1/{arch}/cache/conv"] = bf16(rng.standard_normal(
                    (L, 1, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32))
            inp[f"b1/{arch}/token"] = rng.integers(0, cfg.vocab, (1,)).astype(np.int32)
    np.savez(path, **inp)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, each gloo rank's outputs)."""
    import torch.multiprocessing as mp

    from _torch_tp_rank import rank_main

    d = tmp_path_factory.mktemp("tp")
    inp = d / "inp.npz"
    _inputs(inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    b1 = ",".join(f"{a}={B1_POS[a]}" for a in B1_ARCHS)
    # one subprocess a mesh, both at once with the ranks
    refs = [subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, str(inp), str(d / f"ref{t}.npz"),
                              t, f"{B},{S},{DEC_POS}", b1, ",".join(ARCH_NAMES)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for t in TAGS]
    ctx = mp.start_processes(rank_main, args=(4, _free_port(), str(inp), str(d)),
                             nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail("the gloo ranks did not finish in 300 s")
        for proc in refs:
            _, err = proc.communicate(timeout=max(deadline - time.monotonic(), 1))
            assert proc.returncode == 0, err[-3000:]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for proc in refs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = {}
    for t in TAGS:
        ref.update(np.load(d / f"ref{t}.npz"))
    ranks = []
    for r in range(4):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


def _mesh(tag):
    return tuple(int(a) for a in tag.split("x"))


def _piece(want, tag, rank, row_dim=0, col_dim=None):
    """Rank ``rank``'s piece of a whole reference array: its rows (split over
    ``data``) along ``row_dim``, its columns (split over ``model``) along
    ``col_dim``."""
    data, model = _mesh(tag)
    i, j = divmod(rank, model)
    if row_dim is not None:
        want = np.array_split(want, data, axis=row_dim)[i]
    if col_dim is not None:
        want = np.array_split(want, model, axis=col_dim)[j]
    return want


def _close(got, want, tol=LM_TOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err
    return err


CASES = [(t, a) for t in TAGS for a in ARCH_NAMES]


@pytest.mark.parametrize("tag,arch", CASES)
def test_forward_logits_match_reference(runs, tag, arch):
    """Each rank holds its rows and its V/m vocabulary columns."""
    ref, ranks = runs
    key = f"{tag}/{arch}"
    V = _cfg(arch).vocab_padded
    for r, got in enumerate(ranks):
        assert got[f"{key}/logits"].shape[-1] == V // _mesh(tag)[1]
        _close(got[f"{key}/logits"], _piece(ref[f"{key}/logits"], tag, r, 0, 2))


@pytest.mark.parametrize("tag,arch", CASES)
def test_loss_and_every_gradient_match_reference(runs, tag, arch):
    ref, ranks = runs
    key = f"{tag}/{arch}"
    got = ranks[0]
    assert abs(got[f"{key}/loss"] - float(ref[f"{key}/loss"])) <= LM_TOL
    names = [k[len(f"{key}/grad/"):] for k in ref if k.startswith(f"{key}/grad/")]
    assert names
    for r in ranks:
        assert r[f"{key}/loss"] == got[f"{key}/loss"]
        for k in names:
            np.testing.assert_array_equal(r[f"{key}/grad/{k}"], got[f"{key}/grad/{k}"])
    want = {k: ref[f"{key}/grad/{k}"] for k in names}
    errs = grad_errors({k: got[f"{key}/grad/{k}"] for k in names}, want)
    own = grad_errors({k: ref[f"{key}/grad_no_mesh/{k}"] for k in names}, want)
    bad = {k: e for k, e in errs.items() if e[0] > max(e[1], own[k][0])}
    assert not bad, bad


@pytest.mark.parametrize("tag,arch", CASES)
def test_train_step_matches_reference(runs, tag, arch):
    ref, ranks = runs
    key = f"{tag}/{arch}/step"
    got = ranks[0]
    assert abs(got[f"{key}/loss"] - float(ref[f"{key}/loss"])) <= LM_TOL
    assert got[f"{key}/grad_norm"] == pytest.approx(float(ref[f"{key}/grad_norm"]),
                                                    rel=LM_GRAD_RTOL)
    names = [k for k in ref if k.startswith(f"{key}/params/")]
    assert names
    for k in names:
        for r in ranks:
            np.testing.assert_array_equal(r[k], got[k])
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2.02 * LR, err_msg=k)


@pytest.mark.parametrize("tag,arch", CASES)
def test_prefill_cache_and_decode_match_reference(runs, tag, arch):
    """The prefill's last logits and its cache, each rank's rows and KV
    heads (the KV head its query heads read where m does not divide them)
    and mamba channels; then a decode step on that cache."""
    ref, ranks = runs
    key = f"{tag}/{arch}"
    cfg = _cfg(arch)
    data, model = _mesh(tag)
    for r, got in enumerate(ranks):
        _close(got[f"{key}/prefill/logits"], _piece(ref[f"{key}/prefill/logits"], tag, r, 0, 1))
        _close(got[f"{key}/decode/logits"], _piece(ref[f"{key}/decode/logits"], tag, r, 0, 1))
        for k in ("k", "v", "ssm", "conv"):
            if f"{key}/prefill/cache/{k}" not in ref:
                continue
            want = ref[f"{key}/prefill/cache/{k}"]
            if k in ("k", "v") and cfg.n_kv_padded % model:
                want = _piece(want, tag, r, 1, None)
                H, KV = cfg.n_heads_padded, cfg.n_kv_padded
                kv = (r % model) * (H // model) // (H // KV)
                want = want[:, :, :, kv:kv + 1]
            else:
                want = _piece(want, tag, r, 1, {"k": 3, "v": 3, "ssm": 2, "conv": 3}[k])
            _close(got[f"{key}/prefill/cache/{k}"], want)


@pytest.mark.parametrize("arch", B1_ARCHS)
def test_b1_decode_with_window_split_over_data(runs, arch):
    """B = 1 cannot cover ``data``: the cache's window is split over it (each
    rank its consecutive slots), and the ranks' softmax partials combine to
    the reference's logits."""
    ref, ranks = runs
    key = f"2x2/{arch}"
    cfg = _cfg(arch)
    W = min(B1_WINDOW, cfg.swa_window) if cfg.swa_window else B1_WINDOW
    assert B1_POS[arch] >= W // 2   # the new token's slot lies on the second data rank
    for r, got in enumerate(ranks):
        assert got[f"{key}/b1/window"] == W // 2
        _close(got[f"{key}/b1/logits"], _piece(ref[f"{key}/b1/logits"], "2x2", r, None, 1))


@pytest.mark.parametrize("tag,arch", CASES)
def test_each_rank_computes_its_share(runs, tag, arch):
    """H/m query heads (their KV heads), d_inner/m channels and the weights'
    compute pieces; the stored shards are the reference's
    ``param_shardings``' shard shapes."""
    ref, ranks = runs
    key = f"{tag}/{arch}"
    cfg = _cfg(arch)
    m = _mesh(tag)[1]
    d, hd = cfg.d_model, cfg.hd
    want = {}
    if cfg.has_attn:
        H, KV = cfg.n_heads_padded // m, max(cfg.n_kv_padded // m, 1)
        want.update({"attn.wq": (d, H * hd), "attn.wk": (d, KV * hd), "attn.wv": (d, KV * hd),
                     "attn.wo": (H * hd, d)})
    if cfg.has_mamba:
        di = cfg.d_inner // m
        want.update({"mamba.in_proj": (d, 2 * di), "mamba.conv_b": (di,),
                     "mamba.x_proj": (di, cfg.dt_rank + 2 * cfg.ssm_state),
                     "mamba.dt_proj": (cfg.dt_rank, di), "mamba.out_proj": (di, d)})
    ff = "dense" if cfg.has_moe else "mlp"
    f = (cfg.moe_dense_ff if cfg.has_moe else cfg.d_ff) // m
    if f:
        want.update({f"{ff}.wi0": (d, f), f"{ff}.wo": (f, d)})
    shards = [k[len(f"{key}/shard/"):] for k in ref if k.startswith(f"{key}/shard/")]
    assert shards
    for got in ranks:
        pieces = got[f"{key}/pieces"]
        for k, s in want.items():
            assert pieces[k] == s, (k, pieces[k], s)
        probe = got[f"{key}/probe"]
        if cfg.has_attn:
            assert (probe["q_heads"], probe["kv_heads"]) == (H, KV)
        if cfg.has_mamba:
            assert probe["channels"] == cfg.d_inner // m
        for k in shards:
            assert got[f"{key}/shard/{k}"] == tuple(int(a) for a in ref[f"{key}/shard/{k}"]), k
