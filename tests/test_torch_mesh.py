"""The port's mesh paths against the reference's, on ``("data", "model")``
meshes of shapes (2, 2), (1, 4) and (4, 1).

The reference runs on four fake XLA CPU devices in subprocesses (the device
count is fixed before JAX starts), one a mesh, all three started together;
its meshes are built with ``axis_types=Auto``, since ``jax.make_mesh``'s
default Explicit axes refuse the reference's sharding constraints (ROADMAP
Queue 3 item 14).  XLA compiles them with its backend optimisation off and
runs them on one thread each, to cut the compile time and leave the other
test workers their cores.  The port runs as one spawn of four gloo ranks on a
free loopback port (``tests/_torch_mesh_rank.py``, torch and the port
only), joined with a deadline, while the subprocesses run.  Every case
compares their outputs:

* (a) ``moe_apply`` in ``ag`` and ``ws`` at capacity factors 0.5 (drops
  within each data shard: capacity comes from the local token count) and
  8.0, top-2 routing with margins bf16 rounding cannot flip: the output and
  the gradient of a scalar of it in ``x`` and every weight.  ``ws`` sums the
  expert partials over the data axis, whose ranks hold other tokens, in
  both packages (Queue 3 item 15): it differs from ``ag`` at data > 1.
* (b) one ``train_loop.train`` step of the reduced chatglm3 and llama4
  (``auto``, which picks ``ws`` at data > 1, and ``REPRO_MOE_MODE=ag``):
  loss, grad norm and every parameter.
* (c) three ``make_compressed_dp_step`` steps over the (2, 2) mesh's data
  axis: metrics, parameters and the error-feedback state.
* (d) every rank's local parameter shapes against the reference's
  ``param_shardings``.

Tolerances are the compiled reference's of the LM tests, ``LM_TOL`` = 6e-2:
losses within it, the MoE's outputs and gradients within it of their
largest magnitude and norm, grad norms within ``LM_GRAD_RTOL`` (2e-2)
relative; parameters within 2.02·lr a step (a step moves a weight by ±lr
wherever its gradient is not zero, so a near-zero gradient whose sign the
packages' rounding sets differently parts them by 2·lr); error-feedback
states within one quantisation step of each other (each within half of one
of its gradient, ``max|g|/127``).
"""
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
from repro_torch.train import _tree

sys.path.insert(0, os.path.dirname(__file__))
from _torch_cases import LM_GRAD_RTOL  # noqa: E402
from _torch_mesh_rank import ARCH_MODES, MESHES  # noqa: E402

LM_TOL = 6e-2
LR = 1e-3              # _torch_mesh_rank.OPT's, the reference script's
DP_STEPS = 3
E, D, F, B, S = 4, 16, 16, 4, 16
TAGS = ["x".join(map(str, m)) for m in MESHES]
MOE_CASES = [(tag, mode, cf) for tag in TAGS for mode in ("ag", "ws") for cf in (0.5, 8.0)]

_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs.registry import ARCHS
from repro_torch.train import _tree
from repro.distributed.compression import init_error_state, make_compressed_dp_step
from repro.distributed.sharding import set_mesh
from repro.launch import steps as rsteps
from repro.models import LMModel
from repro.models.layers import moe_apply
from repro.train.optimizer import AdamWConfig, init_state
from repro.train.train_loop import TrainConfig, train

inp = dict(np.load(sys.argv[1]))
shape = tuple(int(a) for a in sys.argv[3].split("x"))
tag = sys.argv[3]
out = {}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


opt = AdamWConfig(lr=1e-3, state_dtype=jnp.float32, warmup_steps=1, total_steps=10)
bf = lambda k: jnp.asarray(inp[k], jnp.bfloat16)
x = bf("moe/x")
p = {k: bf(f"moe/{k}") for k in ("router", "wi0", "wi1", "wo")}
w = jnp.asarray(inp["moe/w"])
set_mesh(mesh_of(shape))
for mode in ("ag", "ws"):
    for cf in (0.5, 8.0):
        def f(x, p):
            y = moe_apply(x, p, top_k=2, capacity_factor=cf, act="swiglu", mode=mode)
            return jnp.sum(y.astype(jnp.float32) * w), y
        (_, y), (gx, gp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(x, p)
        key = f"moe/{tag}/{mode}/{cf}"
        out[f"{key}/out"] = np.asarray(y.astype(jnp.float32))
        out[f"{key}/grad/x"] = np.asarray(gx.astype(jnp.float32))
        for k, g in gp.items():
            out[f"{key}/grad/{k}"] = np.asarray(g.astype(jnp.float32))
for arch, mode in (("chatglm3-6b", "auto"), ("llama4-scout-17b-a16e", "auto"),
                   ("llama4-scout-17b-a16e", "ag")):
    m = LMModel(ARCHS[arch].reduced())
    params = m.init(jax.random.PRNGKey(0))
    if mode == "ag":
        os.environ["REPRO_MOE_MODE"] = "ag"
    try:
        batch = {"tokens": inp[f"train/{arch}/tokens"], "labels": inp[f"train/{arch}/labels"]}
        res = train(m, lambda s: batch, opt, TrainConfig(steps=1), params=params)
    finally:
        os.environ.pop("REPRO_MOE_MODE", None)
    key = f"train/{tag}/{arch}/{mode}"
    out[f"{key}/loss"] = np.float32(res["history"][0]["loss"])
    out[f"{key}/grad_norm"] = np.float32(res["history"][0]["grad_norm"])
    for k, v in flat(res["params"]):
        out[f"{key}/params/{k}"] = np.asarray(v)
    for k, s in flat(rsteps.param_shardings(m)):
        out[f"shapes/{tag}/{arch}/{k}"] = np.asarray(s.shard_shape(
            inp[f"init/{arch}/{k}"].shape))
set_mesh(None)
if shape == (2, 2):
    m = LMModel(ARCHS["chatglm3-6b"].reduced())
    params = m.init(jax.random.PRNGKey(0))
    step = make_compressed_dp_step(m, opt, mesh_of(shape))
    state, err = init_state(params, opt), init_error_state(params)
    for i in range(3):
        batch = {k: jnp.asarray(inp[f"dp/{i}/{k}"]) for k in ("tokens", "labels")}
        params, state, err, met = step(params, state, err, batch)
        for k, v in met.items():
            out[f"dp/{i}/{k}"] = np.asarray(v)
    for k, v in flat(params):
        out[f"dp/params/{k}"] = np.asarray(v)
    for k, v in flat(err):
        out[f"dp/err/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def _inputs(path) -> None:
    """The cases' inputs, made with numpy from a seed, and the reference's
    initial parameters of both reduced archs."""
    from repro.models import LMModel

    rng = np.random.default_rng(0)
    inp = {}
    # top-2 routing with clear margins: each token leans on its first expert
    # by 2 and its second by 1 along the router's own directions; half the
    # tokens go first to expert 0, which overflows at capacity factor 0.5
    first = rng.integers(0, E, (B, S))
    first[:, : S // 2] = 0
    second = (first + 1 + rng.integers(0, E - 1, (B, S))) % E
    x = rng.standard_normal((B, S, D)) * 0.1
    x[..., :E] += 2.0 * np.eye(E)[first] + np.eye(E)[second]
    router = rng.standard_normal((D, E)) * 0.1
    router[:E] += 3.0 * np.eye(E)
    inp["moe/x"], inp["moe/router"] = x.astype(np.float32), router.astype(np.float32)
    for k, shape in (("wi0", (E, D, F)), ("wi1", (E, D, F)), ("wo", (E, F, D))):
        inp[f"moe/{k}"] = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    inp["moe/w"] = rng.standard_normal((B, S, D)).astype(np.float32)
    for arch in sorted({a for a, _ in ARCH_MODES}):
        r = ARCHS[arch].reduced()
        for k, v in _tree.items(LMModel(r).init(jax.random.PRNGKey(0))):
            inp[f"init/{arch}/{k}"] = np.asarray(v)
        inp[f"train/{arch}/tokens"] = rng.integers(0, r.vocab, (B, S)).astype(np.int32)
        labels = rng.integers(0, r.vocab, (B, S)).astype(np.int32)
        labels[0, :3] = -1
        inp[f"train/{arch}/labels"] = labels
    vocab = ARCHS["chatglm3-6b"].reduced().vocab
    for i in range(DP_STEPS):
        for k in ("tokens", "labels"):
            inp[f"dp/{i}/{k}"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
    np.savez(path, **inp)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, each gloo rank's outputs)."""
    import torch.multiprocessing as mp

    from _torch_mesh_rank import rank_main

    d = tmp_path_factory.mktemp("mesh")
    inp = d / "inp.npz"
    _inputs(inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    refs = [subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, str(inp), str(d / f"ref{t}.npz"),
                              t], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for t in TAGS]
    ctx = mp.start_processes(rank_main, args=(4, _free_port(), str(inp), str(d)),
                             nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail("the gloo ranks did not finish in 240 s")
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


def _rows(ranks, tag: str, key: str) -> np.ndarray:
    """A per-rank rows output gathered whole: the ranks of model column 0,
    in data order (the other columns hold the same rows)."""
    data, model = (int(a) for a in tag.split("x"))
    return np.concatenate([ranks[i * model][key] for i in range(data)])


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("tag,mode,cf", MOE_CASES)
def test_moe_apply_matches_reference(runs, tag, mode, cf):
    ref, ranks = runs
    key = f"moe/{tag}/{mode}/{cf}"
    got, want = _rows(ranks, tag, f"{key}/out"), ref[f"{key}/out"]
    assert np.abs(got - want).max() <= LM_TOL * np.abs(want).max()
    assert _rel(_rows(ranks, tag, f"{key}/grad/x"), ref[f"{key}/grad/x"]) <= LM_TOL
    for name in ("router", "wi0", "wi1", "wo"):
        for r in ranks:   # every rank's gradient, gathered whole, is the same
            np.testing.assert_array_equal(r[f"{key}/grad/{name}"], ranks[0][f"{key}/grad/{name}"])
        assert _rel(ranks[0][f"{key}/grad/{name}"], ref[f"{key}/grad/{name}"]) <= LM_TOL, name
    if cf == 0.5:   # some token's rows dropped, as in the reference
        assert ((got == 0).all(-1) == (want == 0).all(-1)).all() and (want == 0).all(-1).any()


@pytest.mark.parametrize("tag", TAGS)
def test_ws_mixes_tokens_across_data_ranks(runs, tag):
    """``ws`` sums the expert partials over the data axis, whose ranks hold
    other tokens: at data > 1 it is another function than ``ag`` (which is
    the no-mesh one), in both packages alike; at data = 1 the two agree."""
    ref, ranks = runs
    data = int(tag.split("x")[0])
    for cf in (0.5, 8.0):
        key = f"moe/{tag}/{{}}/{cf}/out"
        gap_ref = np.abs(ref[key.format("ws")] - ref[key.format("ag")]).max()
        ws, ag = (_rows(ranks, tag, key.format(m)) for m in ("ws", "ag"))
        gap = np.abs(ws - ag).max()
        scale = np.abs(ref[key.format("ag")]).max()
        if data > 1:
            assert gap_ref > 0.2 * scale and gap > 0.2 * scale
        else:
            assert gap_ref <= LM_TOL * scale and gap == 0


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("arch,mode", ARCH_MODES)
def test_train_step_matches_reference(runs, tag, arch, mode):
    ref, ranks = runs
    key = f"train/{tag}/{arch}/{mode}"
    got = ranks[0]
    assert abs(got[f"{key}/loss"] - float(ref[f"{key}/loss"])) <= LM_TOL
    assert got[f"{key}/grad_norm"] == pytest.approx(float(ref[f"{key}/grad_norm"]),
                                                    rel=LM_GRAD_RTOL)
    names = [k for k in ref if k.startswith(f"{key}/params/")]
    assert names and len(names) == len([k for k in got if k.startswith(f"{key}/params/")])
    for k in names:
        for r in ranks:
            np.testing.assert_array_equal(r[k], got[k])
            assert r[f"{key}/loss"] == got[f"{key}/loss"]
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2.02 * LR, err_msg=k)


@pytest.mark.parametrize("tag", TAGS)
def test_ws_train_step_differs_from_ag(runs, tag):
    """Under ``auto`` the reduced llama4 trains through ``ws``, which at
    data > 1 is another function (its loss off the ``ag`` step's, in both
    packages); at data = 1 ``auto`` is the ``ag`` step."""
    ref, ranks = runs
    data = int(tag.split("x")[0])
    key = f"train/{tag}/llama4-scout-17b-a16e/{{}}/loss"
    gap_ref = abs(float(ref[key.format("auto")]) - float(ref[key.format("ag")]))
    gap = abs(ranks[0][key.format("auto")] - ranks[0][key.format("ag")])
    if data > 1:
        assert gap_ref > 5e-3 and gap > 5e-3
    else:
        assert gap_ref <= 1e-3 and gap == 0


def test_compressed_dp_step_matches_reference(runs):
    ref, ranks = runs
    got = ranks[0]
    for i in range(DP_STEPS):
        assert abs(got[f"dp/{i}/loss"] - float(ref[f"dp/{i}/loss"])) <= LM_TOL
        assert got[f"dp/{i}/grad_norm"] == pytest.approx(float(ref[f"dp/{i}/grad_norm"]),
                                                         rel=LM_GRAD_RTOL)
        assert got[f"dp/{i}/tokens"] == float(ref[f"dp/{i}/tokens"])
        assert np.float32(got[f"dp/{i}/lr"]) == ref[f"dp/{i}/lr"]
    for k in (k for k in ref if k.startswith("dp/params/")):
        for r in ranks:
            np.testing.assert_array_equal(r[k], got[k])
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2.02 * LR * DP_STEPS, err_msg=k)
    for k in (k for k in ref if k.startswith("dp/err/")):
        quantum = 2 * np.abs(ref[k]).max()
        assert np.abs(got[k]).max() <= 1.01 * quantum, k
        assert np.abs(got[k] - ref[k]).max() <= 1.01 * quantum, k


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("arch", sorted({a for a, _ in ARCH_MODES}))
def test_local_shapes_match_param_shardings(runs, tag, arch):
    """Each rank holds only its shards, of the shape the reference's
    ``param_shardings`` gives every device."""
    ref, ranks = runs
    names = [k for k in ref if k.startswith(f"shapes/{tag}/{arch}/")]
    assert names
    for r in ranks:
        for k in names:
            assert r[k] == tuple(int(a) for a in ref[k]), k
            leaf = k[len("shapes/"):]
            assert r[f"placements/{leaf}"] == r[f"shardings/{leaf}"], k
