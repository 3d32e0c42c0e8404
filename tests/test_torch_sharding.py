"""The port's mesh rules, mesh builders, sharding helpers, gradient
compression and re-mesh (``repro_torch.distributed.sharding``,
``repro_torch.distributed.compression``, ``repro_torch.launch.mesh``,
``repro_torch.launch.steps``' shardings, ``train_loop.reshard``) against the
reference's, in process on the CPU.

* ``spec``, ``named_sharding``, ``rules_for_mesh``, ``param_specs`` and the
  steps' shardings of every arch at its published size (parameter tables
  only, nothing materialised), on a one-device JAX mesh (Auto axes) against
  a one-rank gloo mesh of the same axis names; ``constrain`` is a no-op
  without a mesh.
* ``make_production_mesh`` at both shapes under torch's fake process group
  (world 256 and 512), in a subprocess so that no test worker keeps a
  global group.
* ``quantize``/``dequantize`` bit for bit; the reference's EF-SGD
  convergence test on the port; the compressed step on a one-rank group bit
  for bit against the plain step's update on the round-tripped gradient.
* ``reshard``; ``--use-mesh`` and a mesh run's checkpoint on the CPU, bit
  for bit against the run without a mesh (on one rank every collective is
  the identity).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import base as rbase
from repro.configs.registry import ARCHS as RARCHS
from repro.distributed import compression as rcomp
from repro.distributed import sharding as rsh
from repro.launch import steps as rsteps
from repro.models import LMModel as RModel
from repro.train import optimizer as ropt
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LMModel
from repro_torch.train import _tree
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_state
from repro_torch.train.train_loop import TrainConfig, reshard, train

AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}


@pytest.fixture(scope="module")
def host_mesh():
    """A one-rank gloo ``("data", "model")`` mesh, its group ended after the
    module."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    tsh.set_mesh(None)
    if started:
        dist.destroy_process_group()


@pytest.fixture
def meshes(host_mesh):
    """{kind: (the reference's one-device mesh, the port's one-rank mesh)}."""
    from torch.distributed.device_mesh import init_device_mesh

    out = {}
    for kind, names in AXES.items():
        jm = jax.make_mesh((1,) * len(names), names,
                           axis_types=(jax.sharding.AxisType.Auto,) * len(names))
        tm = host_mesh if kind == "single" else init_device_mesh(
            "cpu", (1,) * len(names), mesh_dim_names=names)
        out[kind] = (jm, tm)
    yield out
    rsh.set_mesh(None)
    tsh.set_mesh(None)


def _entries(p) -> tuple:
    """A PartitionSpec's entries as the port gives them: a tuple of mesh
    axes or ``None`` per dim (the reference writes a lone axis bare)."""
    return tuple(e if e is None or isinstance(e, tuple) else (e,) for e in p)


def _placements_of(ns, names) -> tuple:
    """The DTensor placements a reference ``NamedSharding`` means."""
    if ns is None:
        return None
    spec = _entries(ns.spec)
    return tuple(next((Shard(i) for i, e in enumerate(spec) if e and a in e), Replicate())
                 for a in names)


LOGICAL = [(), (None,), ("batch", None, None), ("fsdp", "tp"), ("tp", None, "fsdp"),
           (None, "batch", None, "tp", None), ("batch", None, "tp")]


@pytest.mark.parametrize("kind", sorted(AXES))
def test_rules_spec_and_named_sharding_match_reference(meshes, kind):
    jm, tm = meshes[kind]
    assert tsh.rules_for_mesh(tm) == tsh.MeshRules(**vars(rsh.rules_for_mesh(jm)))
    rsh.set_mesh(jm)
    tsh.set_mesh(tm)
    assert tsh.get_mesh() is tm and tsh.rules() == tsh.rules_for_mesh(tm)
    for logical in LOGICAL:
        assert tsh.spec(*logical) == _entries(rsh.spec(*logical)), logical
        assert tsh.named_sharding(*logical) == _placements_of(
            rsh.named_sharding(*logical), AXES[kind]), logical


def test_no_mesh_spec_and_constrain_are_no_ops():
    tsh.set_mesh(None)
    x = torch.ones(2, 3)
    assert tsh.spec("batch", None) == () and tsh.named_sharding("batch") is None
    assert tsh.constrain(x, "batch", None) is x
    assert tsh.rules() is None


@pytest.mark.parametrize("kind", sorted(AXES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_and_shardings_match_reference(meshes, kind, arch):
    """Every arch at its published size: ``param_specs`` entry by entry and
    the steps' parameter, optimizer, batch and cache shardings."""
    jm, tm = meshes[kind]
    names = AXES[kind]
    rsh.set_mesh(jm)
    tsh.set_mesh(tm)
    rm = RModel(RARCHS[arch])
    tm_model = LMModel(ARCHS[arch], device="meta", generator=torch.Generator())
    want = dict(_tree.items(rm.param_specs()))
    got = dict(_tree.items(tm_model.param_specs()))
    assert set(got) == set(want)
    for k, spec in want.items():
        assert got[k] == _entries(spec), k
    want_sh = {k: _placements_of(v, names) for k, v in _tree.items(rsteps.param_shardings(rm))}
    assert dict(_tree.items(tsteps.param_shardings(tm_model))) == want_sh
    opt = dict(_tree.items(tsteps.opt_state_shardings(tm_model)))
    ropt = dict(_tree.items(rsteps.opt_state_shardings(rm)))
    assert opt == {k: _placements_of(v, names) for k, v in ropt.items()}
    for shape in tbase.runnable_cells(ARCHS[arch]):
        rshape = rbase.SHAPES[shape.name]
        got_b = dict(_tree.items(tsteps.batch_shardings(ARCHS[arch], shape)))
        want_b = dict(_tree.items(rsteps.batch_shardings(RARCHS[arch], rshape)))
        assert got_b == {k: _placements_of(v, names) for k, v in want_b.items()}, shape.name


def test_abstract_opt_state_matches_reference():
    r = ARCHS["llama4-scout-17b-a16e"]
    got = tsteps.abstract_opt_state(LMModel(r, device="meta", generator=torch.Generator()),
                                    AdamWConfig())
    want = rsteps.abstract_opt_state(RModel(RARCHS[r.name]), ropt.AdamWConfig())
    g, w = dict(_tree.items(got)), dict(_tree.items(want))
    assert set(g) == set(w)
    for k in w:
        assert g[k].device.type == "meta" and tuple(g[k].shape) == tuple(w[k].shape), k
        assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), k


_FAKE_SCRIPT = r"""
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import LMModel


def fake_group(world):
    # torch's fake process group: one process stands for every rank.  Its
    # store is a private testing class, pinned here and nowhere else.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


for multi_pod, world in ((False, 256), (True, 512)):
    fake_group(world)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert mesh.mesh_dim_names == names, mesh.mesh_dim_names
    assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16)), mesh.shape
    sharding.set_mesh(mesh)
    data = ("pod", "data") if multi_pod else ("data",)
    assert sharding.rules() == sharding.MeshRules(batch=data, fsdp=data, tp=("model",))
    import torch
    m = LMModel(ARCHS["llama4-scout-17b-a16e"], device="meta", generator=torch.Generator())
    sh = steps.param_shardings(m)
    assert sh["blocks"]["moe.wi0"] == (Shard(3),) * (len(names) - 1) + (Shard(1),)
    assert sh["embed"] == (Shard(1),) * (len(names) - 1) + (Shard(0),)
    # a batch the data axes divide is sharded by rows; long_500k's single
    # row is not, and its KV window is sequence-sharded over them instead
    cfg = ARCHS["falcon-mamba-7b"]
    cache = steps.cache_shardings(cfg, 1)
    assert set(cache) == {"conv", "ssm"}
    assert cache["ssm"] == (Replicate(),) * (len(names) - 1) + (Shard(2),)
    kv = steps.cache_shardings(ARCHS["hymba-1.5b"], 1)["k"]
    assert kv == (Shard(2),) * (len(names) - 1) + (Shard(3),), kv
    kv = steps.cache_shardings(ARCHS["hymba-1.5b"], 256)["k"]
    assert kv == (Shard(1),) * (len(names) - 1) + (Shard(3),), kv
    assert steps._batch_axes_for(32) == data and steps._batch_axes_for(8) is None
    assert steps._batch_axes_for(16) == ("data",)
    assert steps.batch_shardings(cfg, SHAPES["train_4k"])["tokens"] == \
        (Shard(0),) * (len(names) - 1) + (Replicate(),)
    sharding.set_mesh(None)
    dist.destroy_process_group()
print("ok")
"""


def test_production_meshes_under_the_fake_group():
    """``make_production_mesh`` builds (16, 16) over 256 ranks and (2, 16, 16)
    over 512, and the rules, parameter and cache shardings read them as the
    reference's do (the sequence-sharded KV window of a batch of one)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    r = subprocess.run([sys.executable, "-c", _FAKE_SCRIPT], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stdout + r.stderr[-3000:]


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _leaves(rng):
    g = rng.standard_normal((64, 48)).astype(np.float32)
    ties = (np.arange(-254, 255, dtype=np.float32) / 2.0)   # x.5 multiples of the scale
    return {
        "random": g,
        "with_zero": np.where(rng.random(g.shape) < 0.2, 0, g).astype(np.float32),
        "all_zero": np.zeros((7, 5), np.float32),
        "plus_minus_max": np.array([-3.0, 3.0, 1.5, -1.5, 0.0], np.float32),
        "halves": ties * (np.float32(127.0) / np.float32(127.0)),
        "tiny": (g * 1e-30).astype(np.float32),
        "scalar": np.array(-0.25, np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_bitwise(dtype):
    for name, a in _leaves(np.random.default_rng(5)).items():
        jg = jnp.asarray(a, getattr(jnp, dtype))
        tg = torch.from_numpy(np.array(a)).to(getattr(torch, dtype))
        rq, rs = rcomp.quantize(jg)
        tq, ts = tcomp.quantize(tg)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq), err_msg=name)
        assert ts.numpy().tobytes() == np.asarray(rs).tobytes(), name
        np.testing.assert_array_equal(tcomp.dequantize(tq, ts).numpy(),
                                      np.asarray(rcomp.dequantize(rq, rs)), err_msg=name)


def test_quantize_roundtrip_and_sign():
    """The reference's two numerics tests on the port."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(256, 64)).astype(np.float32))
    q, scale = tcomp.quantize(g)
    assert (tcomp.dequantize(q, scale) - g).abs().max() <= float(scale) * 0.5 + 1e-6
    dq = tcomp.dequantize(*tcomp.quantize(torch.tensor([[-1.0, 0.0, 1.0, 0.5]])))
    assert dq[0, 1] == 0.0 and dq[0, 0] < 0 < dq[0, 2]


def test_compress_tree_and_error_state():
    tree = {"b": torch.ones(3), "a": {"x": -torch.ones(2, 2)}}
    qs, scales, paths = tcomp.compress_tree(tree)
    assert paths == ["a/x", "b"]
    assert [q.tolist() for q in qs] == [[[-127, -127], [-127, -127]], [127, 127, 127]]
    assert [float(s) for s in scales] == [np.float32(1 / 127.0)] * 2
    err = tcomp.init_error_state(tree)
    assert err["a"]["x"].dtype == torch.float32 and not err["b"].any()


def test_error_feedback_converges_sgd():
    """The reference's EF-SGD test on the port: the compressed path reaches
    the optimum of a quadratic."""
    rng = np.random.default_rng(0)
    w_true = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    X = torch.from_numpy(rng.normal(size=(256, 32)).astype(np.float32))
    y = X @ w_true

    def loss(w):
        return torch.mean((X @ w - y) ** 2)

    w, e = torch.zeros(32), torch.zeros(32)
    for _ in range(300):
        wg = w.clone().requires_grad_()
        loss(wg).backward()
        g = wg.grad + e
        q, s = tcomp.quantize(g)
        g_hat = tcomp.dequantize(q, s)
        e = g - g_hat
        w = w - 0.05 * g_hat
    assert float(loss(w)) < 1e-3


def _reduced(arch="chatglm3-6b", seed=0):
    return LMModel(ARCHS[arch].reduced(), device="cpu",
                   generator=torch.Generator().manual_seed(seed))


def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
            for k in ("tokens", "labels")}


def test_compressed_step_one_rank_bitwise(host_mesh):
    """Over a one-rank data axis the reconstruction is ``dequantize(q,
    scale)``: the step's update equals the plain update on each gradient's
    round trip, and its error state is ``g32 - dequantize(q, scale)``, bit
    for bit; the metrics are the step's own."""
    opt = AdamWConfig(lr=1e-3, state_dtype=torch.float32, warmup_steps=1, total_steps=10)
    a, b = _reduced(), _reduced()
    batch = _batch(a.cfg, 1)
    err = tcomp.init_error_state(a.param_tree())
    for leaf in _tree.leaves(err):
        leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator().manual_seed(2)) * 1e-3)
    err0 = {k: v.clone() for k, v in _tree.items(err)}
    state, err, met = tcomp.make_compressed_dp_step(a, opt, host_mesh)(
        init_state(a.param_tree(), opt), err, batch)
    tsteps.zero_grads(b)
    loss, _ = b.loss(batch)
    loss.backward()
    want_err = {}
    for k, p in _tree.items(b.param_tree()):
        g32 = p.grad + err0[k]
        q, s = tcomp.quantize(g32)
        p.grad.copy_(tcomp.dequantize(q, s))
        want_err[k] = g32 - tcomp.dequantize(q, s)
    grads = _tree.map_with_path(lambda _, p: p.grad, b.param_tree())
    _, _, om = apply_updates(b.param_tree(), grads, init_state(b.param_tree(), opt), opt)
    for (k, p), (_, w) in zip(_tree.items(a.param_tree()), _tree.items(b.param_tree())):
        assert torch.equal(p, w), k
        assert torch.equal(dict(_tree.items(err))[k], want_err[k]), k
    assert float(met["loss"]) == float(loss.detach())
    assert float(met["grad_norm"]) == float(om["grad_norm"])
    assert int(state["step"]) == 1


# ---------------------------------------------------------------------------
# reshard, the launcher and checkpoints under a one-rank mesh
# ---------------------------------------------------------------------------

def test_reshard_places_and_keeps_none_leaves(host_mesh):
    """The reference's elastic re-mesh test on the port, and a DTensor
    moved to other placements; a ``None`` sharding leaves its leaf."""
    tsh.set_mesh(host_mesh)
    try:
        m = _reduced()
        params = m.param_tree()
        sh = _tree.map_with_path(lambda _, p: tsh.placements(()), params)
        moved = reshard(params, sh)
        for (k, a), (_, b) in zip(_tree.items(params), _tree.items(moved)):
            assert isinstance(b, DTensor) and b.placements == (Replicate(), Replicate()), k
            assert torch.equal(a, b.full_tensor()), k
        back = reshard(moved, tsteps.param_shardings(m))
        for (k, a), (_, b) in zip(_tree.items(params), _tree.items(back)):
            assert b.placements == dict(_tree.items(tsteps.param_shardings(m)))[k], k
            assert torch.equal(a, b.full_tensor()), k
        kept = reshard({"a": params["embed"], "b": params["final_ln"]},
                       {"a": None, "b": tsh.placements((None,))})
        assert kept["a"] is params["embed"] and isinstance(kept["b"], DTensor)
    finally:
        tsh.set_mesh(None)


def test_use_mesh_launcher_bitwise_on_one_rank():
    """``--use-mesh`` on the CPU trains under a one-rank (1, 1) mesh, the
    reduced llama4's expert-parallel path included, bit for bit the run
    without it."""
    from repro_torch.launch import train as launcher

    argv = ["--arch", "llama4-scout-17b-a16e", "--steps", "2", "--device", "cpu"]
    plain = launcher.main(argv)
    meshed = launcher.main(argv + ["--use-mesh"])
    assert [h["loss"] for h in meshed["history"]] == [h["loss"] for h in plain["history"]]
    for (k, a), (_, b) in zip(_tree.items(plain["params"]), _tree.items(meshed["params"])):
        assert isinstance(b, DTensor) and torch.equal(a, b.full_tensor()), k
    assert tsh.get_mesh() is None


def test_mesh_checkpoint_resumes_without_a_mesh(host_mesh, tmp_path):
    """A run under the mesh saves whole tensors: it crashes, a run without a
    mesh resumes from its checkpoint, and ends bit for bit where an
    uninterrupted run without a mesh ends."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    r = ARCHS["llama4-scout-17b-a16e"].reduced()
    pipe = TokenPipeline(PipelineConfig(vocab=r.vocab, seq_len=16, global_batch=2))
    opt = AdamWConfig(lr=1e-3, state_dtype=torch.float32, warmup_steps=1, total_steps=4)
    d1, d2 = str(tmp_path / "mesh"), str(tmp_path / "plain")
    tsh.set_mesh(host_mesh)
    try:
        with pytest.raises(RuntimeError, match="injected failure"):
            train(LMModel(r, device="cpu"), pipe.batch_at, opt,
                  TrainConfig(steps=4, ckpt_every=2, ckpt_dir=d1, fail_at_step=3))
    finally:
        tsh.set_mesh(None)
    resumed = train(LMModel(r, device="cpu"), pipe.batch_at, opt,
                    TrainConfig(steps=4, ckpt_every=2, ckpt_dir=d1))
    assert resumed["resumed_from"] == 2
    clean = train(LMModel(r, device="cpu"), pipe.batch_at, opt,
                  TrainConfig(steps=4, ckpt_every=2, ckpt_dir=d2))
    for (k, a), (_, b) in zip(_tree.items(resumed["params"]), _tree.items(clean["params"])):
        assert torch.equal(a, b), k


def test_one_rank_mesh_checks_hold_on_the_cpu(host_mesh):
    """The card's bit-for-bit checks of the one-rank mesh (``chip_smoke.py``'s
    phase mesh, ``tests/test_torch_cuda.py``) on the CPU over a one-rank
    gloo group, at the reduced llama4 and deepseek: two train steps under the
    mesh and without, the MoE block in ``ag`` and ``ws``, prefill and decode,
    and the compressed step against the plain update on the round-tripped
    gradient."""
    from _torch_cases import (compressed_vs_plain, mesh_train_pair, moe_block_mesh_vs_plain,
                              serve_mesh_vs_plain)
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    dev = torch.device("cpu")
    r = ARCHS["llama4-scout-17b-a16e"].reduced()
    pipe = TokenPipeline(PipelineConfig(vocab=r.vocab, seq_len=32, global_batch=2))
    runs = mesh_train_pair(r, dev, host_mesh, pipe.batch_at, AdamWConfig(),
                           TrainConfig(steps=2, accum=2))
    assert runs["plain"]["differ"] == []
    assert [h["loss"] for h in runs["mesh"]["history"]] == \
        [h["loss"] for h in runs["plain"]["history"]]
    assert [h["grad_norm"] for h in runs["mesh"]["history"]] == \
        [h["grad_norm"] for h in runs["plain"]["history"]]
    assert all(a == b and same for a, b, same in runs["mesh"]["layout"].values())
    model = runs["plain"]["model"]
    x = torch.randn((2, 16, r.d_model), generator=torch.Generator().manual_seed(3)).to(
        torch.bfloat16)
    for mode in ("ag", "ws"):
        assert moe_block_mesh_vs_plain(model, host_mesh, x, mode) == [], mode
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, r.vocab, (4, 12)).astype(
        np.int32))
    assert serve_mesh_vs_plain(model, host_mesh, tokens, 4) == []
    d = _reduced("deepseek-7b")
    got = compressed_vs_plain(d, host_mesh, _batch(d.cfg, 6), AdamWConfig())
    assert got["params_differ"] == [] and got["err_differ"] == []
    assert got["compressed"]["loss"] == got["plain"]["loss"]
    assert got["compressed"]["grad_norm"] == got["plain"]["grad_norm"]
    assert 3.9 < got["float32_bytes"] / got["wire_bytes"] <= 4


def test_checkpointed_blocks_recompute_under_the_forward_mesh(host_mesh):
    """A backward run on another thread than the forward (as autograd runs a
    CUDA backward) recomputes each checkpointed block under the forward's
    mesh, though the mesh is thread-local: the placed reduced llama4's
    gradients equal those of a backward on the forward's thread."""
    import threading

    grads = []
    for other_thread in (False, True):
        m = _reduced("llama4-scout-17b-a16e")
        batch = _batch(m.cfg, 7)
        with tsh.mesh_scope(host_mesh):
            tsteps.place(m)
            tsteps.zero_grads(m)
            loss, _ = m.loss(batch)
        if other_thread:
            errors = []

            def run():
                try:
                    loss.backward()
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            t = threading.Thread(target=run)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive() and not errors, errors
        else:
            loss.backward()
        grads.append([p.grad.full_tensor() for p in m.parameters()])
    assert tsh.get_mesh() is None
    for a, b in zip(*grads):
        assert torch.equal(a, b)
