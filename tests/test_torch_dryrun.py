"""The port's dry-run and roofline tools (``repro_torch.launch.dryrun``,
``dryrun_index``, ``roofline``) and bf16 parameters, against the reference
on the CPU.

* ``roofline``'s analytic FLOP and byte model equals the reference's for
  every arch and shape, and its collective byte model equals
  ``parse_collectives`` on the HLO lines of
  ``tests/test_dryrun_and_roofline.py::test_parse_collectives_counts_ops``.
* ``torch.utils.flop_counter`` on a 1-layer forward under ``FakeTensorMode``
  is within (0.5, 2.0) of the analytic count, as the reference's
  ``cost_analysis()`` is held (that file's
  ``test_analytic_flops_matches_cost_analysis_single_layer``).
* One subprocess starts torch's fake process group of 8 ranks and dry-runs
  the reduced chatglm3 (the reference smoke's ``tp=2``, 4 heads, 2 KV
  heads) on a (4, 2) mesh: a train step and a decode step, and
  ``dryrun_index`` at a small size.  Each record has the reference's keys
  and counted collectives, and its argument bytes equal the byte sum of the
  local shards the reference's ``param_shardings`` give a device (on an
  abstract mesh), the moments and the batch or cache.
* ``LMModel(param_dtype=torch.bfloat16)``: loss and every gradient against
  the reference's bf16 model op by op, a bf16-accumulated train step of it
  against the reference's, and a model built on the ``meta`` device or
  under ``FakeTensorMode`` allocates nothing.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import grad_errors
from repro.configs import base as rbase
from repro.configs.registry import ARCHS as RARCHS
from repro.distributed import sharding as rsh
from repro.launch import steps as rsteps
from repro.launch.dryrun import parse_collectives
from repro.launch.roofline import analytic_bytes as r_bytes
from repro.launch.roofline import analytic_flops as r_flops
from repro.launch.roofline import flops_per_token as r_fpt
from repro.models import LMModel as RModel
from repro.train import optimizer as ropt
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import steps as tsteps
from repro_torch.models import LMModel
from repro_torch.train import _tree
from repro_torch.train import optimizer as topt

LOSS_ATOL = 1e-4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_model_equals_reference(arch):
    """Pure-Python arithmetic of the padded config: equal, float for float."""
    for name, shape in tbase.SHAPES.items():
        rshape = rbase.SHAPES[name]
        t, r = ARCHS[arch], RARCHS[arch]
        assert roofline.flops_per_token(t, shape.seq_len, shape.kind) == \
            r_fpt(r, rshape.seq_len, rshape.kind)
        assert roofline.analytic_flops(t, shape) == r_flops(r, rshape)
        for n_dev in (256, 512):
            assert roofline.analytic_bytes(t, shape, n_dev) == r_bytes(r, rshape, n_dev)


def test_collective_byte_model_equals_parse_collectives():
    hlo = """
  %ag = bf16[32,1024]{1,0} all-gather(%x), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[256]{0} all-reduce(%y), replica_groups={{0,1},{2,3}}, to_apply=%add
  %rs = f32[64,128]{1,0} reduce-scatter(%z), replica_groups={{0,1,2,3}}, dimensions={0}
  %a2a = bf16[8,16]{1,0} all-to-all(%w), replica_groups={{0,1,2,3}}
  %cp = u8[100]{0} collective-permute(%v), source_target_pairs={{0,1}}
"""
    records = [("all-gather", 32 * 1024 * 2, 4), ("all-reduce", 256 * 4, 2),
               ("reduce-scatter", 64 * 128 * 4, 4), ("all-to-all", 8 * 16 * 2, 4),
               ("collective-permute", 100, 2)]
    assert dryrun.collective_bytes(records) == parse_collectives(hlo)


def test_flop_counter_within_analytic_single_layer():
    """The reference's single-layer config and batch; the port's forward
    (no remat) on fake tensors, its products counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = dataclasses.replace(
        ARCHS["deepseek-7b"], n_layers=1, vocab=1024, tp=1,
        n_heads=8, n_kv_heads=8, head_dim=64, d_model=512, d_ff=1024)
    B, S = 2, 256
    with FakeTensorMode():
        m = LMModel(cfg, device="cpu", param_dtype=torch.bfloat16, init=False)
        tokens = torch.zeros((B, S), dtype=torch.int32)
        with dryrun.StepCounter() as c, torch.no_grad():
            m.forward({"tokens": tokens}, remat=False)
    got = c.flops
    want = B * S * roofline.flops_per_token(cfg, S, "prefill")
    assert 0.5 < got / want < 2.0, (got, want)


_DRYRUN_SCRIPT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun, dryrun_index
from repro_torch.train.optimizer import AdamWConfig

cfg = dataclasses.replace(ARCHS["chatglm3-6b"].reduced(), tp=2, n_kv_heads=2, n_heads=4)
out = {}
out["train"] = dryrun.run_config(cfg, ShapeSpec("smoke", 64, 8, "train"), mesh_shape=(4, 2),
                                 param_dtype=torch.float32,
                                 opt_cfg=AdamWConfig(state_dtype=torch.float32))
out["decode"] = dryrun.run_config(cfg, ShapeSpec("smoke_decode", 64, 8, "decode"),
                                  mesh_shape=(4, 2))
out["index"] = dryrun_index.run(False, 20000, 256, sys.argv[1], per_dest_capacity=64)
print(json.dumps(out))
"""

RECORD_KEYS = {"arch", "shape", "mesh", "kind", "n_devices", "lower_s", "compile_s", "memory",
               "flops_per_device", "hlo_bytes_per_device", "collectives",
               "model_flops_global", "model_flops_per_device", "useful_flops_ratio",
               "roofline", "dominant", "params_unpadded", "params_padded", "params_active"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "generated_code_size_in_bytes", "alias_size_in_bytes", "total_per_device"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _DRYRUN_SCRIPT, str(d)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _abstract_batch_axes(batch_size: int):
    """The reference's ``steps._batch_axes_for``, its sizes read from an
    abstract mesh (which has no devices to read them from)."""
    r, mesh = rsh.rules(), rsh.get_mesh()
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    if batch_size % int(np.prod([sizes[a] for a in r.batch])) == 0:
        return r.batch
    if "data" in r.batch and batch_size % sizes["data"] == 0:
        return ("data",)
    return None


def _reference_arg_bytes(kind: str, monkeypatch) -> int:
    """The byte sum of the local shards the reference's ``param_shardings``
    give one device of a (4, 2) abstract mesh, with the moments (train,
    float32), and the batch's or cache's local shards."""
    monkeypatch.setattr(rsteps, "_batch_axes_for", _abstract_batch_axes)
    cfg = dataclasses.replace(RARCHS["chatglm3-6b"].reduced(), tp=2, n_kv_heads=2, n_heads=4)
    mesh = jax.sharding.AbstractMesh((4, 2), ("data", "model"),
                                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
    pdt = jnp.float32 if kind == "train" else jnp.bfloat16
    m = RModel(cfg, param_dtype=pdt)
    shape = rbase.ShapeSpec("s", 64, 8, kind)
    rsh.set_mesh(mesh)
    try:
        ps = dict(_tree.items(rsteps.param_shardings(m)))
        bs = rsteps.batch_shardings(cfg, shape)
        n = sum(int(np.prod(ps[k].shard_shape(a.shape)))
                for k, a in _tree.items(m.abstract_params()))
        total = n * np.dtype(pdt).itemsize
        if kind == "train":
            total += 2 * n * 4 + 4
        for k, spec in rbase.input_specs(cfg, shape).items():
            if k == "cache":
                for c, s in spec.items():
                    total += int(np.prod(bs["cache"][c].shard_shape(s.shape))) * s.dtype.itemsize
            elif k != "pos":
                total += int(np.prod(bs[k].shard_shape(spec.shape))) * spec.dtype.itemsize
    finally:
        rsh.set_mesh(None)
    return int(total)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dryrun_record_on_a_fake_world_of_eight(records, kind, monkeypatch):
    rec = records[kind]
    assert "error" not in rec
    assert RECORD_KEYS <= set(rec) and MEMORY_KEYS == set(rec["memory"])
    assert rec["n_devices"] == 8 and rec["mesh"] == "4x2"
    assert rec["memory"]["argument_size_in_bytes"] == _reference_arg_bytes(kind, monkeypatch)
    assert rec["memory"]["total_per_device"] > rec["memory"]["argument_size_in_bytes"]
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0 and coll["all-gather"]["count"] > 0
    assert coll["all-reduce"]["count"] > 0          # the tensor-parallel sums over model
    if kind == "train":
        assert rec["accum"] == 1 and coll["reduce-scatter"]["count"] > 0
    assert rec["flops_per_device"] > 0 and rec["dominant"] in rec["roofline"]
    enriched = roofline.enrich(dict(rec, arch="chatglm3-6b", shape="train_4k"
                                    if kind == "train" else "decode_32k"))
    assert enriched["analytic"]["step_time_lower_bound_s"] > 0


def test_dryrun_index_record(records):
    """Five all-to-alls of the routed lookup over data (queries, lengths;
    found, lo, hi back), each the size of the (16, C, ...) buffers."""
    rec = records["index"]
    C = 64
    a2a = rec["collectives"]["all-to-all"]
    assert a2a["count"] == 5 and rec["collectives"]["total_bytes"] == a2a["bytes"]
    # each a (16, C, ...) buffer: a row's bytes and length out, found, lo, hi back
    assert a2a["bytes"] % (16 * C) == 0 and a2a["bytes"] > 16 * C * (4 + 1 + 4 + 4)
    assert rec["kind"] == "index-serve" and rec["queries_per_step"] == 256 * 256
    assert rec["hlo_bytes_per_device"] > 0 and rec["flops_per_device"] == 0
    md = roofline.table([roofline.enrich(dict(rec))])
    assert "lits-query-service" in md


def test_roofline_tabulates_a_directory(records, tmp_path):
    for k, rec in records.items():
        (tmp_path / f"{k}.json").write_text(json.dumps(
            dict(rec, arch="chatglm3-6b", shape="train_4k" if k == "train" else "decode_32k")
            if k != "index" else rec))
    (tmp_path / "skip.json").write_text(json.dumps(
        {"arch": "deepseek-7b", "shape": "long_500k", "mesh": "16x16", "skip": "out of spec"}))
    out = tmp_path / "roofline.md"
    roofline.main(["--dir", str(tmp_path), "--out", str(out)])
    text = out.read_text()
    assert text.count("\n| ") == 5 and "SKIP: out of spec" in text and "H100" in text


# ---------------------------------------------------------------------------
# bf16 parameters
# ---------------------------------------------------------------------------

def _bf16_pair(seed=2):
    rcfg = RARCHS["deepseek-7b"].reduced()
    rm = RModel(rcfg, param_dtype=jnp.bfloat16)
    params = rm.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    m = lm_params_from_reference(tree, LMModel(ARCHS["deepseek-7b"].reduced(), device="cpu",
                                               param_dtype=torch.bfloat16, init=False))
    return rm, params, m


def _batch(cfg, seed=0, B=4, S=16):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}


def test_bf16_model_loss_and_grads_match_reference_op_by_op():
    rm, params, m = _bf16_pair()
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    b = _batch(m.cfg)
    with jax.disable_jit():
        (rloss, _), rgrads = jax.value_and_grad(rm.loss, has_aux=True)(
            params, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _ = m.loss({k: torch.from_numpy(v) for k, v in b.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(rloss), abs=LOSS_ATOL)
    want = {k: np.asarray(v.astype(jnp.float32)) for k, v in _tree.items(rgrads)}
    got = {k: p.grad for k, p in _tree.items(m.param_tree())}
    assert all(g.dtype == torch.bfloat16 for g in got.values())
    errs = grad_errors(got, want)
    bad = {k: e for k, e in errs.items() if e[0] > e[1]}
    assert not bad, bad


def test_bf16_accumulated_train_step_matches_reference():
    """bf16 parameters and a bf16 accumulator (the reference's choice for
    models over 100 B parameters) over 2 microbatches, bf16 moments: the
    loss and grad norm, and every parameter within 2.02·lr plus one bf16
    step of its value (a bf16 parameter moves in steps of 2^-8 of itself)."""
    rm, params, m = _bf16_pair()
    b = _batch(m.cfg, seed=1)
    rcfg, tcfg = ropt.AdamWConfig(), topt.AdamWConfig()
    with jax.disable_jit():
        rp, _, rmet = rsteps.make_train_step(rm, rcfg, accum=2, grad_dtype=jnp.bfloat16)(
            params, ropt.init_state(params, rcfg), {k: jnp.asarray(v) for k, v in b.items()})
    _, tmet = tsteps.make_train_step(m, tcfg, accum=2, grad_dtype=torch.bfloat16)(
        topt.init_state(m.param_tree(), tcfg), {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(tmet["loss"]) == pytest.approx(float(rmet["loss"]), abs=LOSS_ATOL)
    assert float(tmet["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=1e-2)
    lr = float(rmet["lr"])
    want = {k: np.asarray(v.astype(jnp.float32)) for k, v in _tree.items(rp)}
    for k, p in _tree.items(m.param_tree()):
        assert p.dtype == torch.bfloat16
        got = p.detach().float().numpy()
        tol = 2.02 * lr + np.abs(want[k]) * 2.0 ** -8
        assert (np.abs(got - want[k]) <= tol).all(), k


def test_bf16_model_is_its_float32_twin_cast():
    cfg = ARCHS["hymba-1.5b"].reduced()
    a = LMModel(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = LMModel(cfg, device="cpu", param_dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(5))
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert q.dtype == torch.bfloat16 and torch.equal(p.to(torch.bfloat16), q), k


@pytest.mark.parametrize("where", ["meta", "fake"])
def test_model_builds_without_allocating(where):
    """arctic-480b at its published size: its parameters' shapes and dtype,
    no storage (the dry-run's counterpart of ``abstract_params``)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    cfg = ARCHS["arctic-480b"]
    if where == "meta":
        m = LMModel(cfg, device="meta", param_dtype=torch.bfloat16, init=False)
    else:
        with FakeTensorMode():
            m = LMModel(cfg, device="cpu", param_dtype=torch.bfloat16, init=False)
    n = 0
    for p in m.parameters():
        assert p.dtype == torch.bfloat16
        assert p.device.type == "meta" if where == "meta" else isinstance(p, FakeTensor)
        n += p.numel()
    assert n == cfg.param_count(True)
    want = {k: tuple(v.shape) for k, v in _tree.items(m.abstract_params())}
    assert want == {k: tuple(v.shape) for k, v in _tree.items(m.param_tree())}


def test_dryrun_modules_import_no_jax():
    code = ("import sys; import repro_torch.launch.dryrun, repro_torch.launch.dryrun_index, "
            "repro_torch.launch.roofline; bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
