"""Multi-pod dry-run: trace every (arch × shape × mesh) cell for one device:
the port of :mod:`repro.launch.dryrun`.

For each cell this records the memory one device needs (does it fit), its
FLOPs and bytes, and its collectives with their bytes under the
reference's ring cost model.  Records land as JSON under
``experiments/dryrun_torch/`` (one per cell, the reference's keys) and are
aggregated by :mod:`repro_torch.launch.roofline`.

How, where the reference lowers and compiles under 256 or 512 fake XLA
devices:

* **Mesh.** The (16, 16) or (2, 16, 16) mesh of ``launch/mesh.py`` over
  torch's fake process group of 256 or 512 ranks in this one process (rank
  0; ``fake_process_group``), so that every collective is issued and
  counted but moves nothing.
* **Tracing.** One train, prefill or decode step of rank 0 runs under
  ``FakeTensorMode``: parameters, optimizer state, batch and caches are
  fake tensors of the shapes rank 0 holds (parameters laid out by
  ``param_shardings`` as DTensors, the batch and caches by
  ``batch_shardings`` and ``cache_shardings``).  Nothing is allocated, so a
  480 B-parameter model traces on a laptop, and the trace runs the same
  whether or not a card is present (the fake tensors are tagged ``cpu``).
  Parameters and moments take the reference's dtypes (bf16 for models over
  100 B parameters and for serving, else float32; bf16 moments) and the
  train step ``choose_accum``'s accumulation.
* **Depth.** The reference scans over layers, so its program holds one
  layer; the port runs its layers one by one.  The step is traced at 2 (and
  3) layers, and every count is extrapolated linearly to the config's
  depth (``depth_counts``); a train step's microbatch is traced once and
  counted ``accum`` times, its optimizer update once.  The argument bytes
  are counted at full depth from the parameters' local shard shapes.
* **Counts**, by one dispatch mode (``StepCounter``).  Collectives as
  ``CommDebugMode`` sees them, each one's bytes by the reference's model
  (all-gather the result, all-reduce twice the result, reduce-scatter the
  group size times the result, all-to-all and permute the result;
  ``collective_bytes``).  FLOPs by ``torch.utils.flop_counter``'s formulas
  (matrix products only).  Bytes: every traced op's operands and results,
  unfused (the reference's key ``hlo_bytes_per_device`` holds XLA's bytes
  accessed).  Memory: the argument bytes (this rank's parameter shards,
  optimizer state and batch or cache), and the peak of the live
  temporaries over the step (storages tracked by weak references, as
  ``torch.distributed._tools.mem_tracker.MemTracker`` tracks them), of
  which the outputs a step returns are counted apart.  The record keeps the
  reference's keys: ``lower_s`` is the time to start the fake group and
  the mesh, ``compile_s`` the time to trace.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--arch-filter moe]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import SHAPES, cell_skip_reason, input_specs
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.distributed import sharding
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import roofline_terms
from repro_torch.models import LMModel
from repro_torch.train import _tree
from repro_torch.train import optimizer as opt_mod

DEVICE = "cpu"   # the fake tensors' tag: nothing is allocated on it
OUT_DIR = "experiments/dryrun_torch"


def fake_process_group(world: int) -> None:
    """Start torch's fake process group of ``world`` ranks, this process
    rank 0 (ending the group that is up, if any).  Its store,
    ``torch.testing._internal.distributed.fake_pg.FakeStore``, is a private
    testing class of torch: it is imported here and nowhere else, so a
    change of it breaks this one helper."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _tally(records: Sequence[tuple]) -> dict:
    """``{(op, group size): [count, result bytes]}`` of ``(op, result bytes,
    group size)`` records."""
    out: dict = {}
    for op, nbytes, n in records:
        t = out.setdefault((op, n), [0, 0])
        t[0] += 1
        t[1] += nbytes
    return out


def _buckets(tally: dict) -> dict:
    """Per-device collective bytes, bucketed by op kind: the reference's
    ``parse_collectives`` cost model (ring algorithms, n = group size)::

      all-gather         moves ~result_bytes       per device
      all-reduce         moves ~2 x result_bytes   per device
      reduce-scatter     moves ~n x result_bytes   per device (input-sized)
      all-to-all         moves ~result_bytes       per device
      collective-permute moves result_bytes        per device
    """
    buckets: dict = {}
    for (op, n), (count, nbytes) in sorted(tally.items()):
        if op == "all-reduce":
            moved = 2 * nbytes
        elif op == "reduce-scatter":
            moved = nbytes * max(n, 1)
        else:
            moved = nbytes
        b = buckets.setdefault(op, {"count": 0, "bytes": 0})
        b["count"] += int(count)
        b["bytes"] += int(moved)
    buckets["total_bytes"] = int(sum(v["bytes"] for v in buckets.values() if isinstance(v, dict)))
    return buckets


def collective_bytes(records: Sequence[tuple]) -> dict:
    """The reference's ``parse_collectives`` buckets of ``(op, result bytes,
    group size)`` records (``_buckets``)."""
    return _buckets(_tally(records))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _group_size(g) -> int:
    """The size of a collective's group: a functional collective names it,
    a ``c10d`` op holds it boxed."""
    if isinstance(g, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(g).size()
    return dist.ProcessGroup.unbox(g).size()


def _collective(func, args) -> Optional[tuple]:
    """(op, result bytes, group size) of a collective op, or None."""
    name = func._overloadpacket.__name__.strip("_")
    ns = func._overloadpacket._qualified_op_name.split("::")[0]
    if ns == "_c10d_functional":
        if name == "all_gather_into_tensor":
            return "all-gather", _nbytes(args[0]) * args[1], args[1]
        if name == "reduce_scatter_tensor":
            return "reduce-scatter", _nbytes(args[0]) // args[2], args[2]
        if name == "all_reduce":
            return "all-reduce", _nbytes(args[0]), _group_size(args[2])
        if name == "all_to_all_single":
            return "all-to-all", _nbytes(args[0]), _group_size(args[3])
        return None
    if ns != "c10d":
        return None
    if name == "allreduce":
        return "all-reduce", sum(_nbytes(t) for t in args[0]), _group_size(args[1])
    if name == "alltoall_base":
        return "all-to-all", _nbytes(args[0]), _group_size(args[2])
    if name == "allgather_base":
        return "all-gather", _nbytes(args[0]), _group_size(args[2])
    if name == "allgather":
        return "all-gather", sum(_nbytes(t) for t in args[0][0]), _group_size(args[2])
    if name in ("reduce_scatter_base", "reduce_scatter"):
        res = args[0] if name == "reduce_scatter_base" else args[0][0]
        return "reduce-scatter", _nbytes(res), _group_size(args[2])
    return None


class StepCounter(TorchDispatchMode):
    """One dispatch mode that counts a traced region: the matrix products'
    FLOPs (``torch.utils.flop_counter``'s formulas, as ``FlopCounterMode``
    counts them), the collectives (``(op, result bytes, group size)``, as
    ``CommDebugMode`` sees them; groups of one rank move nothing and are
    left out), the bytes every op reads and writes, and the peak of the
    bytes of the storages the region allocated that are alive at once (as
    ``torch.distributed._tools.mem_tracker.MemTracker`` tracks them, by weak
    references to the storages).  One mode, since each mode stacked on the
    fake tensors' costs every op as much again.  ``externals`` are the
    tensors live before the region (its arguments): they are not counted."""

    def __init__(self, externals: Sequence = ()):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0
        self.records: list = []
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in externals:
            self._seen[t.untyped_storage()] = None

    def __enter__(self):
        # DTensor derives an op's output metadata by running it on fake
        # tensors of the global shapes (its sharding propagation, once per
        # new schema): those ops are not the rank's work and are not counted
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._skip = 0
        self._prop = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, *a, **kw):
            self._skip += 1
            try:
                return self._prop(prop, *a, **kw)
            finally:
                self._skip -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._prop
        return super().__exit__(*exc)

    def _freed(self, nbytes: int):
        def cb(_):
            self.live -= nbytes
        return cb

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = weakref.ref(st, self._freed(n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is DTensor for t in types):
            return NotImplemented      # DTensor desugars into local ops and collectives
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) or func.is_view \
                or func is torch.ops.prim.device.default or self._skip:
            return out                 # allocates, moves and computes nothing
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        rec = _collective(func, args)
        if rec is not None and rec[2] > 1:
            self.records.append(rec)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        self.op_bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    def snapshot(self) -> dict:
        return {"flops": float(self.flops), "op_bytes": self.op_bytes,
                "coll": _tally(self.records), "temp": self.peak, "live": self.live}


def _local(spec: torch.Tensor, place) -> torch.Tensor:
    """A fake tensor of this rank's piece of ``spec`` under ``place``."""
    shape = sharding.local_chunk(torch.empty(spec.shape, device="meta"), place).shape
    return torch.zeros(shape, dtype=spec.dtype, device=DEVICE)


def _tensors(tree) -> list:
    leaves = _tree.leaves(tree) if isinstance(tree, dict) else list(tree)
    return [t.to_local() if isinstance(t, DTensor) else t for t in leaves]


def _param_dtype(cfg, kind: str):
    """The reference's choice (``dryrun.py``): bf16 parameters (and gradient
    accumulation) for models over 100 B parameters, and for serving; else
    float32."""
    if kind != "train" or cfg.param_count(True) > 100e9:
        return torch.bfloat16
    return torch.float32


def arg_bytes(cfg, shape, param_dtype, opt_cfg=None) -> int:
    """This rank's argument bytes at full depth: its parameter shards, its
    optimizer moments (train) and its batch or cache, from the shapes
    ``param_shardings``, ``batch_shardings`` and ``cache_shardings`` give."""
    model = LMModel(cfg, device="meta", param_dtype=param_dtype, init=False)
    sh = dict(_tree.items(steps_mod.param_shardings(model)))
    size = torch.empty((), dtype=param_dtype).element_size()
    n = sum(sharding.local_chunk(p, sh[k]).numel() for k, p in _tree.items(model.param_tree()))
    total = n * size
    if opt_cfg is not None:
        total += 2 * n * torch.empty((), dtype=opt_cfg.state_dtype).element_size() + 4
    bsh = steps_mod.batch_shardings(cfg, shape)
    for k, spec in input_specs(cfg, shape).items():
        if k == "cache":
            for c, s in spec.items():
                total += _nbytes(sharding.local_chunk(s, bsh["cache"][c]))
        elif k != "pos":
            total += _nbytes(sharding.local_chunk(spec, bsh[k]))
    return total


def _scan_chunk_batched(h, u, dt, Bc, Cc, A):
    """The SSM scan over one chunk in chunk-wide ops, in place of
    ``ssm._scan_chunk``'s loop of a few ops a time step while the dry-run
    traces (4,096 and 32,768 steps a layer take minutes under fake tensors):
    the same products (one (d_inner, N) · N contraction a row and step),
    the same (B, c, d_inner, N) float32 factors and states a chunk holds, the
    recurrence as a cumulative product and sum.  Its values are not the
    scan's, and nothing reads them."""
    dA = torch.exp(dt.float()[..., None] * A[None, None])           # (B,c,di,N)
    dBu = (dt * u).float()[..., None] * Bc.float()[:, :, None, :]
    P = torch.cumprod(dA, dim=1)
    H = P * (h[:, None] + torch.cumsum(dBu / P, dim=1))
    y = torch.einsum("bcdn,bcn->bcd", H, Cc.float()).to(u.dtype)
    return H[:, -1], y


def _marked(counters: "StepCounter", owner, name: str, marks: dict):
    """Wrap ``owner.<name>`` (a method or a module's function) to snapshot
    ``counters`` at each call, the snapshots in ``marks[name]``; returns the
    unwrapped one."""
    fn = getattr(owner, name)
    marks[name] = []

    def call(*a, **kw):
        marks[name].append(counters.snapshot())
        return fn(*a, **kw)

    setattr(owner, name, call)
    return fn


def trace_step(cfg, shape, param_dtype, opt_cfg, accum: int) -> dict:
    """Trace one step of ``cfg`` (cut depth) on rank 0 under
    ``FakeTensorMode``: the counts of the whole step (train: one
    microbatch of ``global_batch / accum`` rows, then the update), snapshots
    at the start of each layer (``_local_params``), at the head, and before
    the update (``apply_updates``), and the bytes of the step's outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import ssm

    scan = ssm._scan_chunk
    ssm._scan_chunk = _scan_chunk_batched
    try:
        with FakeTensorMode():
            return _trace(cfg, shape, param_dtype, opt_cfg, accum)
    finally:
        ssm._scan_chunk = scan


def _trace(cfg, shape, param_dtype, opt_cfg, accum: int) -> dict:
    model = LMModel(cfg, device=DEVICE, param_dtype=param_dtype, init=False)
    steps_mod.place(model)
    specs = input_specs(cfg, shape)
    bsh = steps_mod.batch_shardings(cfg, shape)
    args = _tensors(model.param_tree())
    if shape.kind == "train":
        mb = dataclasses.replace(shape, global_batch=shape.global_batch // accum)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=DEVICE)
                 for k, v in input_specs(cfg, mb).items()}
        state = opt_mod.init_state(model.param_tree(), opt_cfg)
        args += _tensors(state["m"]) + _tensors(state["v"]) + list(batch.values())
    elif shape.kind == "prefill":
        batch = {k: _local(v, bsh[k]) for k, v in specs.items()}
        args += list(batch.values())
    else:
        cache = {k: _local(v, bsh["cache"][k]) for k, v in specs["cache"].items()}
        token = _local(specs["token"], bsh["token"])
        seq_axes = () if steps_mod._batch_axes_for(shape.global_batch) is not None \
            else sharding.rules().batch
        args += list(cache.values()) + [token]
    counters, marks = StepCounter(args), {}
    for name in ("_local_params", "_head"):
        _marked(counters, model, name, marks)
    out = 0
    with counters:
        if shape.kind == "train":
            update = _marked(counters, opt_mod, "apply_updates", marks)
            try:
                steps_mod.make_train_step(model, opt_cfg, accum=1,
                                          grad_dtype=param_dtype)(state, batch)
            finally:
                opt_mod.apply_updates = update
        elif shape.kind == "prefill":
            cache, logits = model.prefill(batch)
            out = sum(_nbytes(t) for t in cache.values())
            marks["cache_bytes"] = out
            out += _nbytes(logits)
        else:
            _, logits = model.decode_step(cache, token, shape.seq_len - 1,
                                          seq_axes=seq_axes)
            out = _nbytes(logits)
    return {"total": counters.snapshot(), "marks": marks, "out": out}


def _combine(parts: Sequence[tuple]) -> dict:
    """The sum of counts ``c`` weighted ``w`` over ``(w, c)`` pairs."""
    out = {k: sum(w * c[k] for w, c in parts) for k in ("flops", "op_bytes")}
    coll: dict = {}
    for w, c in parts:
        for key, (count, nbytes) in c["coll"].items():
            t = coll.setdefault(key, [0, 0])
            t[0] += w * count
            t[1] += w * nbytes
    out["coll"] = coll
    return out


def depth_counts(cfg, shape, param_dtype, opt_cfg, accum: int) -> dict:
    """The step's counts at the config's depth L, and its outputs' bytes.

    A prefill or decode step is traced once at 2 layers: one layer's counts
    are those from the start of its second layer to the head (so the first
    layer's one-off costs are not multiplied), and the step at depth L is
    the traced step plus L - 2 such layers.  Its peak of temporaries grows
    by what a layer leaves live at the head (a prefill's states), twice for
    a prefill, which stacks those states into the cache at the end.

    A train step's backward runs the layers in reverse inside autograd, with
    no hook between them: it is traced at 1 and 2 layers and one layer's
    counts are the difference.  The step at depth L runs
    ``accum`` microbatches and one update: the traced step plus ``accum -
    1`` microbatches (the counts before the update).  Its peak grows by a
    layer's share of what is live at the head (saved activations, gradient
    buffers) or of the peak, the larger."""
    L = cfg.n_layers
    if shape.kind != "train":
        t = trace_step(dataclasses.replace(cfg, n_layers=2), shape, param_dtype, opt_cfg, accum)
        start, head = t["marks"]["_local_params"][1], t["marks"]["_head"][0]
        layer = _combine([(1, head), (-1, start)])
        counts = _combine([(1, t["total"]), (L - 2, layer)])
        grow = max(head["live"] - start["live"], 0)
        out_layer = t["marks"]["cache_bytes"] / 2 if shape.kind == "prefill" else 0
        counts["temp"] = t["total"]["temp"] + (L - 2) * (grow + out_layer)
        out = t["out"] + (L - 2) * out_layer
        return {"counts": counts, "out": int(out)}
    one, two = (trace_step(dataclasses.replace(cfg, n_layers=n), shape, param_dtype, opt_cfg,
                           accum) for n in (1, 2))
    layer = _combine([(1, two["total"]), (-1, one["total"])])
    step = _combine([(1, two["total"]), (L - 2, layer)])
    before = [t["marks"]["apply_updates"][0] for t in (one, two)]   # one microbatch's counts
    mb = _combine([(1, before[1]), (L - 2, _combine([(1, before[1]), (-1, before[0])]))])
    counts = _combine([(1, step), (accum - 1, mb)])
    grow = max(two["marks"]["_head"][0]["live"] - one["marks"]["_head"][0]["live"],
               two["total"]["temp"] - one["total"]["temp"], 0)
    counts["temp"] = two["total"]["temp"] + (L - 2) * grow
    return {"counts": counts, "out": 0}


def model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per sequence


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The record of one (arch × shape × mesh) cell, with the reference's
    choices of dtypes and accumulation."""
    cfg, shape = get_arch(arch), SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
           "kind": shape.kind}
    skip = cell_skip_reason(cfg, shape)
    if skip:
        rec["skip"] = skip
        return rec
    return run_config(cfg, shape, multi_pod=multi_pod)


def run_config(cfg, shape, *, multi_pod: bool = False, mesh_shape=None, param_dtype=None,
               opt_cfg=None, accum: Optional[int] = None) -> dict:
    """The record of one step of ``cfg`` at ``shape`` on the production mesh,
    or on a ``("data", "model")`` mesh of ``mesh_shape`` (over a fake group of
    its size).  ``param_dtype``, ``opt_cfg`` (train) and ``accum`` (train)
    default to the reference's choices."""
    if mesh_shape is None:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        n_dev = 512 if multi_pod else 256
    else:
        mesh_name = "x".join(map(str, mesh_shape))
        n_dev = mesh_shape[0] * mesh_shape[1]
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name, "kind": shape.kind}
    t0 = time.time()
    fake_process_group(n_dev)
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=DEVICE)
    else:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(DEVICE, tuple(mesh_shape), mesh_dim_names=("data", "model"))
    sharding.set_mesh(mesh)
    t_lower = time.time() - t0
    try:
        pdt = param_dtype or _param_dtype(cfg, shape.kind)
        if shape.kind == "train":
            opt_cfg = opt_cfg or opt_mod.AdamWConfig(state_dtype=torch.bfloat16)
            if accum is None:
                n_batch_shards = 1
                for a in sharding.rules().batch:
                    n_batch_shards *= sharding.axis_size(a)
                accum = steps_mod.choose_accum(cfg, shape, n_batch_shards)
            rec["accum"] = accum
        got = depth_counts(cfg, shape, pdt, opt_cfg, accum)
        counts, out = got["counts"], got["out"]
        arg = arg_bytes(cfg, shape, pdt, opt_cfg)
    finally:
        sharding.set_mesh(None)
        dist.destroy_process_group()
    memory = {"argument_size_in_bytes": int(arg), "output_size_in_bytes": int(out),
              "temp_size_in_bytes": int(max(counts["temp"] - out, 0)),
              "generated_code_size_in_bytes": 0, "alias_size_in_bytes": 0}
    memory["total_per_device"] = (memory["argument_size_in_bytes"]
                                  + memory["output_size_in_bytes"]
                                  + memory["temp_size_in_bytes"])
    coll = _buckets(counts["coll"])
    flops_dev, bytes_dev = counts["flops"], float(counts["op_bytes"])
    mf = model_flops(cfg, shape)
    terms = roofline_terms(flops_dev, bytes_dev, coll["total_bytes"])
    rec.update(
        n_devices=n_dev,
        lower_s=round(t_lower, 2),
        compile_s=round(time.time() - t0 - t_lower, 2),
        memory=memory,
        flops_per_device=flops_dev,
        hlo_bytes_per_device=bytes_dev,
        collectives=coll,
        model_flops_global=mf,
        model_flops_per_device=mf / n_dev,
        useful_flops_ratio=(mf / n_dev) / flops_dev if flops_dev else None,
        roofline=terms,
        dominant=max(terms, key=terms.get),
        params_unpadded=cfg.param_count(False),
        params_padded=cfg.param_count(True),
        params_active=cfg.active_param_count(),
    )
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--arch-filter", default=None, help="substring filter for --all")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    cells = []
    if args.all:
        for name in ARCHS:
            if args.arch_filter and args.arch_filter not in name:
                continue
            for sname in SHAPES:
                cells.append((name, sname))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]

    for arch, sname in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            path = os.path.join(args.out, f"{arch}_{sname}_{mesh_name}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip existing] {path}")
                continue
            try:
                rec = run_cell(arch, sname, mp)
            except Exception as e:  # record failures: they are bugs to fix
                rec = {"arch": arch, "shape": sname, "mesh": mesh_name,
                       "error": str(e), "traceback": traceback.format_exc()}
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
            if "error" in rec:
                print(f"[FAIL] {arch} {sname} {mesh_name}: {rec['error'][:200]}")
            elif "skip" in rec:
                print(f"[skip] {arch} {sname} {mesh_name}: {rec['skip']}")
            else:
                m = rec["memory"]["total_per_device"] / 2**30
                print(
                    f"[ok] {arch} {sname} {mesh_name}: compile={rec['compile_s']}s "
                    f"mem/dev={m:.2f}GiB dominant={rec['dominant']} "
                    f"terms={{{', '.join(f'{k}={v:.3e}' for k, v in rec['roofline'].items())}}}",
                    flush=True)


if __name__ == "__main__":
    main()
