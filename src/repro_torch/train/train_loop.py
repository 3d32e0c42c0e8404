"""The training loop: sharded step, checkpoint/restart, straggler and failure
handling.  The port of :mod:`repro.train.train_loop`.

* **Checkpoint/restart** — atomic rotating checkpoints every ``ckpt_every``
  steps; on start the loop resumes from the latest complete checkpoint and
  replays the deterministic pipeline from that step (exactly-once
  semantics).
* **Failure injection** — ``fail_at_step`` raises mid-run; a restart must
  reproduce the uninterrupted run bit for bit.
* **Elastic re-mesh** — :func:`reshard` moves live state onto a new (smaller
  or larger) mesh: the node-loss path rebuilds the mesh from survivors,
  reshards from checkpoint or live copies, and continues.
* **Straggler mitigation** — per-step wall times feed an EWMA; steps slower
  than ``straggler_factor``× the EWMA are counted and surfaced in metrics.

Under a mesh (``distributed/sharding.set_mesh``) ``train`` lays the
parameters, their ``.grad`` buffers and the moments out as DTensors by
``param_shardings``/``opt_state_shardings`` (a rank holds only its shards,
as the reference's ``in_shardings`` lay them out) and each step runs this
rank's rows of the global batch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import distribute, gather, get_mesh, local_chunk
from repro_torch.launch import steps as steps_mod
from repro_torch.models import LMModel
from . import _tree
from . import checkpoint as ckpt_mod
from . import optimizer as opt_mod


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    accum: int = 1
    fail_at_step: Optional[int] = None  # fault injection (tests)
    straggler_factor: float = 3.0


def train(
    model: LMModel,
    batch_at: Callable[[int], Dict[str, np.ndarray]],
    opt_cfg: opt_mod.AdamWConfig,
    tcfg: TrainConfig,
    generator: Optional[torch.Generator] = None,
    params=None,
    on_step: Optional[Callable[[int, dict], None]] = None,
) -> dict:
    """Run the training loop on ``model``'s device; returns the final state
    (``params``: the model's parameter tree, trained in place) and history.

    ``params`` (a tree like ``model.param_tree()``) is loaded into the model;
    without it the model is initialised afresh from ``generator`` (a
    generator on the model's device, seeded 0 when none is given), as the
    reference initialises from ``PRNGKey(0)``, so two runs start from the
    same weights.  Under a mesh every rank initialises the whole model from
    the same generator, then keeps its shards (``steps.place``); the model
    stays placed after the run."""
    dev = model.device
    mesh = get_mesh()
    steps_mod.unplace(model)
    if params is None:
        model.init(torch.Generator(dev).manual_seed(0) if generator is None else generator)
    else:
        _load(model, params)
    if mesh is not None:
        steps_mod.place(model)
    opt_state = opt_mod.init_state(model.param_tree(), opt_cfg)
    start_step = 0
    if tcfg.ckpt_dir:
        restored, meta = ckpt_mod.restore_latest(
            tcfg.ckpt_dir, {"params": model.param_tree(), "opt": opt_state})
        if restored is not None:
            _load(model, restored["params"])
            opt_state = restored["opt"]
            if mesh is not None:
                # the moments as the parameters are laid out; the step count
                # stays a plain scalar
                sh = steps_mod.opt_state_shardings(model)
                opt_state["m"] = reshard(opt_state["m"], sh["m"])
                opt_state["v"] = reshard(opt_state["v"], sh["v"])
            start_step = int(meta["step"])

    step_fn = steps_mod.make_train_step(model, opt_cfg, accum=tcfg.accum)
    history = []
    ewma = None
    stragglers = 0
    for step in range(start_step, tcfg.steps):
        if tcfg.fail_at_step is not None and step == tcfg.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch_at(step).items()}
        t0 = time.time()
        opt_state, metrics = step_fn(opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > tcfg.straggler_factor * ewma and step > start_step + 3:
            stragglers += 1
        metrics.update(step=step, step_time_s=dt, stragglers=stragglers)
        history.append(metrics)
        if on_step:
            on_step(step, metrics)
        if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
            ckpt_mod.save(tcfg.ckpt_dir, step + 1,
                          {"params": model.param_tree(), "opt": opt_state},
                          keep=tcfg.keep_ckpts)
    if tcfg.ckpt_dir:
        ckpt_mod.save(tcfg.ckpt_dir, tcfg.steps,
                      {"params": model.param_tree(), "opt": opt_state},
                      keep=tcfg.keep_ckpts)
    return {"params": model.param_tree(), "opt_state": opt_state, "history": history,
            "resumed_from": start_step}


def reshard(tree, shardings):
    """Elastic re-mesh: place live state onto the active mesh by
    ``shardings`` (a tree like ``tree`` of placements).  A leaf whose
    sharding is ``None`` stays where it is; the others are gathered whole
    from wherever they were laid out, then each rank keeps its shards."""
    place = dict(_tree.items(shardings))
    return _tree.map_with_path(
        lambda k, x: x if place[k] is None else distribute(gather(x.detach()), place[k]),
        tree)


@torch.no_grad()
def _load(model: LMModel, params) -> None:
    """Copy a parameter tree (whole tensors or numpy arrays) into the model
    (into this rank's shards where it is placed)."""
    got = dict(_tree.items(params))
    mine = dict(_tree.items(model.param_tree()))
    if set(got) != set(mine):
        raise KeyError(f"parameters {sorted(set(got) ^ set(mine))} do not match the model's")
    for key, p in mine.items():
        src = gather(torch.as_tensor(got[key]))
        if isinstance(p, DTensor):
            p.to_local().copy_(local_chunk(src, p.placements, p.device_mesh))
        else:
            p.copy_(src)
