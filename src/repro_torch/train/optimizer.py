"""AdamW over the parameter tree: the port of :mod:`repro.train.optimizer`.

* ``state_dtype`` (default bfloat16, as the reference's) is the moments'
  dtype; the update runs in float32 whatever it is, and global-norm clipping
  too.
* The update is the reference's chain of float32 operations, each multiply
  and add its own rounding (no ``alpha=`` forms, which may fuse into an
  FMA), written in place into the parameters and moments one slice at a
  time: at most ``UPDATE_CHUNK`` elements (flat pieces of a leaf whose
  tensors are contiguous, else rows of its leading dim, a whole layer of a
  stacked leaf when a layer is larger), so the chain's float32 temporaries
  stay a slice's size and no parameter is copied whole.  The reference's functional form
  returns new trees; here ``apply_updates`` returns the same tensors,
  updated.
* The schedule and the bias corrections are float32 tensors on the
  parameters' device, as the reference computes them on its device.  With
  the reference run op by op the parameters, moments and learning rate come
  out bit for bit (``tests/test_torch_train.py``).
* Under a mesh the parameters, gradients and moments are DTensors of one
  layout (ZeRO-3: the moments inherit the parameters' placements): the
  update runs on each rank's shards, and the global norm sums the squared
  norms over every shard before its square root.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import psum

from . import _tree

UPDATE_CHUNK = 1 << 25   # elements a slice of the update holds at most


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.bfloat16
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _f32(x, device) -> torch.Tensor:
    """A Python number as a float32 scalar tensor (a JAX weak-typed scalar
    meets a float32 array as its float32 rounding)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay: the learning rate at ``step`` (a scalar
    tensor), float32."""
    dev = step.device
    step = step.float()
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1), dev), _f32(1.0, dev))
    t = torch.clamp(
        (step - _f32(cfg.warmup_steps, dev))
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev),
        0.0, 1.0,
    )
    # Python folds (1 - min_lr_frac) * 0.5 in double before meeting the array
    cos = _f32(cfg.min_lr_frac, dev) + _f32((1 - cfg.min_lr_frac) * 0.5, dev) * (
        _f32(1.0, dev) + torch.cos(_f32(math.pi, dev) * t))
    return _f32(cfg.lr, dev) * warm * cos


def init_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments shaped like ``params`` (a tree of tensors) in
    ``cfg.state_dtype``, and the step count, an int32 scalar."""
    def zeros(_, p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=cfg.state_dtype)
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    dev = _tree.leaves(params)[0].device
    return {
        "m": _tree.map_with_path(zeros, params),
        "v": _tree.map_with_path(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    return _sqrt(torch.sum(torch.stack([_sq_norm(x) for x in _tree.leaves(tree)])))


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """The squared norm of a leaf; of a DTensor, its shards' summed over the
    mesh axes that shard it."""
    if not isinstance(x, DTensor):
        return torch.sum(torch.square(x.float()))
    mesh = x.device_mesh
    axes = [a for a, pl in zip(mesh.mesh_dim_names, x.placements) if pl.is_shard()]
    return psum(torch.sum(torch.square(x.to_local().float())), axes, mesh)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A leaf's own elements: a DTensor's local shard (its storage), or the
    tensor."""
    return t.to_local() if isinstance(t, DTensor) else t


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The float32 square root correctly rounded, as XLA's: through float64,
    whose root rounds to the right float32.  torch's float32 ``sqrt`` on the
    CPU (its vectorised form) is not always correctly rounded."""
    return torch.sqrt(x.double()).float()


def _slices(t: torch.Tensor):
    """``t`` cut along its leading dim into views of at most UPDATE_CHUNK
    elements (at least one row)."""
    if t.dim() == 0 or t.numel() <= UPDATE_CHUNK:
        yield t
        return
    rows = max(1, UPDATE_CHUNK // (t.numel() // t.shape[0]))
    yield from torch.split(t, rows, dim=0)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig) -> Tuple[Any, dict, dict]:
    """One AdamW step: writes the new parameters into ``params`` and the new
    moments into ``state`` in place; returns (params, state, {"grad_norm",
    "lr"}).  ``grads`` is a tree like ``params``."""
    dev = state["step"].device
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, dev),
                          _f32(cfg.clip_norm, dev) / torch.clamp(gnorm, min=1e-9))
    lr = schedule(cfg, step)
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    one = _f32(1.0, dev)
    bc1 = one - torch.pow(b1, step.float())
    bc2 = one - torch.pow(b2, step.float())
    omb1, omb2 = one - b1, one - b2
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)

    def update(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * b1
        m32 += g * omb1
        v32 = v.float() * b2
        v32 += g * g * omb2
        delta = m32 / bc1
        delta /= _sqrt(v32 / bc2) + eps
        delta += wd * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    flat_g = _tree.leaves(grads)
    flat_m = _tree.leaves(state["m"])
    flat_v = _tree.leaves(state["v"])
    for p, g, m, v in zip(_tree.leaves(params), flat_g, flat_m, flat_v):
        p, g, m, v = (_local(t) for t in (p, g, m, v))
        if all(t.is_contiguous() for t in (p, g, m, v)):
            p, g, m, v = (t.view(-1) for t in (p, g, m, v))
        for sl in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            update(*sl)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
