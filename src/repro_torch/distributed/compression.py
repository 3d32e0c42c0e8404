"""Gradient compression for the data-parallel all-reduce (int8 + error
feedback): the port of :mod:`repro.distributed.compression`.

Wire format: per-leaf int8 mantissa + one f32 scale per leaf.  The all-reduce
runs over the int8 payload widened to int32 (sum of n shards of ±127 fits
easily), cutting DP gradient bytes 4× vs f32 / 2× vs bf16.  Quantization
error is fed back into the next step's gradient (error-feedback/EF-SGD),
which keeps convergence.

``quantize``/``dequantize`` are the reference's bit for bit (``torch.round``
rounds half to even, as ``jnp.round`` does).  ``make_compressed_dp_step`` is
the reference's ``shard_map`` data-parallel step as one process a rank: the
local loss and gradient, then an int8 → int32 ``all_reduce`` over the
``axis`` group of the mesh.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axis_index, axis_size, mesh_scope
from repro_torch.train import _tree


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max().float() / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[str]]:
    """Each leaf quantized: (mantissas, scales, the leaves' paths), in the
    reference's leaf order (its tree definition's counterpart is the paths)."""
    paths = [k for k, _ in _tree.items(grads)]
    pairs = [quantize(g) for g in _tree.leaves(grads)]
    return [q for q, _ in pairs], [s for _, s in pairs], paths


def init_error_state(params):
    return _tree.map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def make_compressed_dp_step(model, opt_cfg, mesh, axis: str = "data"):
    """Pure-DP train step: grads int8-compressed + summed over ``axis``.

    Returns ``step(opt_state, err, batch) -> (opt_state, err, metrics)``:
    ``batch`` is the global batch, of which the rank runs its rows over
    ``axis``; the parameters are every rank's whole copy (the reference's
    ``P()``) and are updated in place, as are ``err`` (the error-feedback
    state, float32, like ``init_error_state``) and the gradients, which hold
    the reconstructed mean afterwards.  The local loss sees no mesh, as the
    reference's ``shard_map`` body."""
    from repro_torch.launch.steps import zero_grads
    from repro_torch.train import optimizer as opt_mod

    n = axis_size(axis, mesh) if axis in mesh.mesh_dim_names else 1
    group = mesh.get_group(axis) if n > 1 else None

    def psum(t):
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    def step(opt_state, err, batch):
        r = axis_index(axis, mesh) if n > 1 else 0
        rows = {k: torch.chunk(v, n, dim=0)[r] for k, v in batch.items()}
        with mesh_scope(None):
            zero_grads(model)
            loss, metrics = model.loss(rows)
            loss.backward()
        params = model.param_tree()
        grads = _tree.map_with_path(lambda _, p: p.grad, params)
        with torch.no_grad():
            for g, e in zip(_tree.leaves(grads), _tree.leaves(err)):
                g32 = g.float() + e
                q, scale = quantize(g32)
                summed = psum(q.to(torch.int32))
                scale_sum = psum(scale.clone())
                g_hat = summed.float() * (scale_sum / n) / n
                e.copy_(g32 - dequantize(q, scale))  # local quantization residual
                g.copy_(g_hat)
        _, opt_state, om = opt_mod.apply_updates(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(om)
        metrics = {k: psum(v.detach().clone()) / n for k, v in metrics.items()}
        return opt_state, err, metrics

    return step
