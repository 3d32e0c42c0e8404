"""Step-function builders shared by the train and serve launchers: the port
of :mod:`repro.launch.steps`.

The model holds its parameters (``LMModel`` is an ``nn.Module``), so the
steps take no ``params``: ``train_step(opt_state, batch)`` updates the
model's parameters in place and returns ``(opt_state, metrics)``.  The
sharding helpers (``param_shardings``, ``batch_shardings``,
``cache_shardings``, ``opt_state_shardings``, ``abstract_opt_state``) come
with the mesh in the multi-card slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import LMModel
from repro_torch.train import _tree
from repro_torch.train import optimizer as opt_mod


def choose_accum(cfg: ArchConfig, shape: ShapeSpec, n_batch_shards: int = 16,
                 act_budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation factor so rematerialized per-layer residuals fit.

    Saved activations/device ≈ L × (B·S/accum/shards) × d × 2B; pick the
    smallest power-of-two accum that brings this under ``act_budget_bytes``
    while keeping the microbatch divisible by the batch shards.
    """
    B, S = shape.global_batch, shape.seq_len
    need = cfg.n_layers * B * S * cfg.d_model * 2 / (n_batch_shards * act_budget_bytes)
    accum = 1
    while accum < need and (B // (accum * 2)) >= n_batch_shards:
        accum *= 2
    return accum


def zero_grads(model: LMModel) -> None:
    """Give every parameter a zeroed ``.grad`` buffer, kept across steps (the
    stacked ones take each layer's gradient into their slices in place)."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()


def make_train_step(model: LMModel, opt_cfg: opt_mod.AdamWConfig, accum: int = 1,
                    grad_dtype=torch.float32):
    """Train step with gradient accumulation over ``accum`` microbatches (the
    batch's rows cut into ``accum`` consecutive groups).  The gradients are
    summed in the reference's order, ``0 + g1 + g2 ...``, in the parameters'
    ``.grad`` buffers, then divided by ``accum``; the metrics are the
    microbatches' mean, then the optimizer's."""
    if grad_dtype != torch.float32:
        raise ValueError(f"grad_dtype {grad_dtype}: the port accumulates in the float32 "
                         "parameters' .grad (bf16 parameters come with the multi-card slice)")

    def train_step(opt_state, batch):
        zero_grads(model)
        ms = []
        for i in range(accum):
            mb = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, metrics = model.loss(mb)
            loss.backward()
            ms.append(metrics)
        metrics = {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}
        if accum > 1:
            for p in model.parameters():
                p.grad.div_(accum)
        params = model.param_tree()
        grads = _tree.map_with_path(lambda _, p: p.grad, params)
        _, opt_state, om = opt_mod.apply_updates(params, grads, opt_state, opt_cfg)
        metrics.update(om)
        return opt_state, metrics

    return train_step


def make_prefill_step(model: LMModel):
    def prefill_step(batch):
        return model.prefill(batch)

    return prefill_step


def make_decode_step(model: LMModel):
    def serve_step(cache, token, pos):
        return model.decode_step(cache, token, pos)

    return serve_step
