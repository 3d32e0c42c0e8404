"""Step-function builders + input shardings shared by the train and serve
launchers: the port of :mod:`repro.launch.steps`.

The model holds its parameters (``LMModel`` is an ``nn.Module``), so the
steps take no ``params``: ``train_step(opt_state, batch)`` updates the
model's parameters in place and returns ``(opt_state, metrics)``.

The sharding helpers return DTensor placements on the active mesh
(``distributed/sharding``) wherever the reference returns a
``NamedSharding``, and ``None`` without a mesh.  ``place`` lays a model's
parameters out by ``param_shardings`` (``train_loop.train`` does so under a
mesh); a train step of a placed model takes the global batch and runs this
rank's rows of it.
"""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig, ShapeSpec, input_specs
from repro_torch.distributed.sharding import (
    axis_size, distribute, gather, get_mesh, local_chunk, placements, rules)
from repro_torch.distributed.sharding import spec as logical_spec
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
    summed in the reference's order, ``0 + g1 + g2 ...``, in ``grad_dtype``,
    then divided by ``accum``: in the parameters' ``.grad`` buffers where
    ``grad_dtype`` is their dtype (autograd sums each microbatch's gradient
    into them in place), else in accumulators of ``grad_dtype``, each
    microbatch's gradient cast into them (with ``accum`` = 1 the gradient is
    taken as it is, as the reference takes it).  The metrics are the
    microbatches' mean, then the optimizer's.  Under a mesh each rank runs
    its rows of every microbatch (``local_rows``) and the step is the global
    one: the loss over every rank's tokens, the gradients summed over the
    batch axes into the shards (``sharding.tp_piece``), the norm over every
    shard."""
    def train_step(opt_state, batch):
        params = list(model.parameters())   # place() may have replaced them
        in_grads = accum == 1 or all(p.dtype == grad_dtype for p in params)
        zero_grads(model)
        acc = None if in_grads else [torch.zeros_like(p, dtype=grad_dtype) for p in params]
        ms = []
        for i in range(accum):
            mb = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, metrics = model.loss(local_rows(mb))
            loss.backward()
            ms.append(metrics)
            if acc is not None:
                for a, p in zip(acc, params):
                    a.add_(p.grad.to(grad_dtype))
                    p.grad.zero_()
        metrics = {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}
        summed = [p.grad for p in params] if acc is None else acc
        if accum > 1:
            for g in summed:
                g.div_(accum)
        grad_of = {id(p): g for p, g in zip(params, summed)}
        tree = model.param_tree()
        grads = _tree.map_with_path(lambda _, p: grad_of[id(p)], tree)
        _, opt_state, om = opt_mod.apply_updates(tree, grads, opt_state, opt_cfg)
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


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def _ns(entries):
    return placements(entries) if get_mesh() is not None else None


def _batch_axes_for(batch_size: int):
    """Batch mesh axes actually usable for this batch size (None if B too small)."""
    r = rules()
    if r is None or not r.batch:
        return None
    n = 1
    for a in r.batch:
        n *= axis_size(a)
    if batch_size % n == 0:
        return r.batch
    # try the 'data' axis alone (multi-pod with small batch)
    if "data" in r.batch and batch_size % axis_size("data") == 0:
        return ("data",)
    return None


def batch_shardings(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b = _batch_axes_for(shape.global_batch)
    out = {}
    for k, v in input_specs(cfg, shape).items():
        if k == "cache":
            out[k] = cache_shardings(cfg, shape.global_batch)
        elif k == "pos":
            out[k] = _ns(())
        elif k == "token":
            out[k] = _ns((b,))
        else:
            out[k] = _ns((b,) + (None,) * (v.dim() - 1))
    return out


def cache_shardings(cfg: ArchConfig, batch_size: int) -> dict:
    """KV/SSM cache shardings.  When the batch can't cover the data axes
    (long_500k has B=1), the KV *window* axis is sequence-sharded over them
    instead."""
    st = logical_spec("tp")
    t = st[0] if len(st) else None
    b = _batch_axes_for(batch_size)
    r = rules()
    seq = None if b is not None else (r.batch if r and r.batch else None)
    out = {}
    if cfg.has_attn:
        out["k"] = _ns((None, b, seq, t, None))
        out["v"] = _ns((None, b, seq, t, None))
        if cfg.kv_cache_dtype == "int8":
            out["k_scale"] = _ns((None, b, seq, t))
            out["v_scale"] = _ns((None, b, seq, t))
    if cfg.has_mamba:
        out["conv"] = _ns((None, b, None, t))
        out["ssm"] = _ns((None, b, t, None))
    return out


def param_shardings(model: LMModel) -> dict:
    specs = model.param_specs()
    out = {k: _ns(v) for k, v in specs.items() if k != "blocks"}
    out["blocks"] = {k: _ns(v) for k, v in specs["blocks"].items()}
    return out


def opt_state_shardings(model: LMModel) -> dict:
    ps = param_shardings(model)
    return {"m": ps, "v": ps, "step": _ns(())}


def abstract_opt_state(model: LMModel, opt_cfg: opt_mod.AdamWConfig) -> dict:
    """The optimizer state's shapes and dtypes as meta tensors."""
    z = _tree.map_with_path(
        lambda _, s: torch.empty(s.shape, dtype=opt_cfg.state_dtype, device="meta"),
        model.abstract_params())
    return {"m": z, "v": _tree.map_with_path(lambda _, s: s, z),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def local_rows(batch: dict) -> dict:
    """This rank's rows of ``batch`` over the mesh's batch axes, split as
    the reference's batch sharding splits them; ``batch`` itself without a
    mesh."""
    r = rules()
    if r is None or not r.batch:
        return batch
    out = {}
    for k, v in batch.items():
        if _batch_axes_for(v.shape[0]) != r.batch:
            raise ValueError(f"{k} has {v.shape[0]} rows, which the batch axes {r.batch} "
                             "do not divide")
        out[k] = local_chunk(v, placements((r.batch,)))
    return out


@torch.no_grad()
def place(model: LMModel) -> None:
    """Lay the model's parameters out on the active mesh by
    ``param_shardings``: each becomes a DTensor of which this rank keeps its
    own shards (taken from the whole parameter every rank holds, with no
    communication)."""
    sh = param_shardings(model)
    for name, p in list(model.top.items()):
        model.top[name] = nn.Parameter(distribute(gather(p.detach()), sh[name]))
    for name in model.layer_defs():
        key = name.replace(".", "__")
        p = model.blocks[key].detach()
        model.blocks[key] = nn.Parameter(distribute(gather(p), sh["blocks"][name]))


@torch.no_grad()
def unplace(model: LMModel) -> None:
    """The model's parameters whole again on every rank (a collective where
    they are placed); a model that is not placed is left as it is."""
    for pd in (model.top, model.blocks):
        for name, p in list(pd.items()):
            if isinstance(p, DTensor):
                pd[name] = nn.Parameter(p.full_tensor())
