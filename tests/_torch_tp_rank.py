"""One rank of ``tests/test_torch_tp.py``'s gloo group.

Kept apart from the test module so that a spawned rank imports torch and the
port only, not JAX.  Rank ``r`` of four joins a gloo group over
``tcp://127.0.0.1``, then on each ``("data", "model")`` mesh of ``MESHES``
runs every arch of ``ARCHS_TP`` from the reference's initial parameters in
``inp.npz``, placed on the mesh: the forward logits, the loss and the
gradient of every parameter, a prefill and a decode step (a token from the
inputs), one train step, and on meshes whose ``data`` axis has two ranks a
B = 1 decode step on a cache from the inputs whose window is split over
``data``.  It records the local shapes of what it computed with (query
heads, mamba channels, logits, caches, the weights' compute pieces and
stored shards) and writes everything to ``<out_dir>/rank<r>.pkl``: each
rank's own pieces of the logits and caches, the gradients and parameters
gathered whole.
"""
import dataclasses
import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.registry import ARCHS
from repro_torch.distributed.sharding import gather, local_chunk, placements, set_mesh
from repro_torch.launch import steps
from repro_torch.models import LMModel
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.layers import cast_tree
from repro_torch.train import _tree
from repro_torch.train.optimizer import AdamWConfig, init_state

MESHES = [(2, 2), (1, 4)]
ARCH_NAMES = ["chatglm3-6b", "arctic-480b", "falcon-mamba-7b", "hymba-1.5b"]
B, S, DEC_POS = 4, 16, 16          # rows, prompt tokens, the decode step's position
B1_ARCHS = ["chatglm3-6b", "hymba-1.5b"]   # the B = 1 decode with the window split
B1_POS = {"chatglm3-6b": 12, "hymba-1.5b": 13}
OPT = AdamWConfig(lr=1e-3, state_dtype=torch.float32, warmup_steps=1, total_steps=10)


def arch_cfg(name):
    """The reduced arch; chatglm3 with the reference smoke's tp=2 (4 query
    heads, 2 KV heads)."""
    cfg = ARCHS[name].reduced()
    return dataclasses.replace(cfg, tp=2) if name == "chatglm3-6b" else cfg


def load(model, inp, arch):
    prefix = f"init/{arch}/"
    with torch.no_grad():
        for k, p in _tree.items(model.param_tree()):
            p.copy_(torch.from_numpy(inp[prefix + k]))


def shape_probe(rec: dict):
    """Wrap the attention and the SSM scan to record the local query heads
    and mamba channels each rank computes with."""
    flash, scan = TT.flash_attention, TS._ssm_inner

    def flash_rec(q, k, v, **kw):
        rec["q_heads"], rec["kv_heads"] = q.shape[2], k.shape[2]
        return flash(q, k, v, **kw)

    def scan_rec(u, *a, **kw):
        rec["channels"] = u.shape[2]
        return scan(u, *a, **kw)

    TT.flash_attention, TS._ssm_inner = flash_rec, scan_rec
    return lambda: (setattr(TT, "flash_attention", flash), setattr(TS, "_ssm_inner", scan))


def b1_cache(inp, arch, cfg, mesh):
    """This rank's piece of the B = 1 cache of the inputs: its slots of the
    window over ``data``, its KV heads and channels over ``model``."""
    out = {}
    m = mesh.size(1)
    r = mesh.get_local_rank("model")
    for k in ("k", "v", "ssm", "conv"):
        key = f"b1/{arch}/cache/{k}"
        if key not in inp:
            continue
        t = torch.from_numpy(inp[key])
        if k in ("k", "v"):
            t = t.view(torch.bfloat16) if t.dtype == torch.int16 else t
            t = local_chunk(t, placements((None, None, ("data",)), mesh), mesh)
            if cfg.n_kv_padded % m:
                kv = r * (cfg.n_heads_padded // m) // (cfg.n_heads_padded // cfg.n_kv_padded)
                t = t[:, :, :, kv:kv + 1]
            else:
                t = local_chunk(t, placements((None, None, None, ("model",)), mesh), mesh)
        elif k == "conv":
            t = local_chunk(t.view(torch.bfloat16), placements((None, None, None, ("model",)),
                                                               mesh), mesh)
        else:
            t = local_chunk(t, placements((None, None, ("model",)), mesh), mesh)
        out[k] = t.contiguous().clone()
    return out


def arch_cases(inp, tag, arch, mesh, out):
    cfg = arch_cfg(arch)
    key = f"{tag}/{arch}"
    batch = {k: torch.from_numpy(inp[f"batch/{arch}/{k}"]) for k in ("tokens", "labels")}
    model = LMModel(cfg, device="cpu")
    load(model, inp, arch)
    steps.place(model)
    rec = {}
    restore = shape_probe(rec)
    try:
        with torch.no_grad():
            out[f"{key}/logits"] = model.forward(steps.local_rows(batch)).numpy()
        steps.zero_grads(model)
        loss, met = model.loss(steps.local_rows(batch))
        loss.backward()
        out[f"{key}/loss"] = float(met["loss"])
        for k, p in _tree.items(model.param_tree()):
            out[f"{key}/grad/{k}"] = gather(p.grad).numpy()
            out[f"{key}/shard/{k}"] = tuple(p.to_local().shape)
        with torch.no_grad():
            pieces = model._local_params(cast_tree(model.layer(0)))
        out[f"{key}/pieces"] = {k: tuple(v.shape) for k, v in pieces.items()}
        out[f"{key}/probe"] = dict(rec)
        with torch.no_grad():
            cache, last = model.prefill(steps.local_rows({"tokens": batch["tokens"]}),
                                        max_len=S + 2)
            out[f"{key}/prefill/logits"] = last.float().numpy()
            for k, v in cache.items():   # copies: the decode step writes the cache in place
                out[f"{key}/prefill/cache/{k}"] = v.float().numpy().copy()
            tok = steps.local_rows({"t": torch.from_numpy(inp[f"batch/{arch}/decode"])})["t"]
            _, dec = model.decode_step(cache, tok, DEC_POS)
            out[f"{key}/decode/logits"] = dec.float().numpy()
            if tag == "2x2" and arch in B1_ARCHS:
                c1 = b1_cache(inp, arch, cfg, mesh)
                tok1 = torch.from_numpy(inp[f"b1/{arch}/token"])
                _, dec1 = model.decode_step(c1, tok1, B1_POS[arch], seq_axes=("data",))
                out[f"{key}/b1/logits"] = dec1.float().numpy()
                out[f"{key}/b1/window"] = c1["k"].shape[2]
    finally:
        restore()
    # one train step, last: it moves the parameters
    state = init_state(model.param_tree(), OPT)
    _, met = steps.make_train_step(model, OPT)(state, batch)
    out[f"{key}/step/loss"] = float(met["loss"])
    out[f"{key}/step/grad_norm"] = float(met["grad_norm"])
    for k, p in _tree.items(model.param_tree()):
        out[f"{key}/step/params/{k}"] = gather(p).detach().numpy()


def rank_main(rank, world, port, inp_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        inp = dict(np.load(inp_path))
        out = {}
        for shape in MESHES:
            tag = "x".join(map(str, shape))
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            set_mesh(mesh)
            try:
                for arch in ARCH_NAMES:
                    arch_cases(inp, tag, arch, mesh, out)
            finally:
                set_mesh(None)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
