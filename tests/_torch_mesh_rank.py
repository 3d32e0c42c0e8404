"""One rank of ``tests/test_torch_mesh.py``'s gloo group.

Kept apart from the test module so that a spawned rank imports torch and the
port only, not JAX.  Rank ``r`` of four joins a gloo group over
``tcp://127.0.0.1``, then on each ``("data", "model")`` mesh of ``MESHES``
runs the port's mesh paths on the inputs the test wrote (``inp.npz``):
``moe_apply`` in ``ag`` and ``ws`` at two capacity factors, forward and the
gradient of a scalar of it; one ``train_loop.train`` step of the reduced
chatglm3 and llama4 (``auto``, and ``ag`` through ``REPRO_MOE_MODE``); the
local shapes of the placed parameters; and on the (2, 2) mesh three
``make_compressed_dp_step`` steps over its ``data`` axis.  It writes what it
got to ``<out_dir>/rank<r>.pkl``: each rank's own rows of the MoE output and
of the input's gradient, the rest whole.
"""
import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.registry import ARCHS
from repro_torch.distributed.compression import init_error_state, make_compressed_dp_step
from repro_torch.distributed.sharding import distribute, gather, named_sharding, set_mesh
from repro_torch.launch import steps
from repro_torch.models import LMModel
from repro_torch.models.layers import moe_apply
from repro_torch.train import _tree
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_loop import TrainConfig, train

MESHES = [(2, 2), (1, 4), (4, 1)]
ARCH_MODES = [("chatglm3-6b", "auto"), ("llama4-scout-17b-a16e", "auto"),
              ("llama4-scout-17b-a16e", "ag")]
MOE_SPECS = {"router": ("fsdp", None), "wi0": ("tp", None, "fsdp"),
             "wi1": ("tp", None, "fsdp"), "wo": ("tp", "fsdp", None)}
OPT = AdamWConfig(lr=1e-3, state_dtype=torch.float32, warmup_steps=1, total_steps=10)


def params_of(inp, arch):
    """The reference's initial parameters of ``arch`` as a tree of arrays."""
    tree = {"blocks": {}}
    prefix = f"init/{arch}/"
    for k, v in inp.items():
        if k.startswith(prefix):
            name = k[len(prefix):]
            if name.startswith("blocks/"):
                tree["blocks"][name[len("blocks/"):]] = v
            else:
                tree[name] = v
    return tree


def moe_cases(inp, tag, out):
    bf = lambda k: torch.from_numpy(inp[f"moe/{k}"]).to(torch.bfloat16)
    x_all, w_all = bf("x"), torch.from_numpy(inp["moe/w"])
    rows = lambda t: steps.local_rows({"t": t})["t"]
    for mode in ("ag", "ws"):
        for cf in (0.5, 8.0):
            x = rows(x_all).clone().requires_grad_()
            p = {k: distribute(bf(k), named_sharding(*s)).requires_grad_()
                 for k, s in MOE_SPECS.items()}
            y = moe_apply(x, p, top_k=2, capacity_factor=cf, act="swiglu", mode=mode)
            (y.float() * rows(w_all)).sum().backward()
            key = f"moe/{tag}/{mode}/{cf}"
            out[f"{key}/out"] = y.detach().float().numpy()
            out[f"{key}/grad/x"] = x.grad.float().numpy()
            for k, t in p.items():
                out[f"{key}/grad/{k}"] = gather(t.grad).float().numpy()


def train_cases(inp, tag, out):
    for arch, mode in ARCH_MODES:
        model = LMModel(ARCHS[arch].reduced(), device="cpu")
        batch = {k: inp[f"train/{arch}/{k}"] for k in ("tokens", "labels")}
        if mode == "ag":
            os.environ["REPRO_MOE_MODE"] = "ag"
        try:
            res = train(model, lambda s: batch, OPT, TrainConfig(steps=1),
                        params=params_of(inp, arch))
        finally:
            os.environ.pop("REPRO_MOE_MODE", None)
        key = f"train/{tag}/{arch}/{mode}"
        h = res["history"][0]
        out[f"{key}/loss"], out[f"{key}/grad_norm"] = h["loss"], h["grad_norm"]
        for k, v in _tree.items(res["params"]):
            out[f"{key}/params/{k}"] = gather(v).detach().numpy()
            out[f"shapes/{tag}/{arch}/{k}"] = tuple(v.to_local().shape)
            out[f"placements/{tag}/{arch}/{k}"] = tuple(v.placements)
        for k, s in _tree.items(steps.param_shardings(model)):
            out[f"shardings/{tag}/{arch}/{k}"] = tuple(s)


def dp_case(inp, mesh, out):
    arch = "chatglm3-6b"
    model = LMModel(ARCHS[arch].reduced(), device="cpu")
    init = dict(_tree.items(params_of(inp, arch)))
    with torch.no_grad():
        for k, p in _tree.items(model.param_tree()):
            p.copy_(torch.from_numpy(init[k]))
    step = make_compressed_dp_step(model, OPT, mesh)
    state, err = init_state(model.param_tree(), OPT), init_error_state(model.param_tree())
    for i in range(3):
        batch = {k: torch.from_numpy(inp[f"dp/{i}/{k}"]) for k in ("tokens", "labels")}
        state, err, met = step(state, err, batch)
        for k, v in met.items():
            out[f"dp/{i}/{k}"] = float(v)
    for k, v in _tree.items(model.param_tree()):
        out[f"dp/params/{k}"] = v.detach().numpy().copy()
    for k, v in _tree.items(err):
        out[f"dp/err/{k}"] = v.numpy().copy()


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
                moe_cases(inp, tag, out)
                train_cases(inp, tag, out)
            finally:
                set_mesh(None)
            if shape == (2, 2):
                dp_case(inp, mesh, out)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
