"""Fault-tolerant checkpointing: atomic, rotating, resumable.  The port of
:mod:`repro.train.checkpoint`, in its on-disk format: ``step_%08d/`` holds
``state.npz``, one array per leaf keyed by the ``/``-joined tree path
(``params/blocks/attn.wq``, ``opt/m/embed``, ``opt/step``), and
``meta.json`` (``{"step": ..., **extra}``); the write is atomic (a tmp dir,
then a rename), so a crash mid-write never corrupts the latest checkpoint.
A checkpoint of either package loads in the other.

bfloat16 leaves are written as the reference's ``np.savez`` writes them:
raw 2-byte void records (numpy has no bfloat16).  ``restore`` reads such a
leaf by viewing its bytes as bfloat16; the reference's restore raises on
one (``astype`` has no cast from void), so a bf16 leaf of either package
restores only here.

``restore_latest`` + deterministic data replay (pipeline batches are a pure
function of the step counter) give exactly-once training semantics across
restarts.

A tree of DTensors (a run under a mesh) is saved whole: every rank takes
part in gathering each leaf, rank 0 writes, and every rank returns once the
checkpoint is complete.  So a mesh run resumes without one and the other way
round; ``restore`` gives whole tensors, which the caller places.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from . import _tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A leaf read from a file, as a tensor of ``like``'s dtype and device."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=like.device, dtype=like.dtype)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    flat = {key: _to_numpy(leaf) for key, leaf in _tree.items(tree)}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    placed = any(isinstance(leaf, DTensor) for leaf in _tree.leaves(tree))
    if placed and dist.get_rank() != 0:
        dist.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(extra or {})}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _rotate(ckpt_dir, keep)
    if placed:
        dist.barrier()
    return final


def _rotate(ckpt_dir: str, keep: int) -> None:
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def restore(ckpt_dir: str, step: int, template: Any) -> Tuple[Any, dict]:
    """The checkpoint of ``step`` as a new tree shaped like ``template``, each
    leaf in its template leaf's dtype and on its device; and its meta."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "state.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    def leaf(key, like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        return _to_tensor(flat[key], like)

    return _tree.map_with_path(leaf, template), meta


def restore_latest(ckpt_dir: str, template: Any):
    steps = list_steps(ckpt_dir)
    if not steps:
        return None, None
    return restore(ckpt_dir, steps[-1], template)
