"""Carry an index or an LM across from the JAX reference.

:func:`tensor_index_from_reference` takes every data field of a
``repro.core.tensor_index.TensorIndex`` as a numpy array (for instance
``{f: np.asarray(getattr(ti, f)) for f in DATA_FIELDS}``) plus its six
static fields, and returns the port's :class:`TensorIndex` on ``device``
with the same contents, a live delta buffer included.

:func:`lm_params_from_reference` loads a reference LM parameter tree into the
port's :class:`~repro_torch.models.LMModel`, and
:func:`lm_cache_from_reference` carries a reference decode cache across, so
that ``decode_step`` can be held to the reference's alone.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tensor_index import (
    DATA_FIELDS, STATIC_FIELDS, TensorIndex, tensor_index_from_arrays,
)
from repro_torch.models import LMModel


def tensor_index_from_reference(arrays: dict, static: dict, device) -> TensorIndex:
    missing = [f for f in DATA_FIELDS if f not in arrays]
    missing += [f for f in STATIC_FIELDS if f not in static]
    if missing:
        raise KeyError(f"reference index lacks fields {missing}")
    return tensor_index_from_arrays(arrays, static, device)


def _tensor(a, device) -> torch.Tensor:
    """A copy of a numpy array (bfloat16 included, as ``np.asarray`` of a JAX
    array gives it) as a tensor of the same dtype on ``device``.  Always a
    copy: ``np.asarray`` of a JAX array may share the JAX buffer, which
    ``decode_step`` would then overwrite in place."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


@torch.no_grad()
def lm_params_from_reference(params: dict, model: LMModel) -> LMModel:
    """Load a reference ``LMModel`` parameter tree, given as numpy arrays
    (``{"embed", "final_ln", "lm_head", ["frontend_proj"], "blocks": {"ln1":
    (L, d), "attn.wq": (L, d, H·hd), ...}}``), into the port's ``model``.
    Each leaf keeps its dtype: a reference built with ``param_dtype=bfloat16``
    loads into a model of ``param_dtype=torch.bfloat16``, bit for bit, and a
    leaf whose dtype is not the model's is refused."""
    flat = {k: v for k, v in params.items() if k != "blocks"}
    flat.update({"blocks." + k: v for k, v in params["blocks"].items()})
    mine = model.params()
    if set(flat) != set(mine):
        raise KeyError(f"reference parameters {sorted(set(flat) ^ set(mine))} "
                       "do not match the model's")
    for name, p in mine.items():
        src = _tensor(flat[name], p.device)
        if src.shape != p.shape or src.dtype != p.dtype:
            raise ValueError(f"{name}: reference {tuple(src.shape)} {src.dtype}, "
                             f"model {tuple(p.shape)} {p.dtype}")
        p.copy_(src)
    return model


def lm_cache_from_reference(cache: dict, device) -> dict:
    """A reference decode cache (numpy arrays: ``k``/``v`` bf16 or int8 with
    bf16 scales, ``ssm`` float32, ``conv`` bf16) as the port's, on ``device``."""
    return {k: _tensor(v, device) for k, v in cache.items()}
