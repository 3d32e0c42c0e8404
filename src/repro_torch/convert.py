"""Carry an index across from the JAX reference.

:func:`tensor_index_from_reference` takes every data field of a
``repro.core.tensor_index.TensorIndex`` as a numpy array (for instance
``{f: np.asarray(getattr(ti, f)) for f in DATA_FIELDS}``) plus its six
static fields, and returns the port's :class:`TensorIndex` on ``device``
with the same contents, a live delta buffer included.
"""
from __future__ import annotations

from repro_torch.core.tensor_index import (
    DATA_FIELDS, STATIC_FIELDS, TensorIndex, tensor_index_from_arrays,
)


def tensor_index_from_reference(arrays: dict, static: dict, device) -> TensorIndex:
    missing = [f for f in DATA_FIELDS if f not in arrays]
    missing += [f for f in STATIC_FIELDS if f not in static]
    if missing:
        raise KeyError(f"reference index lacks fields {missing}")
    return tensor_index_from_arrays(arrays, static, device)
