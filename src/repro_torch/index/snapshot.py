"""Versioned index snapshots: ``TensorIndex`` <-> one ``.npz`` file.

The format is the reference's (:mod:`repro.index.snapshot`), so that a
snapshot written by either package loads in the other and answers the
same.  A numpy ``.npz`` archive whose first member is ``__snapshot_meta__``,
a uint8-encoded JSON header with

* ``magic``   — ``"lits-snapshot"``,
* ``version`` — the format version (``SNAPSHOT_VERSION``),
* ``meta``    — the static fields (``STATIC_FIELDS``),
* ``data_fields`` — the sorted names of the array members,

then one member per data field, base pools and live delta buffer alike,
each with the reference's dtype and shape: ``de_hash`` is uint32 (the port
holds it as int64) and the scalars (``db_used``, ``de_count``,
``delta_overflow``, ``epoch``, ``root_item``) have shape ``()``.  A file
with another magic raises :class:`SnapshotFormatError`; a known magic at an
unsupported version raises :class:`SnapshotVersionError`.  Versions 1-3
load with the fields they lack made as the reference makes them.
"""
from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.tensor_index import (
    DATA_FIELDS, STATIC_FIELDS, TensorIndex, delta_sort_order, tensor_index_from_arrays,
)
from repro_torch.kernels._build import resolve_device

SNAPSHOT_MAGIC = "lits-snapshot"
# v2 adds the delta tombstones (de_tomb), v3 the compaction epoch, v4 the
# sorted delta view (ds_order)
SNAPSHOT_VERSION = 4
SUPPORTED_VERSIONS: Tuple[int, ...] = (1, 2, 3, 4)

_META_KEY = "__snapshot_meta__"
# the reference's dtype of each field where it differs from the port's
_FILE_DTYPES = {"de_hash": np.uint32}


class SnapshotError(Exception):
    """Base class for snapshot load/save failures."""


class SnapshotFormatError(SnapshotError):
    """The file is not a LITS snapshot (missing or garbled header)."""


class SnapshotVersionError(SnapshotError):
    """The file is a LITS snapshot of an unsupported format version."""


def save_index(ti: TensorIndex, path: str) -> None:
    """Write a snapshot of the whole index (base and delta) to ``path``."""
    arrays = {}
    for name in DATA_FIELDS:
        a = getattr(ti, name).cpu().numpy()
        arrays[name] = a.astype(_FILE_DTYPES[name]) if name in _FILE_DTYPES else a
    header = {
        "magic": SNAPSHOT_MAGIC,
        "version": SNAPSHOT_VERSION,
        "meta": {k: int(getattr(ti, k)) for k in STATIC_FIELDS},
        "data_fields": sorted(arrays),
    }
    meta = np.frombuffer(json.dumps(header).encode("utf-8"), dtype=np.uint8)
    # by handle: given a path, np.savez would add ".npz" to it
    with open(path, "wb") as f:
        np.savez_compressed(f, **{_META_KEY: meta}, **arrays)


def load_index(path: str, device="cuda") -> TensorIndex:
    """Read a snapshot written by :func:`save_index` or by the reference's,
    checking its magic and version, onto ``device`` (default the card; pass
    ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        if _META_KEY not in z.files:
            raise SnapshotFormatError(f"{path}: not a LITS snapshot (missing {_META_KEY} header)")
        try:
            header = json.loads(bytes(z[_META_KEY]).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SnapshotFormatError(f"{path}: garbled snapshot header") from e
        if header.get("magic") != SNAPSHOT_MAGIC:
            raise SnapshotFormatError(
                f"{path}: bad magic {header.get('magic')!r} (expected {SNAPSHOT_MAGIC!r})")
        version = header.get("version")
        if version not in SUPPORTED_VERSIONS:
            raise SnapshotVersionError(
                f"{path}: snapshot format version {version!r}; this build supports "
                f"{SUPPORTED_VERSIONS}")
        synth = ((("de_tomb",) if version < 2 else ()) + (("epoch",) if version < 3 else ())
                 + (("ds_order",) if version < 4 else ()))
        missing = [n for n in DATA_FIELDS if n not in z.files and n not in synth]
        if missing:
            raise SnapshotFormatError(f"{path}: snapshot missing pools {missing}")
        arrays = {name: z[name] for name in DATA_FIELDS if name in z.files}
    static = {k: int(header["meta"][k]) for k in STATIC_FIELDS}
    if "de_tomb" not in arrays:  # v1: no deletes existed, every entry is live
        arrays["de_tomb"] = np.zeros(arrays["de_off"].shape[0], bool)
    if "epoch" not in arrays:    # v1/v2: the lineage restarts at epoch 0
        arrays["epoch"] = np.int32(0)
    if "ds_order" not in arrays:  # before v4: made from the delta pools
        arrays["ds_order"] = delta_sort_order(
            *(torch.from_numpy(np.asarray(arrays[n], dt)) for n, dt in (
                ("db_bytes", np.uint8), ("de_off", np.int32), ("de_len", np.int32),
                ("de_count", np.int32))),
            width=static["width"]).numpy()
    return tensor_index_from_arrays(arrays, static, device)
