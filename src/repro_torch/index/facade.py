"""`StringIndex` — the port's application-facing index (read side).

The counterpart of :class:`repro.index.StringIndex` for bulk load and batched
point lookups:

* :class:`IndexConfig` — width, delta-buffer sizing, builder policy and the
  ``device`` everything runs on (default ``"cuda"``; there is no fallback to
  the CPU, pass ``device="cpu"`` for the plain versions).
* :meth:`StringIndex.bulk_load` — paper Sec. 3.1 bulkload to a frozen
  device index; :meth:`StringIndex.from_builder` wraps a loaded builder.
* :meth:`StringIndex.get_batch` / :meth:`StringIndex.get` — point lookups.

The device decides the path: on the card the builder places keys with K2/K1
and lookups walk with K4; on the CPU the plain versions run.  Both give the
reference's answers bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.builder import LITSBuilder, LITSConfig
from repro_torch.core.strings import StringSet
from repro_torch.core.tensor_index import (
    TensorIndex, freeze, lookup_values, pad_queries, search_batch,
)
from repro_torch.kernels._build import resolve_device


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Index policy: sizing, build policy and the device."""

    width: Optional[int] = None          # None: longest bulk-load key + headroom
    delta_capacity: int = 4096           # delta-buffer entry pool size
    delta_bytes: Optional[int] = None    # delta byte pool (None: capacity-derived)
    delta_probes: int = 16               # open-addressing probe bound
    builder: Optional[LITSConfig] = None  # host build policy (cnode cap, HPT shape)
    device: str = "cuda"                 # where the index lives and the kernels run


def _split_np(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    v = np.asarray(vals, np.int64)
    lo = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (v >> 32).astype(np.int32)
    return lo, hi


def _join_values(lo, hi) -> np.ndarray:
    lo = np.asarray(lo, np.int32).view(np.uint32).astype(np.int64)
    hi = np.asarray(hi, np.int32).astype(np.int64)
    return (hi << 32) | lo


class StringIndex:
    """Single-device LITS over the HPT + sub-trie + PMSS hybrid."""

    def __init__(self, builder: Optional[LITSBuilder], ti: TensorIndex,
                 config: IndexConfig):
        self._builder = builder
        self.ti = ti
        self.config = config

    @classmethod
    def bulk_load(cls, keys: Sequence[bytes],
                  values: Optional[np.ndarray] = None,
                  config: Optional[IndexConfig] = None) -> "StringIndex":
        """Paper Sec. 3.1: sample -> HPT -> collision-driven build -> freeze."""
        cfg = config or IndexConfig()
        builder = LITSBuilder(config=cfg.builder, device=cfg.device)
        vals = (np.asarray(values, np.int64) if values is not None
                else np.arange(len(keys), dtype=np.int64))
        builder.bulkload(StringSet.from_list(list(keys)), vals, width=cfg.width)
        return cls.from_builder(builder, cfg)

    @classmethod
    def from_builder(cls, builder: LITSBuilder,
                     config: Optional[IndexConfig] = None) -> "StringIndex":
        """Freeze an already bulk-loaded builder onto ``config.device``."""
        cfg = config or IndexConfig()
        ti = freeze(builder, delta_capacity=cfg.delta_capacity,
                    delta_bytes=cfg.delta_bytes, delta_probes=cfg.delta_probes,
                    device=resolve_device(cfg.device))
        return cls(builder, ti, cfg)

    @property
    def width(self) -> int:
        return self.ti.width

    @property
    def n_entries(self) -> int:
        return self.ti.n_entries

    def nbytes(self) -> int:
        return self.ti.nbytes()

    def get_batch(self, keys: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
        """Point lookups: (found bool mask, int64 values; misses hold 0)."""
        if not keys:
            return np.zeros(0, bool), np.zeros(0, np.int64)
        qb, ql = pad_queries(list(keys), self.ti.width)
        dev = self.ti.device
        found, eid, isd = search_batch(self.ti, torch.from_numpy(qb).to(dev),
                                       torch.from_numpy(ql).to(dev))
        lo, hi = lookup_values(self.ti, eid, isd)
        found, lo, hi = found.cpu().numpy(), lo.cpu().numpy(), hi.cpu().numpy()
        return found, np.where(found, _join_values(lo, hi), 0)

    def get(self, key: bytes) -> Optional[int]:
        found, vals = self.get_batch([key])
        return int(vals[0]) if found[0] else None
