"""Deterministic, restart-safe token pipeline + LITS-keyed record store.

The counterpart of :mod:`repro.data.pipeline`.

Fault-tolerance contract: ``batch_at(step)`` is a pure function of the step
counter (counter-mode PRNG), so resuming from a checkpoint replays exactly
the batches the crashed run would have seen — no data-loader state to
persist.  Sharding: each data-parallel host slices its batch rows by
``(host_id, n_hosts)``.  The batches are numpy arrays, equal to the
reference's array for array.

The record store is the LITS integration point for training data: documents
are keyed by string ids; dedup and lookup-by-id run through the index
(paper-faithful usage: bulkload + point lookups).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.index import GetRequest, IndexConfig, PutRequest, Status


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1


class TokenPipeline:
    """Synthetic LM stream (markov-ish mixture so loss visibly decreases)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        self._ngram_next = base.integers(0, v, size=4096).astype(np.int64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rows = c.global_batch // c.n_hosts
        rng = np.random.default_rng((c.seed, step, c.host_id))
        toks = rng.integers(0, c.vocab, size=(rows, c.seq_len + 1), dtype=np.int64)
        # inject learnable structure: deterministic successor for 60% of tokens
        follow = rng.random((rows, c.seq_len)) < 0.6
        nxt = self._ngram_next[toks[:, :-1] % 4096] % c.vocab
        toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class RecordStore:
    """String-keyed document store backed by LITS (paper integration point).

    A client of the :class:`repro_torch.serve.service.IndexService` request
    plane: bulk load at construction, typed ``get`` batches for dedup and
    lookup, delta-buffer ``put`` for incremental inserts — with compaction
    on the service's maintenance thread rather than inline with a lookup or
    insert.  Pass ``service`` to share one request plane (and one
    coalescer) across many pipeline stages.

    ``config`` is the index's :class:`IndexConfig`, and its ``device``
    decides where the index lives (default the card).  The reference's
    ``backend=`` shorthand selects a traversal engine, which the port does
    not have: the device alone decides the path.
    """

    def __init__(self, keys: List[bytes], payloads: Optional[np.ndarray] = None,
                 config: Optional[IndexConfig] = None,
                 service=None, tenant: Optional[str] = None):
        from repro_torch.serve.service import IndexService

        self.tenant = tenant
        self._owns_service = service is None
        if service is None:
            vals = (np.arange(len(keys), dtype=np.int64) if payloads is None
                    else np.asarray(payloads, np.int64))
            # bulk load under the store's tenant namespace so the typed ops
            # (which the service tenant-prefixes) see the corpus
            service = IndexService.bulk_load(
                {tenant or "default": (keys, vals)}, index_config=config)
        elif keys:
            # a passed-in service must ALREADY hold the corpus under
            # `tenant` — silently ignoring `keys` would make every lookup
            # a miss with no error to explain why
            raise ValueError(
                "pass either a corpus to bulk-load (no service) or an "
                "already-loaded service (with tenant=), not both")
        self.service = service

    def lookup_batch(self, keys: List[bytes]):
        """Batched coalesced lookup: returns (found mask, payloads/row ids)."""
        res = self.service.execute([GetRequest(k) for k in keys],
                                   tenant=self.tenant)
        found = np.array([r.status == Status.OK for r in res], bool)
        vals = np.array([r.value if r.ok else 0 for r in res], np.int64)
        return found, vals

    def dedup(self, keys: List[bytes]) -> np.ndarray:
        """Mask of keys NOT already present (the dedup filter)."""
        found, _ = self.lookup_batch(keys)
        return ~found

    def insert(self, key: bytes, payload: int) -> bool:
        """Insert a NEW record; returns False (no write) if the key exists."""
        res = self.service.execute([GetRequest(key)], tenant=self.tenant)
        if res[0].ok:
            return False
        return self.service.execute([PutRequest(key, payload)],
                                    tenant=self.tenant)[0].ok

    def close(self) -> None:
        """Stop the service's threads — only if this store created it."""
        if self._owns_service:
            self.service.close()
