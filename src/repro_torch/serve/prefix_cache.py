"""LITS-backed prompt cache: exact-match prompt string -> cached KV state.
The port of :mod:`repro.serve.prefix_cache`.

This is the paper's index doing the string-keyed job LLM serving actually
has: request routing by prompt identity.  Keys are prompt byte strings
(tokenizer-independent), values are slot ids in a host-side cache store.

The cache is a client of the :class:`repro_torch.serve.service.IndexService`
request plane: lookups, admissions and evictions are typed op batches
submitted through the coalescer (so concurrent engines sharing one service
ride the same fused dispatches), and ``merge_delta`` compaction happens on
the service's maintenance thread — never inline with a request.  On
``cuda`` every lookup, put and delete walks the base with the fused
traversal kernel.  The GetCDF and locate kernels run only where the
bulk load or a merge builds a model node, which the serving sizes never
do: prompt keys share a prefix and then split on one byte, so the index
is a trie over compact leaves.

``capacity`` is enforced: the slot store holds at most ``capacity`` states,
and admitting past it evicts the least-recently-hit slots through the
index's DELETE path (delta-buffer tombstones).

The index has ``width`` 256 and every key carries the tenant prefix, so a
prompt key longer than about 240 bytes is refused (``REJECTED_OVER_WIDTH``)
and its state is dropped, as in the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.index import (
    DeleteRequest, GetRequest, IndexConfig, PutRequest, Status, StringIndex,
)
from .service import IndexService, ServiceConfig


@dataclasses.dataclass
class PrefixCacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    merges: int = 0     # background (maintenance) compactions of the index

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PrefixCache:
    """Exact-match prompt -> slot id, LITS-indexed, LRU-bounded."""

    # slot ids live in THIS cache's host store, so each cache instance gets
    # its own tenant namespace on the service: two caches sharing one
    # request plane can never resolve each other's slots.  itertools.count
    # is atomic under the GIL — concurrent constructions can't collide.
    _ids = itertools.count()

    def __init__(self, capacity: int = 4096, width: int = 256, seed_keys=None,
                 device: str = "cuda",
                 config: Optional[IndexConfig] = None,
                 service: Optional[IndexService] = None,
                 service_config: Optional[ServiceConfig] = None):
        # `config` is the unified index policy object; the kwargs
        # (capacity/width/device) are defaults folded into it.  `service`
        # lets several caches/engines share one request plane (the cache
        # does not own a passed-in service and close() won't stop it).
        self._owns_service = service is None
        if service is not None and (config is not None or seed_keys
                                    or service_config is not None):
            # a shared service already has its index + plane policy —
            # silently dropping the caller's would apply neither
            raise ValueError(
                "pass either index/service policy (config/seed_keys/"
                "service_config) or an existing service to share, not both")
        if service is None:
            if config is None:
                config = IndexConfig(width=width,
                                     delta_capacity=max(64, capacity),
                                     device=device)
            seed = seed_keys or [b"\x01<prefix-cache-sentinel>"]
            index = StringIndex.bulk_load(seed, config=config)
            service = IndexService(index, service_config or ServiceConfig())
        self.service = service
        self.tenant = f"prefix-cache-{next(PrefixCache._ids)}"
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.store: Dict[int, object] = {}
        self._lru: "OrderedDict[int, bytes]" = OrderedDict()  # slot -> prompt
        self._key_slot: Dict[bytes, int] = {}                 # prompt -> slot
        self._next_slot = 0
        self.stats = PrefixCacheStats()

    def lookup(self, prompts: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (hit mask, slot ids); misses get slot -1."""
        res = self.service.execute([GetRequest(p) for p in prompts],
                                   tenant=self.tenant)
        found = np.array([r.status == Status.OK for r in res], bool)
        slots = np.array([r.value if r.ok else -1 for r in res], np.int64)
        for s in slots[found].tolist():
            if s in self._lru:          # refresh recency on every hit
                self._lru.move_to_end(s)
        self.stats.hits += int(found.sum())
        self.stats.misses += int((~found).sum())
        self.stats.merges = self.service.merge_count
        return found, slots

    def admit(self, prompts: List[bytes], states: List[object]) -> np.ndarray:
        """Insert prompt->state pairs; returns assigned slot ids (-1 = refused).

        Admitting past ``capacity`` first evicts the least-recently-hit
        slots (index DELETE + store drop).  A put can still be refused
        per-op (over-width prompt, full delta pool — `Status.REJECTED_*`):
        those states are dropped again — keeping them would leak an
        unreachable KV entry per refused prompt, since lookup can never
        return its slot.
        """
        # one slot per unique prompt: the index maps a key to ONE slot, so a
        # duplicate admission would strand the earlier state and poison a
        # later eviction (deleting the key while the newer slot still lives).
        # The LAST occurrence wins, matching the index's put-update order.
        canon = {p: i for i, p in enumerate(prompts)}
        admits = [(i, p, st) for i, (p, st) in enumerate(zip(prompts, states))
                  if canon[p] == i]
        self._evict_for(len(admits))
        slot_of = {}
        for _, p, st in admits:
            sid = self._next_slot
            self._next_slot += 1
            self.store[sid] = st
            self._lru[sid] = p
            slot_of[p] = sid
        res = self.service.execute(
            [PutRequest(p, slot_of[p]) for _, p, _ in admits],
            tenant=self.tenant)
        for (_, p, _), r in zip(admits, res):
            if not r.ok:
                sid = slot_of.pop(p)
                self.store.pop(sid, None)
                self._lru.pop(sid, None)
                continue
            if p in self._key_slot:
                # re-admission: the put re-pointed the index at the new
                # slot, so reclaim the stale one NOW — leaving it in the
                # LRU would later evict (DELETE) the key out from under
                # the live slot and strand its state until its own eviction
                old = self._key_slot[p]
                self.store.pop(old, None)
                self._lru.pop(old, None)
            self._key_slot[p] = slot_of[p]
        out = np.asarray([slot_of.get(p, -1) for p in prompts])
        self.stats.inserts += sum(1 for r in res if r.ok and not r.updated)
        self.stats.merges = self.service.merge_count
        return out

    def _evict_for(self, n_new: int) -> None:
        """Make room for ``n_new`` admissions: evict LRU slots via DELETE."""
        excess = len(self.store) + n_new - self.capacity
        if excess <= 0:
            return
        victims: List[Tuple[int, bytes]] = []
        for _ in range(min(excess, len(self._lru))):
            victims.append(self._lru.popitem(last=False))
        res = self.service.execute([DeleteRequest(p) for _, p in victims],
                                   tenant=self.tenant)
        compacted = False
        for (sid, p), r in zip(victims, res):
            if r.status == Status.REJECTED_FULL:
                # tombstone pool is full: force one compaction (the
                # threshold-gated maintenance_step may decline), then retry
                if not compacted:
                    self.service.compact()
                    compacted = True
                r = self.service.execute([DeleteRequest(p)],
                                         tenant=self.tenant)[0]
            if r.status not in (Status.OK, Status.NOT_FOUND):
                # couldn't unpublish (pool still full, queue OVERLOADED,
                # ...): keep the slot — dropping the state while the index
                # still maps the key would hand out a phantom slot id on
                # the next lookup.  Capacity overshoots until a later
                # eviction succeeds.
                self._lru[sid] = p
                self._lru.move_to_end(sid, last=False)
                continue
            self.store.pop(sid, None)
            self._key_slot.pop(p, None)
            self.stats.evictions += 1

    def get_state(self, slot: int):
        return self.store.get(int(slot))

    def close(self) -> None:
        """Stop the service's threads — only if this cache created it (a
        shared request plane belongs to whoever constructed it)."""
        if self._owns_service:
            self.service.close()
