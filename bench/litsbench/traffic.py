"""YCSB core-workload op streams, drawn in bulk from a seed.

One general generator reads a mix's parameters (``bench/traffic/<mix>.json``):

* ``proportions``: the share of each op kind, of ``read``, ``update``,
  ``insert`` and ``scan`` (YCSB's core workload properties).  Every batch
  holds the same number of each kind, in an order drawn from the seed, so
  seeds change which keys and in what order, not how much work a batch is.
* ``distribution``: how reads, updates and scan starts choose among the
  stored keys: ``zipfian`` (YCSB's scrambled zipfian: a bounded zipfian over
  popularity ranks with ``zipf_constant``, the ranks mapped to keys by a
  permutation drawn from the seed, so the hot keys are spread over the key
  space) or ``uniform``.
* ``scan_length``: ``[lo, hi]``, uniform: each batch's scans take the
  lengths ``lo..hi`` in equal shares, in a drawn order.
* inserts take the never-stored keys in their drawn order, each once.

Ops are arrays, never Python objects: a :class:`Block` of ``block_batches``
batches is drawn in set-up and replayed in turn; reads and updates may
repeat from one replay to the next (an update writes the value it wrote
before), inserts never do: each takes the next never-stored key.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("read", "update", "insert", "scan")
READ, UPDATE, INSERT, SCAN = range(len(KINDS))


@dataclasses.dataclass
class Block:
    """``n_batches`` batches of ``batch`` ops: kind codes, the stored key a
    read, update or scan names (its index in the stored keys), the value an
    update or insert writes, and a scan's length (0 for other kinds)."""

    kind: np.ndarray     # (n_batches, batch) uint8, KINDS codes
    key: np.ndarray      # (n_batches, batch) int64
    value: np.ndarray    # (n_batches, batch) int64
    length: np.ndarray   # (n_batches, batch) int32

    @property
    def n_batches(self) -> int:
        return self.kind.shape[0]


def kind_counts(mix: dict) -> np.ndarray:
    """Ops of each kind in one batch: the proportions of ``mix["batch"]``,
    rounded so that they add up (largest remainders first)."""
    batch = int(mix["batch"])
    share = np.array([float(mix["proportions"].get(k, 0.0)) for k in KINDS])
    unknown = set(mix["proportions"]) - set(KINDS)
    if unknown:
        raise ValueError(f"unknown op kinds {sorted(unknown)}; known: {KINDS}")
    exact = share / share.sum() * batch
    counts = np.floor(exact).astype(np.int64)
    for i in np.argsort(-(exact - counts), kind="stable")[: batch - counts.sum()]:
        counts[i] += 1
    return counts


def zipfian_cdf(n: int, theta: float) -> np.ndarray:
    """The cumulative popularity of ranks ``0..n-1`` under a bounded
    zipfian of constant ``theta`` (YCSB's ``ZipfianGenerator``)."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -theta
    c = np.cumsum(w)
    return c / c[-1]


class KeyChooser:
    """Draws stored-key indices by the mix's distribution."""

    def __init__(self, mix: dict, n_keys: int, rng):
        self.n = n_keys
        self.dist = mix.get("distribution", "zipfian")
        if self.dist == "zipfian":
            self.cdf = zipfian_cdf(n_keys, float(mix.get("zipf_constant", 0.99)))
            self.perm = rng.permutation(n_keys)   # popularity rank -> key
        elif self.dist != "uniform":
            raise ValueError(f"unknown distribution {self.dist!r}")

    def draw(self, rng, size) -> np.ndarray:
        if self.dist == "uniform":
            return rng.integers(0, self.n, size)
        ranks = np.searchsorted(self.cdf, rng.random(size), side="right")
        return self.perm[np.minimum(ranks, self.n - 1)]


def draw_block(mix: dict, n_keys: int, rng) -> Block:
    """The mix's ops for ``mix["block_batches"]`` batches over ``n_keys``
    stored keys."""
    nb, batch = int(mix["block_batches"]), int(mix["batch"])
    counts = kind_counts(mix)
    one = np.repeat(np.arange(len(KINDS), dtype=np.uint8), counts)
    kind = np.stack([rng.permutation(one) for _ in range(nb)])
    key = KeyChooser(mix, n_keys, rng).draw(rng, (nb, batch))
    value = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, (nb, batch),
                         dtype=np.int64, endpoint=True)
    length = np.zeros((nb, batch), np.int32)
    if counts[SCAN]:
        lo, hi = (int(x) for x in mix["scan_length"])
        even = lo + (np.arange(counts[SCAN]) * (hi - lo + 1)) // counts[SCAN]
        for b in range(nb):
            length[b, kind[b] == SCAN] = rng.permutation(even)
    return Block(kind=kind, key=key, value=value, length=length)
