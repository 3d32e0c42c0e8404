"""The plain reference: the index's semantics as a sorted key list, a live
mask and a value per key, in NumPy and Python only.

It imports nothing of the program and takes nothing the program made: it
is given the keys, values and op arrays the benchmark drew from the seed,
and works out every answer itself.  The program's answers reach it only to
be judged (:func:`judge_gets`, :func:`judge_execute`).

Semantics (the configuration files' ``guarantees``): a batch applies its
puts in op order (a put of a live key updates it, of any other key inserts
it), then answers its gets, then its scans, all against the index after the
batch's puts; a scan of length L from key s returns the first L live keys
at or after s in byte order, with their values; values are 64-bit.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import traffic

# the names of the statuses the judge expects, as the program spells them
OK, NOT_FOUND = "OK", "NOT_FOUND"
# the status that refuses a put (delta pools full): the op failed (counted
# in ``failed``) and did not take effect, so the reference does not apply it
REFUSALS = ("REJECTED_FULL",)


class Reference:
    """The live key set over a universe of every key a run can name.

    ``value_bits=32`` is the control: values held in their low 32 bits,
    sign-extended, as a store of 32-bit values would return them."""

    def __init__(self, stored: Sequence[bytes], values: np.ndarray,
                 pool: Sequence[bytes], value_bits: int = 64):
        universe = np.array(list(stored) + list(pool), dtype=object)
        order = np.argsort(universe, kind="stable")
        self.keys: List[bytes] = universe[order].tolist()
        rank = np.empty(len(universe), np.int64)
        rank[order] = np.arange(len(universe))
        self.stored_rank = rank[: len(stored)]
        self.pool_rank = rank[len(stored):]
        self.live = np.zeros(len(universe), bool)
        self.live[self.stored_rank] = True
        self.value_bits = value_bits
        self.vals = np.zeros(len(universe), np.int64)
        self.vals[self.stored_rank] = self._held(np.asarray(values, np.int64))

    def _held(self, v: np.ndarray) -> np.ndarray:
        if self.value_bits == 64:
            return v
        return v.astype(np.int32)   # wraps: the low 32 bits, sign-extended

    def batch(self, kind: np.ndarray, key: np.ndarray, value: np.ndarray,
              length: np.ndarray, insert_ids: np.ndarray,
              refused: np.ndarray | None = None) -> dict:
        """Apply one batch and return what it must answer, by op position:
        ``put_updated`` (puts, in op order: True where the key was live),
        ``get_found``/``get_value`` (gets), ``scan_ranks`` (a list of rank
        arrays, one a scan).  ``insert_ids`` names the never-stored key each
        insert takes; ``refused`` marks puts the program refused."""
        rank = self.rank_of(kind, key, insert_ids)
        put = np.flatnonzero((kind == traffic.UPDATE) | (kind == traffic.INSERT))
        if refused is not None:
            put = put[~refused[put]]
        pr = rank[put]
        first = np.zeros(len(pr), bool)
        first[np.unique(pr, return_index=True)[1]] = True
        updated = self.live[pr] | ~first
        last = len(pr) - 1 - np.unique(pr[::-1], return_index=True)[1]
        self.live[pr[last]] = True
        self.vals[pr[last]] = self._held(value[put][last])
        get = np.flatnonzero(kind == traffic.READ)
        out = {"put_pos": put, "put_updated": updated, "get_pos": get,
               "get_found": self.live[rank[get]].copy(),
               "get_value": np.where(self.live[rank[get]], self.vals[rank[get]], 0)}
        scan = np.flatnonzero(kind == traffic.SCAN)
        if len(scan):
            live = np.flatnonzero(self.live)
            at = np.searchsorted(live, rank[scan])
            out["scan_pos"] = scan
            out["scan_ranks"] = [live[a: a + n] for a, n in zip(at, length[scan])]
        return out

    def rank_of(self, kind, key, insert_ids) -> np.ndarray:
        """The universe rank each op names."""
        rank = self.stored_rank[key]
        ins = kind == traffic.INSERT
        rank[ins] = self.pool_rank[insert_ids]
        return rank

    def entries(self, ranks: np.ndarray) -> Tuple[Tuple[bytes, int], ...]:
        """A scan window as ``(key, value)`` pairs."""
        return tuple(zip([self.keys[r] for r in ranks.tolist()], self.vals[ranks].tolist()))


def new_counts() -> Dict[str, int]:
    """The numbers a run compares, each against the limit 0."""
    return {"wrong_gets": 0, "wrong_puts": 0, "wrong_scans": 0, "unanswered": 0}


def judge_gets(exp: dict, found: np.ndarray, values: np.ndarray, counts: dict) -> None:
    """A ``get_batch``'s answers (found mask, values) against the reference's."""
    if found.shape != exp["get_found"].shape or values.shape != exp["get_value"].shape:
        counts["unanswered"] += len(exp["get_found"])
        return
    bad = (found != exp["get_found"]) | (found & (values != exp["get_value"]))
    counts["wrong_gets"] += int(bad.sum())


def judge_execute(ref: Reference, exp: dict, got: Sequence, counts: dict) -> None:
    """An ``execute`` batch's answers, one ``(status, value, updated,
    entries)`` tuple an op in op order (``None`` where none came), against
    the reference's.  Gets answer OK with the value or NOT_FOUND; puts OK,
    updated where the key was live; scans OK with the window."""
    for p, upd in zip(exp["put_pos"].tolist(), exp["put_updated"].tolist()):
        g = got[p]
        if g is None:
            counts["unanswered"] += 1
        elif g[0] != OK or bool(g[2]) != upd:
            counts["wrong_puts"] += 1
    for p, f, v in zip(exp["get_pos"].tolist(), exp["get_found"].tolist(),
                       exp["get_value"].tolist()):
        g = got[p]
        if g is None:
            counts["unanswered"] += 1
        elif (g[0], g[1]) != ((OK, v) if f else (NOT_FOUND, None)):
            counts["wrong_gets"] += 1
    for p, ranks in zip(exp.get("scan_pos", ()), exp.get("scan_ranks", ())):
        g = got[p]
        if g is None:
            counts["unanswered"] += 1
        elif g[0] != OK or g[3] != ref.entries(ranks):
            counts["wrong_scans"] += 1


def answers_of(ref: Reference, exp: dict, n_ops: int) -> List[tuple]:
    """The reference's own answers in the program's ``(status, value,
    updated, entries)`` form: the control's output when ``ref`` is the
    control."""
    got: List[tuple] = [None] * n_ops
    for p, upd in zip(exp["put_pos"].tolist(), exp["put_updated"].tolist()):
        got[p] = (OK, None, upd, None)
    for p, f, v in zip(exp["get_pos"].tolist(), exp["get_found"].tolist(),
                       exp["get_value"].tolist()):
        got[p] = (OK, v, False, None) if f else (NOT_FOUND, None, False, None)
    for p, ranks in zip(exp.get("scan_pos", ()), exp.get("scan_ranks", ())):
        got[p] = (OK, None, False, ref.entries(ranks))
    return got
