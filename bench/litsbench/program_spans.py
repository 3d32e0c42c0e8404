"""The program's own spans (``repro_torch.spans``), read after a run.

The program keeps a bounded ring of call records, one an outermost span,
each with ``[calls, total_s, self_s]`` a span name, on
``time.perf_counter``, the clock of the harness's batch records.  A window
reader takes the records of the entry-point calls that lie inside the
window, from the first batch's ``t_call`` to the last batch's ``t1``; it
finds nothing (None) in a program without the module, and where the
records found are not one a window batch.
"""
from __future__ import annotations

from typing import List, Optional

ENTRY_SPANS = ("lits.facade.execute", "lits.facade.get_batch")


def _spans():
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans


def window_calls(run) -> Optional[List[dict]]:
    """The window's entry-point call records, one a batch, or None."""
    spans = _spans()
    batches = run["window"]["batches"]
    if spans is None or not batches:
        return None
    recs = [r for r in spans.calls(batches[0]["t_call"], batches[-1]["t1"])
            if r["name"] in ENTRY_SPANS]
    return recs if recs and len(recs) == len(batches) else None


def total(recs: List[dict], name: str, col: int = 1) -> float:
    """Seconds of span ``name`` over ``recs``: its total (``col`` 1) or its
    self time (``col`` 2)."""
    return sum(r["spans"][name][col] for r in recs if name in r["spans"])


def calls_of(recs: List[dict], name: str) -> int:
    return sum(r["spans"][name][0] for r in recs if name in r["spans"])


def per_batch_ms(run, name: str, col: int = 1) -> Optional[float]:
    """Mean host ms a window batch of span ``name`` (``col`` as in
    :func:`total`)."""
    recs = window_calls(run)
    if recs is None:
        return None
    return 1e3 * total(recs, name, col) / len(recs)


def per_merge_ms(run, *names: str) -> Optional[float]:
    """Mean host ms a window merge (``lits.index.merge``) of the spans
    ``names`` (summed); None without a merge."""
    recs = window_calls(run)
    if recs is None:
        return None
    merges = calls_of(recs, "lits.index.merge")
    return 1e3 * sum(total(recs, n) for n in names) / merges if merges else None


def setup_call(run, name: str) -> Optional[dict]:
    """The last record of outermost span ``name`` that closed before the
    window's first batch, or None."""
    spans = _spans()
    batches = run["window"]["batches"]
    if spans is None or not batches:
        return None
    recs = [r for r in spans.calls(None, batches[0]["t0"]) if r["name"] == name]
    return recs[-1] if recs else None
