"""The device trace of a bounded sub-window, reduced to plain numbers.

``torch.profiler`` records the host's torch ops and every device operation
(kernels, copies, fills) of the sub-window, which the harness marks with
one ``record_function`` span.  Only the reduction is kept, never the
trace: the device intervals by name, the busy time (the union of the
device intervals), and the device's idle gaps named by what the host was
doing in them (the innermost host op, or the facade call the harness
wraps around each batch when the host is in Python between ops).
"""
from __future__ import annotations

import collections
import re
from typing import Dict, List, Tuple

WINDOW_SPAN = "bench.trace_window"
SPAN_PREFIXES = ("bench.", "facade.")   # the harness's own spans
NOT_KERNELS = ("Memcpy", "Memset")   # device operations that are no kernel


def short_name(name: str) -> str:
    """A device operation's name without its C++ return type, namespaces,
    template arguments and parameter list; a torch kernel's functor, where
    its name has one, in brackets."""
    head = name.replace("(anonymous namespace)::", "").replace("at::native::", "")
    head = re.sub(r"^void |[<(].*$", "", head)
    functor = re.search(r"(\w+)_kernel_cuda", name)
    return (head + (f"[{functor.group(1)}]" if functor else ""))[:96]


def is_span(e) -> bool:
    """A ``record_function`` span: the profiler copies each onto the device's
    timeline as well, where it is no device operation."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(SPAN_PREFIXES)


def _union_us(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Length of the union of ``intervals`` and its pieces, in order."""
    pieces: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if pieces and s <= pieces[-1][1]:
            pieces[-1] = (pieces[-1][0], max(pieces[-1][1], e))
        else:
            pieces.append((s, e))
    return sum(e - s for s, e in pieces), pieces


def reduce_profile(events) -> Dict:
    """``prof.events()`` of one profiled sub-window -> ``window_s``,
    ``busy_s``, ``device_ops`` (name -> [seconds, count]), ``n_kernels``,
    ``idle_gaps`` (what the host did -> seconds), or ``None`` without the
    window's span."""
    from torch.autograd import DeviceType

    span = [e for e in events if e.name == WINDOW_SPAN and e.device_type == DeviceType.CPU]
    if not span:
        return None
    w0, w1 = span[0].time_range.start, span[0].time_range.end
    dev = [e for e in events if e.device_type == DeviceType.CUDA and not is_span(e)]
    ops: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    n_kernels = 0
    for e in dev:
        slot = ops[short_name(e.name)]
        slot[0] += e.time_range.elapsed_us() / 1e6
        slot[1] += 1
        n_kernels += not e.name.startswith(NOT_KERNELS)
    clipped = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev]
    busy_us, pieces = _union_us([(s, e) for s, e in clipped if e > s])
    gaps = []
    edge = w0
    for s, e in pieces + [(w1, w1)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "device_ops": {k: v for k, v in ops.items()}, "n_kernels": n_kernels,
            "idle_gaps": _name_gaps(events, gaps)}


def _name_gaps(events, gaps) -> Dict[str, float]:
    """Idle seconds by the innermost host op running at each gap's middle."""
    import bisect

    from torch.autograd import DeviceType

    host = sorted((e for e in events if e.device_type == DeviceType.CPU
                   and e.name != WINDOW_SPAN), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    out: Dict[str, float] = collections.defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        ev = host[i] if i >= 0 else None
        while ev is not None and ev.time_range.end < mid:
            ev = ev.cpu_parent
        out[ev.name if ev is not None else "harness (no span)"] += (e - s) / 1e6
    return dict(out)


def top(d: Dict, n: int = 10) -> List[list]:
    """The ``n`` largest entries as ``[name, seconds]``, seconds first
    where the value is ``[seconds, count]``."""
    secs = {k: (v[0] if isinstance(v, list) else v) for k, v in d.items()}
    return [[k, s] for k, s in sorted(secs.items(), key=lambda kv: -kv[1])[:n]]
