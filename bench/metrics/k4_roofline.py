"""K4's (``fused_search_kernel``, ``csrc/traverse.cu``) share of its
roofline in the traced sub-window: the least time for the bytes its
batches' walks must move (``litsbench.roofline.k4_bytes``: every get's and
every put's walk) over its device time from the trace.  None when the
trace shows no K4."""
import numpy as np

from litsbench import roofline, traffic

KERNEL = "fused_search_kernel"


def read(run):
    p = run["profile"]
    if not p or not p.get("device_ops"):
        return None
    secs = sum(v[0] for k, v in p["device_ops"].items() if KERNEL in k)
    if secs <= 0:
        return None
    nbytes = 0
    for b, got, lens in zip(p["batches"], p["answers"], p["key_lens"]):
        kind = b[0]
        if p["entry"] == "get_batch":
            found = np.asarray(got[0], bool)
            nbytes += roofline.k4_bytes(run["width"], len(kind), lens[found])
            continue
        gets = np.flatnonzero(kind == traffic.READ)
        puts = np.flatnonzero((kind == traffic.UPDATE) | (kind == traffic.INSERT))
        hit = np.array([got[i][0] == "OK" for i in gets], bool)
        if len(gets):
            nbytes += roofline.k4_bytes(run["width"], len(gets), lens[gets][hit])
        if len(puts):
            nbytes += roofline.k4_bytes(run["width"], len(puts), np.zeros(0))
    return 100.0 * roofline.bound_s(nbytes) / secs
