"""K6's (``scan_kernel``, ``csrc/scan.cu``) share of its roofline in the
traced sub-window: the least time for the bytes its scan groups must move
(``litsbench.roofline.k6_bytes``: one group a distinct window length in a
batch) over its device time from the trace.  None when the trace shows no
K6."""
import numpy as np

from litsbench import roofline, traffic

KERNEL = "scan_kernel"


def read(run):
    p = run["profile"]
    if not p or not p.get("device_ops") or p["entry"] != "execute":
        return None
    secs = sum(v[0] for k, v in p["device_ops"].items() if KERNEL in k)
    if secs <= 0:
        return None
    nbytes = 0
    for b, got in zip(p["batches"], p["answers"]):
        kind, length = b[0], b[3]
        scans = np.flatnonzero(kind == traffic.SCAN)
        for w in np.unique(length[scans]):
            rows = scans[length[scans] == w]
            first = [len(got[i][3][0][0]) for i in rows if got[i][3]]
            nbytes += roofline.k6_bytes(run["width"], int(w), len(rows), np.array(first))
    return 100.0 * roofline.bound_s(nbytes) / secs
