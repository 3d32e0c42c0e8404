"""95th percentile of the host ms of one entry-point call over the
window's batches (none with fewer than 20 batches)."""
import numpy as np


def read(run):
    t = [b["t1"] - b["t_call"] for b in run["window"]["batches"]]
    return 1e3 * float(np.percentile(t, 95)) if len(t) >= 20 else None
