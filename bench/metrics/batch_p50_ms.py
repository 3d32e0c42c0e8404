"""Median host ms of one entry-point call over the window's batches."""
import numpy as np


def read(run):
    t = [b["t1"] - b["t_call"] for b in run["window"]["batches"]]
    return 1e3 * float(np.percentile(t, 50)) if t else None
