"""Share of the traced sub-window in which no operation ran on the device:
1 - (union of device intervals) / (the sub-window's wall time)."""


def read(run):
    p = run["profile"]
    if not p or not p.get("window_s") or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
