"""YCSB operations completed in the measured window over its length."""


def read(run):
    w = run["window"]
    return w["ops"] / w["seconds"] if w["seconds"] > 0 and w["ops"] else None
