"""Device kernels (every kernel: the hand-written ones and the plain-torch
ones around them) launched in the traced sub-window, per op in it."""


def read(run):
    p = run["profile"]
    if not p or not p.get("n_kernels") or not p.get("ops"):
        return None
    return p["n_kernels"] / p["ops"]
