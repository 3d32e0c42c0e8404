"""YCSB core workloads A-F over string keys (paper Sec. 4.1).

A (50r/50u), B (95r/5u), C (100r), D (95 latest-read/5 insert),
E (95 short-scan/5 insert), F (50r/50 rmw); plus insert-only and delete-only.
Key choice uniform or zipf(1.0), as in the paper.  A copy of
:mod:`repro.data.ycsb`: the same ``seed`` gives the same ops.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

MIXES = {
    "A": {"read": 0.5, "update": 0.5},
    "B": {"read": 0.95, "update": 0.05},
    "C": {"read": 1.0},
    "D": {"read_latest": 0.95, "insert": 0.05},
    "E": {"scan": 0.95, "insert": 0.05},
    "F": {"read": 0.5, "rmw": 0.5},
    "insert-only": {"insert": 1.0},
    "delete-only": {"delete": 1.0},
}


@dataclasses.dataclass
class Op:
    kind: str
    key: bytes
    value: int = 0
    scan_len: int = 0


def _zipf_ranks(rng, n_items: int, count: int, theta: float = 1.0) -> np.ndarray:
    # standard zipf over item ranks, truncated to n_items
    r = rng.zipf(max(theta, 1.01), size=count)
    return np.minimum(r - 1, n_items - 1)


def generate(
    workload: str,
    loaded_keys: List[bytes],
    new_keys: List[bytes],
    n_ops: int,
    dist: str = "uniform",
    seed: int = 0,
    scan_len: int = 16,
) -> List[Op]:
    mix = MIXES[workload]
    rng = np.random.default_rng(seed)
    kinds = list(mix)
    probs = np.array([mix[k] for k in kinds])
    choices = rng.choice(len(kinds), size=n_ops, p=probs / probs.sum())
    if dist == "zipf":
        ranks = _zipf_ranks(rng, len(loaded_keys), n_ops)
    else:
        ranks = rng.integers(0, len(loaded_keys), n_ops)
    ops: List[Op] = []
    insert_ptr = 0
    recent: List[bytes] = []
    del_ptr = 0
    for i in range(n_ops):
        kind = kinds[choices[i]]
        if kind in ("read", "update", "rmw"):
            ops.append(Op(kind, loaded_keys[ranks[i]], value=int(rng.integers(0, 1 << 31))))
        elif kind == "read_latest":
            pool = recent if recent else loaded_keys
            ops.append(Op("read", pool[int(rng.integers(0, len(pool)))]))
        elif kind == "insert":
            if insert_ptr < len(new_keys):
                k = new_keys[insert_ptr]
                insert_ptr += 1
                recent.append(k)
                if len(recent) > 1024:
                    recent.pop(0)
                ops.append(Op("insert", k, value=int(rng.integers(0, 1 << 31))))
            else:
                ops.append(Op("read", loaded_keys[ranks[i]]))
        elif kind == "scan":
            ops.append(Op("scan", loaded_keys[ranks[i]], scan_len=scan_len))
        elif kind == "delete":
            if del_ptr < len(loaded_keys):
                ops.append(Op("delete", loaded_keys[ranks[i]]))
                del_ptr += 1
    return ops
