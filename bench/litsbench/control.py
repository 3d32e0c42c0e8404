"""The control of the check: the reference itself, in the program's place,
holding values in 32 bits (the low half, sign-extended) where the
configurations state 64.  Judged as the program is judged, it must come out
not correct.

    python3 bench/litsbench/control.py --workload <cell> --seeds 1 2 3 --batches 60

replays ``--batches`` batches of the cell's traffic, at the cell's own
sizes, after its warm-up batches, and prints the numbers the check compares.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from litsbench import keysets, reference, traffic  # noqa: E402
from litsbench.harness import Stream  # noqa: E402
from litsbench.spec import Spec  # noqa: E402


def control_counts(cfg: dict, mix: dict, seed: int, n_batches: int, n_warm: int = 0) -> dict:
    """The check's numbers for the control over ``n_batches`` batches of
    the stream after ``n_warm`` warm-up batches, drawn as a run draws them."""
    seed %= 2 ** 64
    keys = keysets.config_keys(cfg)
    rng = np.random.default_rng([seed, 0])
    stored, pool = sorted(keys[: cfg["n_stored"]]), keys[cfg["n_stored"]:]
    values = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, len(stored),
                          dtype=np.int64, endpoint=True)
    block = traffic.draw_block(mix, len(stored), np.random.default_rng([seed, 1]))
    ref = reference.Reference(stored, values, pool)
    ctl = reference.Reference(stored, values, pool, value_bits=32)
    counts = reference.new_counts()
    stream = Stream(block, len(pool))
    for i in range(n_warm + n_batches):
        args = stream.next()
        kind = args[0]
        exp, got = ref.batch(*args), ctl.batch(*args)
        if i < n_warm:
            continue
        if mix["entry"] == "get_batch":
            reference.judge_gets(exp, got["get_found"], got["get_value"], counts)
        else:
            reference.judge_execute(ref, exp, reference.answers_of(ctl, got, len(kind)), counts)
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--batches", type=int, required=True)
    p.add_argument("--warmup", type=int, default=0)
    args = p.parse_args(argv)
    spec = Spec(Path(__file__).resolve().parents[2])
    cell = spec.cell(args.workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    for seed in args.seeds:
        t = time.time()
        counts = control_counts(cfg, mix, seed, args.batches, args.warmup)
        print(json.dumps({"workload": args.workload, "seed": seed, "batches": args.batches,
                          "correct": all(v == 0 for v in counts.values()), "check": counts,
                          "seconds": round(time.time() - t, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
