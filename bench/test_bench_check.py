"""The check that decides ``correct``: the reference agrees with a tiny
index on the CPU on every mix, and comes out not correct for its control
and for each fault planted in the program under a run."""
import numpy as np
import pytest

CELLS = ["url-1m.ycsb-c", "email-400k.ycsb-a", "url-1m.ycsb-e", "email-400k.ycsb-e"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_a_tiny_index(run_tiny, cell):
    rc, res = run_tiny(cell, seed=2**31 + 11)
    assert rc == 0 and res["correct"], res
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert all(v == {"value": 0, "limit": 0} for v in res["check"].values())
    assert "ops_per_s" in res["metrics"] and "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    from litsbench.control import control_counts
    from litsbench.spec import Spec

    spec = Spec(tiny, tiny / "bench")
    c = spec.cell(cell)
    counts = control_counts(spec.config(c["config"]), spec.traffic(c["traffic"]), 5, 4)
    assert sum(counts.values()) > 0, counts


def _state_unchanged(monkeypatch):
    """A write step that returns the index it was given: the masks say the
    ops took effect, the state says they did not."""
    from repro_torch.index import facade

    real = facade.insert_batch

    def insert_batch(ti, *a):
        _, ins, upd = real(ti, *a)
        return ti, ins, upd

    monkeypatch.setattr(facade, "insert_batch", insert_batch)


def _half_left_out(monkeypatch):
    """The entry point serves the first half of each batch and leaves the
    rest out: its gets come back not found, its ops with no result."""
    from repro_torch.index import facade

    real_get, real_exec = facade.StringIndex.get_batch, facade.StringIndex.execute

    def get_batch(self, keys):
        h = len(keys) // 2
        f, v = real_get(self, keys[:h])
        return (np.concatenate([f, np.zeros(len(keys) - h, bool)]),
                np.concatenate([v, np.zeros(len(keys) - h, np.int64)]))

    def execute(self, batch):
        res = real_exec(self, batch[: len(batch) // 2])
        res.results += [facade.OpResult(facade.Status.NOT_FOUND)] * (len(batch) - len(res.results))
        return res

    monkeypatch.setattr(facade.StringIndex, "get_batch", get_batch)
    monkeypatch.setattr(facade.StringIndex, "execute", execute)


def _answer_altered(monkeypatch):
    """One value altered where it is produced: the first row of every
    value fetch has its low word off by one; scans' keys are altered by
    dropping each window's last entry."""
    from repro_torch.index import facade

    real_lookup, real_group = facade.lookup_values, facade.StringIndex._scan_group

    def lookup_values(ti, eid, isd):
        lo, hi = real_lookup(ti, eid, isd)
        lo = lo.clone()
        lo.view(-1)[:1] += 1
        return lo, hi

    def _scan_group(self, group, window, pool, ent_off, ent_len, results):
        real_group(self, group, window, pool, ent_off, ent_len, results)
        for i, _ in group:
            results[i] = facade.OpResult(results[i].status, entries=results[i].entries[:-1])

    monkeypatch.setattr(facade, "lookup_values", lookup_values)
    monkeypatch.setattr(facade.StringIndex, "_scan_group", _scan_group)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}
# a step that leaves the state unchanged shows only where a batch writes
# and a later op reads what it wrote: not in the read-only mix
CASES = [(c, f) for c in CELLS for f in FAULTS if not (f == "state_unchanged" and "ycsb-c" in c)]


@pytest.mark.parametrize("cell, fault", CASES)
def test_each_fault_makes_the_run_not_correct(run_tiny, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    rc, res = run_tiny(cell, seed=2**31 + 12)
    # a run that cannot finish (YCSB E's warm-up waits for a merge that an
    # unchanged state never reaches) prints no result: not correct either
    assert rc != 0 or res["correct"] is False
    assert rc != 0 or any(v["value"] > v["limit"] for v in res["check"].values())
