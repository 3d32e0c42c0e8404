"""The builder's exact-placement mode (``LITSConfig.exact_slots``) on the CPU.

The default mode places keys as the JAX reference does, and so loses the
keys of a run whose slot a later run of the same model node overwrites
(``tests/test_torch_index.py::test_lost_keys_reproduced``).  The exact mode
groups every run of a slot into one child, so ``get_batch`` finds every
stored key; where no slot is shared it builds the default mode's pools.  The
counter ``lits.build.bulkload.shared_slot_keys`` counts the keys of the runs
that share a slot, in either mode.  The last test runs K4 on exact-mode pools
on the card and skips without one.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core.builder import SHARED_SLOT_KEYS, LITSBuilder, LITSConfig
from repro_torch.core.strings import StringSet
from repro_torch.core.tensor_index import DATA_FIELDS, STATIC_FIELDS, freeze, pad_queries
from repro_torch.data import synthetic
from repro_torch.index import IndexConfig, StringIndex


def _lost_key_set():
    """The email set of ``tests/test_torch_index.py::_lost_key_builders``,
    whose default bulk load loses keys."""
    return synthetic.DATASETS["email"](np.random.default_rng(4), 20000)


def _load(keys, vals, builder):
    """A CPU index over ``keys`` and its bulk load's counter."""
    idx = StringIndex.bulk_load(keys, vals, IndexConfig(device="cpu", builder=builder))
    rec = [r for r in spans.calls() if r["name"] == "lits.index.bulk_load"][-1]
    return idx, rec["counts"][SHARED_SLOT_KEYS]


def _assert_same_pools(a, b):
    for f in DATA_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in STATIC_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def _keys_in_order(b: LITSBuilder):
    return [b.key_at(int(e)) for e in b.sorted_eids()]


@pytest.fixture(scope="module")
def lossy():
    keys = _lost_key_set()
    vals = np.random.default_rng(5).integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                                             len(keys), dtype=np.int64, endpoint=True)
    default, n_default = _load(keys, vals, None)
    exact, n_exact = _load(keys, vals, {"exact_slots": True})
    return {"keys": keys, "vals": vals, "default": default, "exact": exact,
            "counts": (n_default, n_exact)}


def test_exact_mode_finds_every_stored_key(lossy):
    keys, vals = lossy["keys"], lossy["vals"]
    found, _ = lossy["default"].get_batch(keys)
    assert (~found).sum() > 0                      # the reference's placement loses keys
    exact = lossy["exact"]
    assert exact._builder.cfg.exact_slots is True
    found, got = exact.get_batch(keys)
    want = dict(zip(keys, vals.tolist()))
    assert found.all()
    assert dict(zip(keys, got.tolist())) == want
    absent = [b"zz" + k for k in keys[::40]] + [k[:-1] for k in keys[::40]]
    absent = [k for k in absent if k not in want]
    assert not exact.get_batch(absent)[0].any()
    # the sorted order, which ranks and scans read, holds every key in order,
    # kept from the bulk load or taken anew from a walk of the structure
    assert _keys_in_order(exact._builder) == sorted(keys)
    walked = copy.deepcopy(exact._builder)
    walked._sorted_cache = None
    assert _keys_in_order(walked) == sorted(keys)
    assert walked.scan(b"", len(keys)) == sorted(want.items())
    eids, valid, _ = exact.scan_batch([min(keys)], 16)
    assert bool(valid.all())
    assert [exact._entry_key(int(e)) for e in eids[0]] == sorted(keys)[:16]


def test_shared_slot_keys_counts_what_the_default_mode_can_lose(lossy):
    keys, vals = lossy["keys"], lossy["vals"]
    n_default, n_exact = lossy["counts"]
    misses = int((~lossy["default"].get_batch(keys)[0]).sum())
    assert n_default >= misses > 0 and n_exact > 0
    # the same build from a LITSConfig: the same pools, the same count
    again, n_again = _load(keys, vals, LITSConfig(exact_slots=True))
    assert n_again == n_exact
    _assert_same_pools(again.ti, lossy["exact"].ti)


@pytest.mark.parametrize("recipe", ["email", "url"])
def test_without_a_shared_slot_both_modes_build_the_same_pools(recipe):
    keys = synthetic.DATASETS[recipe](np.random.default_rng(0), 2000)
    vals = np.arange(len(keys), dtype=np.int64) * 3 - 7
    default, n_default = _load(keys, vals, None)
    exact, n_exact = _load(keys, vals, {"exact_slots": True})
    assert n_default == n_exact == 0
    assert exact._builder.cfg.exact_slots and not default._builder.cfg.exact_slots
    _assert_same_pools(default.ti, exact.ti)


def test_a_mapping_and_a_litsconfig_give_the_same_config():
    a = IndexConfig(device="cpu", builder={"exact_slots": True, "cnode_cap": 8})
    b = IndexConfig(device="cpu", builder=LITSConfig(exact_slots=True, cnode_cap=8))
    assert isinstance(a.builder, LITSConfig) and a == b
    assert IndexConfig(device="cpu").builder is None
    with pytest.raises(TypeError):
        IndexConfig(builder={"exact_slot": True})


def test_merges_with_inserts_lose_no_key(lossy, monkeypatch):
    """Two merges of fresh keys around a few stored ones, enough to rebuild
    the model nodes above them: every key, stored and inserted, is found
    with its value, and the sorted order holds them all."""
    keys, vals = lossy["keys"], lossy["vals"]
    rebuilds = []
    real = LITSBuilder._rebuild_at

    def _rebuild_at(self, loc, item):
        rebuilds.append(loc)
        return real(self, loc, item)

    monkeypatch.setattr(LITSBuilder, "_rebuild_at", _rebuild_at)
    cfg = IndexConfig(device="cpu", builder={"exact_slots": True}, delta_capacity=1024,
                      auto_merge_threshold=None)
    idx = StringIndex.from_builder(copy.deepcopy(lossy["exact"]._builder), cfg)
    want = dict(zip(keys, vals.tolist()))
    srt = sorted(keys)
    for cycle in range(2):
        fresh = [k.replace(b"@", b".%d%03d@" % (cycle, i), 1)
                 for k in srt[cycle * 5000: cycle * 5000 + 4] for i in range(90)]
        fresh = [k for k in fresh if k not in want]
        fvals = np.arange(len(fresh), dtype=np.int64) * 11 + cycle
        ins, _, _ = idx.put_batch(fresh, fvals)
        assert ins.all()
        want.update(zip(fresh, fvals.tolist()))
        idx.merge()
        every = list(want)
        found, got = idx.get_batch(every)
        assert found.all()
        assert dict(zip(every, got.tolist())) == want
        assert _keys_in_order(idx._builder) == sorted(want)
    assert rebuilds


@pytest.mark.cuda
def test_cuda_k4_on_exact_pools_matches_plain():
    """K4 walks exact-mode pools built on the card to the plain walk's
    (found, eid, levels), and finds every stored key."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from repro_torch.kernels import traverse

    keys = _lost_key_set()
    b = LITSBuilder(config=LITSConfig(exact_slots=True), device="cuda")
    b.bulkload(StringSet.from_list(keys))
    ti = freeze(b)
    queries = keys + [b"zz" + k for k in keys[::10]] + [k[:-1] for k in keys[::10]]
    qb, ql = (torch.from_numpy(a).to("cuda") for a in pad_queries(queries, ti.width))
    got = traverse.fused_search_cuda(ti, qb, ql)
    want = traverse.fused_search_plain(ti, qb, ql)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert bool(got[0][: len(keys)].all())
