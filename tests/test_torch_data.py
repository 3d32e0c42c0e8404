"""The port's data generators against the JAX package: every generator of
``data/synthetic.py`` and ``ycsb.generate`` (every mix, uniform and zipf
keys) give the reference's output for the same ``np.random.Generator``,
seed and arguments.  (``synthetic.load`` differs on purpose: the reference
seeds from ``hash(name)``, which changes per process.)"""
import numpy as np
import pytest

from repro.data import synthetic as r_syn
from repro.data import ycsb as r_ycsb
from repro_torch.data import synthetic as t_syn
from repro_torch.data import ycsb as t_ycsb

GENERATORS = ["gen_email", "gen_idcard", "gen_phone", "gen_rands", "gen_url", "gen_wiki",
              "gen_address", "gen_names", "gen_reddit", "gen_dblp"]


@pytest.mark.parametrize("name", GENERATORS)
def test_generator_equals_reference(name):
    for seed, n in ((0, 1), (3, 700)):
        want = getattr(r_syn, name)(np.random.default_rng(seed), n)
        got = getattr(t_syn, name)(np.random.default_rng(seed), n)
        assert got == want and len(set(got)) == n


def test_datasets_name_the_same_generators():
    assert list(t_syn.DATASETS) == list(r_syn.DATASETS)
    for name in t_syn.DATASETS:
        assert t_syn.DATASETS[name].__name__ == r_syn.DATASETS[name].__name__


def test_gpkl_targeted_equals_reference():
    want = r_syn.gpkl_targeted(np.random.default_rng(5), 400, 6.0, max_rounds=64)
    got = t_syn.gpkl_targeted(np.random.default_rng(5), 400, 6.0, max_rounds=64)
    assert got == want and got == sorted(set(got))


def test_load_is_stable_and_sorted():
    a, b = t_syn.load("wiki", 300, seed=2), t_syn.load("wiki", 300, seed=2)
    assert a == b == sorted(a) and len(set(a)) == 300


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
@pytest.mark.parametrize("workload", list(r_ycsb.MIXES))
def test_ycsb_generate_equals_reference(workload, dist):
    rng = np.random.default_rng(11)
    loaded = t_syn.gen_email(rng, 500)
    new = t_syn.gen_email(rng, 1200)[500:]
    kw = dict(n_ops=900, dist=dist, seed=4, scan_len=7)
    want = r_ycsb.generate(workload, loaded, new, **kw)
    got = t_ycsb.generate(workload, loaded, new, **kw)
    assert [(o.kind, o.key, o.value, o.scan_len) for o in got] == \
        [(o.kind, o.key, o.value, o.scan_len) for o in want]
    assert t_ycsb.MIXES == r_ycsb.MIXES


def test_zipf_ranks_equal_reference():
    for theta in (0.5, 1.0, 1.3):
        np.testing.assert_array_equal(
            t_ycsb._zipf_ranks(np.random.default_rng(1), 1000, 5000, theta),
            r_ycsb._zipf_ranks(np.random.default_rng(1), 1000, 5000, theta))
