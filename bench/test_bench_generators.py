"""The key recipes and the op streams: determinism from the seed, the
recipes' statistics, and the scrambled zipfian's spread over the key space."""
import sys
from pathlib import Path

import numpy as np
import pytest

from litsbench import keysets, traffic

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


@pytest.mark.parametrize("recipe", ["url", "email"])
def test_keys_are_deterministic_from_the_seed(recipe):
    a = keysets.distinct_keys(recipe, 3000, np.random.default_rng([2**33 + 5, 0]))
    b = keysets.distinct_keys(recipe, 3000, np.random.default_rng([2**33 + 5, 0]))
    c = keysets.distinct_keys(recipe, 3000, np.random.default_rng([2**33 + 6, 0]))
    assert a == b and a != c
    assert len(set(a)) == 3000 and all(b"\0" not in k for k in a)


@pytest.mark.parametrize("recipe, gen, mean, longest", [
    ("url", "gen_url", (54.0, 58.5), 94), ("email", "gen_email", (23.5, 26.0), 30)])
def test_keys_match_the_recipes_statistics(recipe, gen, mean, longest):
    from repro_torch.data import synthetic

    ours = np.array([len(k) for k in keysets.distinct_keys(recipe, 20000,
                                                           np.random.default_rng(1))])
    theirs = np.array([len(k) for k in getattr(synthetic, gen)(np.random.default_rng(1), 5000)])
    assert mean[0] < ours.mean() < mean[1]
    assert abs(ours.mean() - theirs.mean()) < 1.5
    assert ours.max() <= longest and abs(ours.min() - theirs.min()) <= 6
    assert abs(np.percentile(ours, 90) - np.percentile(theirs, 90)) <= 3


def test_scrambled_zipfian_spreads_the_hot_keys():
    n = 100_000
    mix = {"distribution": "zipfian", "zipf_constant": 0.99}
    draws = traffic.KeyChooser(mix, n, np.random.default_rng(3)).draw(
        np.random.default_rng(4), 400_000)
    counts = np.bincount(draws, minlength=n)
    hot = np.argsort(-counts)[:100]
    # the hottest key takes about 1/H(n, 0.99) of the draws
    assert 0.05 < counts.max() / len(draws) < 0.15
    # and the hot keys lie all over the sorted key space, not at its start
    assert hot.min() < n // 10 and hot.max() > 9 * n // 10
    assert 0.3 * n < np.median(hot) < 0.7 * n


def test_batches_hold_the_proportions_in_a_drawn_order():
    mix = {"batch": 4096, "proportions": {"scan": 0.95, "insert": 0.05},
           "scan_length": [1, 100], "block_batches": 3}
    blk = traffic.draw_block(mix, 1000, np.random.default_rng(5))
    for b in range(3):
        assert (blk.kind[b] == traffic.INSERT).sum() == 205
        lens = np.sort(blk.length[b][blk.kind[b] == traffic.SCAN])
        assert lens.min() == 1 and lens.max() == 100 and abs(lens.mean() - 50.5) < 0.1
    assert not np.array_equal(blk.kind[0], blk.kind[1])
    with pytest.raises(ValueError):
        traffic.kind_counts({"batch": 8, "proportions": {"rmw": 1.0}})
