"""The port's baseline models, host-model builders and host analysis helpers
against the JAX package, on the CPU.

SM, RS (its knots too) and SRMI values, ``unique_rate`` and ``hpt_values``
on random strings and two ``data/synthetic.py`` sets; builders with an RS or
SRMI host model under ``AlwaysLIT``: every pool, ``host_search`` of stored
and missing keys, ``heights()``, a bulk insert and the frozen index; the
host ``scan`` and ``space_bytes`` of an HPT builder and a host-model
builder; ``get_cdf_np64`` and ``conditional_prob_error``.  Every result is
equal, array for array (float64 host arithmetic).  ``is_sorted`` is held to
memcmp order.
"""
import numpy as np
import pytest

from repro.core import baselines as r_base
from repro.core import builder as r_builder
from repro.core import hpt as r_hpt
from repro.core.pmss import AlwaysLIT as RAlwaysLIT
from repro.core.strings import StringSet as RStringSet, random_strings
from repro.core.tensor_index import freeze as r_freeze
from repro_torch.core import baselines as t_base
from repro_torch.core import builder as t_builder
from repro_torch.core import hpt as t_hpt
from repro_torch.core import strings as t_strings
from repro_torch.core import tensor_index as t_ti
from repro_torch.core.pmss import AlwaysLIT
from repro_torch.core.strings import StringSet
from repro_torch.data import synthetic

POOLS = ("key_bytes", "ent_off", "ent_len", "ent_val", "items", "mn_slot_base", "mn_slot_cnt",
         "mn_prefix_off", "mn_prefix_len", "mn_alpha", "mn_beta", "mn_nkeys", "cn_base",
         "cn_cnt", "ch_hash", "ch_ent", "tr_byte", "tr_mask", "tr_left", "tr_right")


def _keys(name):
    """Sorted unique keys: random strings, or a synthetic set made once
    and handed to both packages."""
    if name == "random":
        return sorted(set(random_strings(np.random.default_rng(7), 900, 2, 30)))
    return synthetic.load(name, 900, seed=3)


def _sets(keys):
    return (RStringSet.from_list(keys), StringSet.from_list(keys))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("name", ["random", "email", "url"])
def test_models_unique_rate_and_hpt_values_equal_reference(name):
    rss, tss = _sets(_keys(name))
    rm = [r_base.SMModel(), r_base.RSModel(error_bound=31).fit(rss), r_base.SRMIModel(64).fit(rss)]
    tm = [t_base.SMModel(), t_base.RSModel(error_bound=31).fit(tss), t_base.SRMIModel(64).fit(tss)]
    _same(rm[1].knots_x, tm[1].knots_x)
    _same(rm[1].knots_y, tm[1].knots_y)
    rh = r_hpt.build_hpt(rss, rows=256, cols=128)
    th = t_hpt.build_hpt(tss, rows=256, cols=128)
    for start in (0, 3):
        values = [(a.values(rss, start), b.values(tss, start)) for a, b in zip(rm, tm)]
        values.append((r_base.hpt_values(rh, rss, start), t_base.hpt_values(th, tss, start)))
        for want, got in values:
            _same(want, got)
            for sf in (0.5, 1.0, 4.0):
                assert r_base.unique_rate(want, sf) == t_base.unique_rate(got, sf)
    assert r_base.unique_rate(np.zeros(0), 2.0) == t_base.unique_rate(np.zeros(0), 2.0)
    assert r_base.unique_rate(np.ones(5), 2.0) == t_base.unique_rate(np.ones(5), 2.0)


def test_host_float64_helpers_equal_reference():
    keys = _keys("email")
    rss, tss = _sets(keys)
    rh = r_hpt.build_hpt(rss, rows=512, cols=128)
    th = t_hpt.build_hpt(tss, rows=512, cols=128)
    for start, steps in ((0, 64), (2, 5), (40, 64)):
        _same(r_hpt.get_cdf_np64(rh, rss, start, steps), t_hpt.get_cdf_np64(th, tss, start, steps))
    for prefix in (b"", b"a", keys[0][:3], keys[5][:6], b"\x7f\x7f"):
        for min_count in (1, 50):
            want = r_hpt.conditional_prob_error(rh, rss, prefix, min_count)
            got = t_hpt.conditional_prob_error(th, tss, prefix, min_count)
            assert want == got or (np.isnan(want) and np.isnan(got))



def test_is_sorted_is_memcmp_order():
    """``is_sorted`` holds padded rows to memcmp order (the reference's
    intent: its void-view ``<=`` raises under numpy 2, ROADMAP Queue 3)."""
    keys = _keys("random")
    shuffled = [keys[i] for i in np.random.default_rng(1).permutation(len(keys))]
    for ks in (keys, shuffled, keys[:1], [], [b"b", b"a"], [b"a", b"a", b"ab"], [b"ab", b"a"],
               keys[:5] + keys[:5]):
        ss = StringSet.from_list(ks, width=32)
        rows = [bytes(r) for r in ss.bytes]
        assert t_strings.is_sorted(ss) == (rows == sorted(rows))


def _builders(keys, model, lit_only=False):
    """(reference, port) builders bulk-loaded with ``keys``; ``model`` None
    for the HPT, else "rs" or "srmi" fitted on the sorted keys;
    ``lit_only`` builds under ``AlwaysLIT`` (no subtries)."""
    rss, tss = _sets(keys)
    kws = ({"pmss": RAlwaysLIT()}, {"pmss": AlwaysLIT()}) if lit_only else ({}, {})
    for kw, mod, ss in zip(kws, (r_base, t_base), (rss, tss)):
        if model is not None:
            kw["host_model"] = (mod.RSModel(error_bound=15) if model == "rs"
                                else mod.SRMIModel(32)).fit(ss)
    rb = r_builder.LITSBuilder(**kws[0])
    tb = t_builder.LITSBuilder(device="cpu", **kws[1])
    vals = np.arange(len(keys), dtype=np.int64) * 13 - 4
    rb.bulkload(rss, vals)
    tb.bulkload(tss, vals)
    return rb, tb


def _same_pools(rb, tb):
    for name in POOLS:
        _same(getattr(rb, name).view(), getattr(tb, name).view())
    assert (rb.root_item, rb.width, rb.n_keys, rb.max_suffix_len) == \
        (tb.root_item, tb.width, tb.n_keys, tb.max_suffix_len)


def _forbidden(name):
    def call(*args, **kwargs):
        raise AssertionError(f"a host-model builder called {name}")
    return call


@pytest.mark.parametrize("model", ["rs", "srmi"])
def test_host_model_builder_equals_reference(model, monkeypatch):
    keys = _keys("url")
    stored, fresh = keys[::2], keys[1::2][:60]
    # a host model takes the float64 host path: no HPT, no K1 or K2 call
    for name in ("get_cdf", "positions"):
        monkeypatch.setattr(t_builder, name, _forbidden(name))
    rb, tb = _builders(stored, model, lit_only=True)
    assert rb.hpt is None and tb.hpt is None
    _same_pools(rb, tb)
    assert rb.heights() == tb.heights()
    probe = stored[::3] + keys[1::2][::3] + [b"", keys[0] + b"~", b"zz"]
    assert [rb.host_search(k) for k in probe] == [tb.host_search(k) for k in probe]
    # a bulk insert of keys left out walks the model nodes on the host too
    np.testing.assert_array_equal(rb.insert_many(fresh, np.arange(60)),
                                  tb.insert_many(fresh, np.arange(60)))
    _same_pools(rb, tb)
    assert [rb.host_search(k) for k in probe] == [tb.host_search(k) for k in probe]
    rti, tti = r_freeze(rb), t_ti.freeze(tb)
    for f in t_ti.DATA_FIELDS:
        a, b = np.asarray(getattr(rti, f)), getattr(tti, f).numpy()
        assert a.shape == b.shape and (a.astype(np.float64) == b.astype(np.float64)).all(), f


@pytest.mark.parametrize("model", [None, "srmi"])
def test_scan_and_space_bytes_equal_reference(model):
    keys = _keys("email")
    rb, tb = _builders(keys, model)
    assert rb.space_bytes() == tb.space_bytes()
    for begin, count in ((b"", 5), (keys[100], 40), (keys[-3], 10), (keys[-1] + b"~", 4),
                         (keys[50][:4], 1)):
        assert rb.scan(begin, count) == tb.scan(begin, count)
