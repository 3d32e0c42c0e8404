"""The port's ``pad_queries`` (whole-batch packing) against the JAX
package's per-key loop on the CPU: both arrays, their dtypes and shapes,
the ``width + 1`` over-width sentinel, NUL bytes, non-``bytes`` buffers,
and the errors and layout callers rely on."""
import numpy as np
import pytest

from repro.core.tensor_index import pad_queries as r_pad
from repro_torch.core.tensor_index import pad_queries as t_pad
from repro_torch.data.synthetic import gen_email, gen_url


def _buffers(keys):
    """Each key as bytes, bytearray, memoryview or np.bytes_ in turn (an
    np.bytes_ drops trailing NULs, as it does for any caller)."""
    kinds = (bytes, bytearray, memoryview, np.bytes_)
    return [kinds[i % 4](k) for i, k in enumerate(keys)]


_MIXED = [b"abc", b"", b"a\x00b", b"tail\x00\x00", b"x" * 16, b"y" * 17, b"z" * 40]

CASES = {
    "empty_batch": (lambda: [], 16),
    "empty_key": (lambda: [b"", b"k", b""], 16),
    "exact_width": (lambda: [b"w" * 16, b"v" * 15], 16),
    "over_width_sentinel": (lambda: [b"o" * 17, b"p" * 32, b"q" * 16, b"r"], 16),
    "nul_bytes": (lambda: [b"\x00", b"a\x00b\x00c", b"end\x00\x00\x00", b"\x00" * 16,
                           b"\x00" * 17], 16),
    "url_65536": (lambda: gen_url(np.random.default_rng(1), 65_536), 96),
    "email_65536": (lambda: gen_email(np.random.default_rng(2), 65_536), 38),
    "bytearray": (lambda: [bytearray(k) for k in _MIXED], 16),
    "memoryview": (lambda: [memoryview(k) for k in _MIXED], 16),
    "np_bytes": (lambda: [np.bytes_(k) for k in _MIXED], 16),
    "mixed_buffers": (lambda: _buffers(_MIXED * 3), 16),
    "mixed_url": (lambda: _buffers(gen_url(np.random.default_rng(3), 2_000)), 96),
    "width_zero": (lambda: [b"", b"a", b"ab"], 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pad_queries_matches_reference(name):
    make, width = CASES[name]
    keys = make()
    want_b, want_l = r_pad(keys, width)
    got_b, got_l = t_pad(keys, width)
    assert got_b.shape == want_b.shape == (len(keys), width)
    assert got_l.shape == want_l.shape == (len(keys),)
    assert got_b.dtype == want_b.dtype == np.uint8
    assert got_l.dtype == want_l.dtype == np.int32
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_l, want_l)
    # torch.from_numpy shares the rows with the copy to the device
    assert got_b.flags.c_contiguous and got_b.flags.writeable


@pytest.mark.parametrize("keys", [["abc"], [b"ok", "str"], [7], [b"ok", 3]],
                         ids=["str", "str_mixed", "int", "int_mixed"])
def test_pad_queries_refuses_str_and_int(keys):
    with pytest.raises(TypeError):
        r_pad(keys, 16)
    with pytest.raises(TypeError):
        t_pad(keys, 16)
