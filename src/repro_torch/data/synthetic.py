"""Synthetic string data sets (paper Sec. 4.1, Table 1) — the generators the
port's tests and ``chip_smoke.py`` use.

The generator functions are copies of :mod:`repro.data.synthetic`: one
``np.random.Generator`` drives both packages to the same key set.  ``load``
differs on purpose: the reference seeds from ``hash(name)``, which Python
randomises per process, so its key sets change from run to run.  Here the
seed comes from a stable digest of the name, and the keys come back sorted.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, List

import numpy as np

_LOWER = b"abcdefghijklmnopqrstuvwxyz"


def _choice_str(rng, alphabet: bytes, n: int) -> bytes:
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), n)].tobytes()


def _words(rng, n_words: int, lo=3, hi=9) -> List[bytes]:
    return [_choice_str(rng, _LOWER, rng.integers(lo, hi)) for _ in range(n_words)]


def gen_email(rng, n: int) -> List[bytes]:
    """Faker-style emails: first.last##@domain.tld (avg ~23B)."""
    first = _words(rng, 400, 3, 8)
    last = _words(rng, 600, 4, 9)
    dom = [b"gmail.com", b"yahoo.com", b"hotmail.com", b"example.org", b"mail.net"]
    out = set()
    while len(out) < n:
        k = b"%s.%s%02d@%s" % (
            first[rng.integers(0, len(first))], last[rng.integers(0, len(last))],
            rng.integers(0, 100), dom[rng.integers(0, len(dom))],
        )
        out.add(k)
    return list(out)


def gen_url(rng, n: int) -> List[bytes]:
    """CommonCrawl-like URLs: one shared scheme prefix + skewed hosts (avg ~64B)."""
    tld = [b".com", b".org", b".net", b".de", b".io"]
    hosts = [b"www." + w + tld[rng.integers(0, len(tld))] for w in _words(rng, max(n // 50, 10), 5, 14)]
    paths = _words(rng, 500, 3, 10)
    out = set()
    while len(out) < n:
        h = hosts[min(int(rng.zipf(1.3)) - 1, len(hosts) - 1)]
        depth = rng.integers(1, 6)
        p = b"/".join(paths[rng.integers(0, len(paths))] for _ in range(depth))
        suffix = b"%d.html" % rng.integers(0, 10000)
        out.add(b"http://" + h + b"/" + p + b"/" + suffix)
    return list(out)


DATASETS: Dict[str, Callable] = {
    "email": gen_email,
    "url": gen_url,
}


def load(name: str, n: int, seed: int = 0) -> List[bytes]:
    """``n`` distinct keys of data set ``name``, sorted; the same in every process."""
    rng = np.random.default_rng((zlib.crc32(name.encode()) & 0xFFFF, seed))
    return sorted(DATASETS[name](rng, n))
