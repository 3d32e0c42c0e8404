"""Synthetic string data sets (paper Sec. 4.1, Table 1): the four synthetic
sets of the paper's recipes (email, idcard, phone, rands), generators that
match the published statistics of the seven real-world sets, and
``gpkl_targeted`` (paper Fig. 7: data at a target GPKL).

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

from repro_torch.core.gpkl import gpkl
from repro_torch.core.strings import StringSet, sort_order

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


def gen_idcard(rng, n: int) -> List[bytes]:
    """18-byte Chinese id-card: 6B region + 8B yyyymmdd + 4B unique code."""
    regions = [b"%06d" % r for r in rng.choice(
        np.arange(110000, 659000), size=200, replace=False)]
    out = set()
    while len(out) < n:
        region = regions[rng.integers(0, len(regions))]
        y, m, d = rng.integers(1950, 2010), rng.integers(1, 13), rng.integers(1, 29)
        code = b"%04d" % rng.integers(0, 10000)
        out.add(region + b"%04d%02d%02d" % (y, m, d) + code)
    return list(out)


def gen_phone(rng, n: int) -> List[bytes]:
    """Faker-style phone numbers, 11-23B."""
    out = set()
    fmts = [b"+1-%03d-%03d-%04d", b"0%02d-%04d-%04d", b"(%03d) %03d-%04d", b"+86 %03d %04d %04d"]
    while len(out) < n:
        f = fmts[rng.integers(0, len(fmts))]
        out.add(f % (rng.integers(0, 1000), rng.integers(0, 10000) % 1000
                     if f != fmts[1] else rng.integers(0, 10000), rng.integers(0, 10000)))
    return list(out)


def gen_rands(rng, n: int, lo=2, hi=61) -> List[bytes]:
    """Uniform a-z random strings (paper: 2-61B)."""
    out = set()
    while len(out) < n:
        out.add(_choice_str(rng, _LOWER, rng.integers(lo, hi + 1)))
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


def gen_wiki(rng, n: int) -> List[bytes]:
    """Wiki titles: Capitalized_words_with_underscores (avg ~15B)."""
    vocab = _words(rng, 4000, 3, 10)
    out = set()
    while len(out) < n:
        k = rng.integers(1, 4)
        words = [vocab[min(int(rng.zipf(1.4)) - 1, len(vocab) - 1)] for _ in range(k)]
        words = [w.capitalize() if rng.random() < 0.7 else w for w in [bytes(x) for x in words]]
        t = b"_".join(words)
        if rng.random() < 0.2:
            t += b"_(%d)" % rng.integers(1900, 2024)
        out.add(t)
    return list(out)


def gen_address(rng, n: int) -> List[bytes]:
    """unit-street-city style US-West addresses (avg ~24B)."""
    streets = _words(rng, 800, 4, 10)
    cities = _words(rng, 60, 4, 10)
    sfx = [b" st", b" ave", b" rd", b" blvd"]
    out = set()
    while len(out) < n:
        out.add(b"%d %s%s %s" % (
            rng.integers(1, 9999), streets[rng.integers(0, len(streets))],
            sfx[rng.integers(0, len(sfx))], cities[min(int(rng.zipf(1.5)) - 1, len(cities) - 1)],
        ))
    return list(out)


def gen_names(rng, n: int) -> List[bytes]:
    """imdb/geoname-like proper names (avg ~13B)."""
    first = _words(rng, 1200, 3, 9)
    last = _words(rng, 3000, 4, 11)
    out = set()
    while len(out) < n:
        f = bytes(first[min(int(rng.zipf(1.3)) - 1, len(first) - 1)]).capitalize()
        l = bytes(last[rng.integers(0, len(last))]).capitalize()
        k = f + b" " + l
        if k in out:
            k += b" %s" % _choice_str(rng, _LOWER, 2).capitalize()
        out.add(k)
    return list(out)


def gen_reddit(rng, n: int) -> List[bytes]:
    """reddit usernames: short, moderately skewed prefixes (avg ~11B)."""
    vocab = _words(rng, 2000, 3, 8)
    out = set()
    while len(out) < n:
        w = bytes(vocab[min(int(rng.zipf(1.4)) - 1, len(vocab) - 1)])
        style = rng.integers(0, 4)
        if style == 0:
            k = w + b"_" + bytes(vocab[rng.integers(0, len(vocab))])
        elif style == 1:
            k = w + b"%d" % rng.integers(0, 10000)
        elif style == 2:
            k = b"xX" + w + b"Xx"
        else:
            k = w
        out.add(k)
    return list(out)


def gen_dblp(rng, n: int) -> List[bytes]:
    """paper titles: long, many shared leading words (avg ~76B)."""
    lead = [b"a survey of ", b"towards ", b"on the ", b"learning ", b"efficient ",
            b"a study of ", b"deep ", b"scalable "]
    vocab = _words(rng, 3000, 3, 11)
    out = set()
    while len(out) < n:
        k = lead[min(int(rng.zipf(1.2)) - 1, len(lead) - 1)]
        nw = rng.integers(6, 14)
        k += b" ".join(bytes(vocab[min(int(rng.zipf(1.3)) - 1, len(vocab) - 1)]) for _ in range(nw))
        out.add(k[:255])
    return list(out)


DATASETS: Dict[str, Callable] = {
    "email": gen_email,
    "idcard": gen_idcard,
    "phone": gen_phone,
    "rands": gen_rands,
    "url": gen_url,
    "wiki": gen_wiki,
    "address": gen_address,
    "imdb": gen_names,
    "geoname": gen_names,
    "reddit": gen_reddit,
    "dblp": gen_dblp,
}


def load(name: str, n: int, seed: int = 0) -> List[bytes]:
    """``n`` distinct keys of data set ``name``, sorted; the same in every process."""
    rng = np.random.default_rng((zlib.crc32(name.encode()) & 0xFFFF, seed))
    return sorted(DATASETS[name](rng, n))


# --- paper Fig. 7: synthetic data with target (gpkl, n) -------------------

def gpkl_targeted(rng, n: int, target_gpkl: float, max_rounds: int = 4000) -> List[bytes]:
    """Random strings, then insert dictionary prefixes into runs of adjacent
    keys until the sorted list's GPKL reaches the target (paper Sec. 3.4)."""
    dictionary = [_choice_str(rng, _LOWER, rng.integers(2, 7)) for _ in range(10000)]
    keys = gen_rands(rng, n, 8, 24)
    ss = StringSet.from_list(keys, width=255)
    order = sort_order(ss)
    keys = [keys[i] for i in order]
    cur = gpkl(StringSet.from_list(keys, width=255))
    rounds = 0
    while cur < target_gpkl and rounds < max_rounds:
        rounds += 1
        k = int(rng.integers(8, 64))
        a = int(rng.integers(0, max(n - k, 1)))
        run = keys[a : a + k]
        cpl = len(run[0])
        for s in run[1:]:
            c = 0
            while c < min(len(run[0]), len(s)) and run[0][c] == s[c]:
                c += 1
            cpl = min(cpl, c)
        sp = dictionary[int(rng.integers(0, len(dictionary)))]
        j = int(rng.integers(0, cpl + 1))
        run = [s[:j] + sp + s[j:] for s in run]
        keys[a : a + k] = run
        keys.sort()
        # dedup in place
        keys = sorted(set(keys))
        n = len(keys)
        if rounds % 16 == 0 or cur >= target_gpkl:
            cur = gpkl(StringSet.from_list(keys, width=255))
    return keys
