"""Key sets of the LITS paper's Sec. 4.1 recipes, drawn in bulk from a seed.

The recipes are those of ``repro_torch/data/synthetic.py`` (``gen_url``,
``gen_email``); the draws are vectorised: every random choice of a set is
one numpy call, keys are assembled as rows of a zero-padded byte matrix,
and duplicates go in one ``np.unique``.  The same seed gives the same keys;
they are not the keys ``synthetic.py`` gives for a seed (its draws come one
key at a time).  No recipe emits a zero byte, so a zero-padded row is the
key, and row order is the bytes' lexicographic order.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

_LOWER = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


class Vocab:
    """Byte strings as a zero-padded matrix and their lengths."""

    def __init__(self, words: Sequence[bytes]):
        self.lens = np.array([len(w) for w in words], np.int64)
        self.mat = np.zeros((len(words), max(int(self.lens.max()), 1)), np.uint8)
        for i, w in enumerate(words):
            self.mat[i, : len(w)] = np.frombuffer(w, np.uint8)


def _words(rng, n: int, lo: int, hi: int) -> List[bytes]:
    """``n`` random lowercase words of ``lo`` to ``hi - 1`` letters."""
    lens = rng.integers(lo, hi, n)
    letters = _LOWER[rng.integers(0, 26, (n, hi - 1))]
    return [letters[i, : lens[i]].tobytes() for i in range(n)]


def assemble(parts, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate, row by row, one piece of each part: ``(Vocab, ids)``,
    where ``ids`` picks a word a row (``-1``: nothing), or a ``bytes``
    constant.  Returns the zero-padded rows and their lengths."""
    parts = [(Vocab([p]), np.zeros(n, np.int64)) if isinstance(p, bytes) else p
             for p in parts]
    width = sum(v.mat.shape[1] for v, _ in parts)
    mat = np.zeros((n, width), np.uint8)
    pos = np.zeros(n, np.int64)
    rows = np.arange(n)
    for vocab, ids in parts:
        use = ids >= 0
        safe = np.where(use, ids, 0)
        lens = np.where(use, vocab.lens[safe], 0)
        for c in range(vocab.mat.shape[1]):
            m = c < lens
            mat[rows[m], pos[m] + c] = vocab.mat[safe[m], c]
        pos += lens
    return mat[:, : int(pos.max())], pos


def url_rows(rng, n: int, n_hosts: int) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` candidate urls: ``http://www.<word><tld>/<1-5 path words>/<0-9999>.html``,
    hosts by zipf(1.3) over ``n_hosts`` hosts, path words uniform over 500."""
    tld = Vocab([b".com", b".org", b".net", b".de", b".io"])
    hosts = Vocab([b"www." + w for w in _words(rng, n_hosts, 5, 14)])
    host_tld = rng.integers(0, 5, n_hosts)
    paths = Vocab(_words(rng, 500, 3, 10))
    digits = Vocab([b"%d" % i for i in range(10000)])
    host = np.minimum(rng.zipf(1.3, n) - 1, n_hosts - 1)
    depth = rng.integers(1, 6, n)
    words = rng.integers(0, 500, (n, 5))
    parts = [b"http://", (hosts, host), (tld, host_tld[host]), b"/"]
    for d in range(5):
        on = d < depth
        parts.append((paths, np.where(on, words[:, d], -1)))
        parts.append((Vocab([b"/"]), np.where(on, 0, -1)))
    parts += [(digits, rng.integers(0, 10000, n)), b".html"]
    return assemble(parts, n)


def email_rows(rng, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` candidate emails: ``first.last##@domain``, 400 first and 600
    last names, a two-digit number, 5 domains, all uniform."""
    first = Vocab(_words(rng, 400, 3, 8))
    last = Vocab(_words(rng, 600, 4, 9))
    two = Vocab([b"%02d" % i for i in range(100)])
    dom = Vocab([b"gmail.com", b"yahoo.com", b"hotmail.com", b"example.org", b"mail.net"])
    return assemble([(first, rng.integers(0, 400, n)), b".", (last, rng.integers(0, 600, n)),
                     (two, rng.integers(0, 100, n)), b"@", (dom, rng.integers(0, 5, n))], n)


RECIPES: Dict[str, Callable] = {
    "url": lambda rng, n, m: url_rows(rng, m, max(n // 50, 10)),
    "email": lambda rng, n, m: email_rows(rng, m),
}


def distinct_keys(recipe: str, n: int, rng) -> List[bytes]:
    """``n`` distinct keys of ``recipe`` in a random order drawn from ``rng``.

    Candidates are drawn 10% over ``n`` and deduplicated; a set whose
    candidates repeat more than that draws again with twice the margin."""
    margin = 1.1
    while True:
        mat, _ = RECIPES[recipe](rng, n, int(n * margin) + 16)
        rows = np.ascontiguousarray(mat).view(f"S{mat.shape[1]}").ravel()
        uniq = np.unique(rows)   # sorted: bytes order, the rows being zero-free
        if uniq.shape[0] >= n:
            break
        margin *= 2
    pick = rng.choice(uniq.shape[0], n, replace=False)
    return uniq[pick].tolist()   # numpy's bytes drop the zero padding


def config_keys(cfg: dict) -> List[bytes]:
    """A configuration's data set: ``n_stored + n_pool`` distinct keys of
    its recipe, one fixed draw from its ``data_seed``, in that draw's order
    (the first ``n_stored`` are loaded, the rest are the never-stored pool).
    Every run of a configuration holds the same keys, as a benchmark's data
    set is one file; a run's seed draws its values and traffic."""
    return distinct_keys(cfg["recipe"], cfg["n_stored"] + cfg["n_pool"],
                         np.random.default_rng([int(cfg["data_seed"]), 0]))
