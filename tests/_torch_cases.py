"""Inputs shared by the port's tests (``test_torch_*.py``), made with numpy
from a seed so that both packages get the same arrays."""
from __future__ import annotations

import contextlib
import functools
import os
from fractions import Fraction

import numpy as np

from repro_torch.core.strings import StringSet, random_strings
from repro_torch.kernels.strops import FNV_PRIME, U32


def query_rows(rng, n: int, width: int, rows: int = 256):
    """(n, width) rows of random keys, about a tenth of them over-width
    (length ``width + 1``, the pad_queries sentinel), random ``start``
    offsets, and an HPT built from a sample of the keys."""
    from repro_torch.core.hpt import build_hpt

    keys = random_strings(rng, n, 1, width + 8)
    ss = StringSet.from_list([k[:width] for k in keys], width=width)
    lens = np.array([min(len(k), width + 1) for k in keys], np.int32)
    hpt = build_hpt(ss.take(np.arange(min(n, 2000))), rows=rows, cols=128)
    start = rng.integers(0, 8, size=n).astype(np.int32)
    return ss.bytes, lens, start, hpt


def tie_cases():
    """Locate inputs whose ``alpha * cdf + beta`` lies within 2**-33 of a
    float32 rounding midpoint: rounding the float64 sum to float32 picks the
    wrong side there, and only a true single rounding (FMA) gets the slot
    right.  641 * 6700417 = 2**32 + 1, so the products carry a tail of
    2**-33 below the bits a float32 sum keeps.  Returns float32
    ``(cdf, alpha, beta)``; each row's exact sum is in 2**23..2**24, where
    float32 steps by 1 and the floor shows the side."""
    # alpha * cdf = +-(0.5 + 2**-33); beta an integer.  With an even beta
    # the float64 sum is a midpoint that round-to-even sends to beta, while
    # the exact sum lies past it (odd beta: both agree, as a control).
    a = np.float32(641 * 2.0 ** -17)
    b = np.float32(6700417 * 2.0 ** -16)
    bases = [2 ** 23 + d for d in (2, 6, 1000, 1, 3, 1001)]
    cdf = np.array([s * b for s in (1, -1) for _ in bases], np.float32)
    alpha = np.full(cdf.shape, a, np.float32)
    beta = np.array(bases * 2, np.float32)
    return cdf, alpha, beta


def saturation_cases():
    """``(cdf, alpha, beta)`` whose fma is NaN, +inf or -inf: the slot comes
    from a saturating float-to-int conversion that maps NaN to 0."""
    cdf = np.array([0.5, 0.0, 0.5, 1.0], np.float32)
    alpha = np.array([np.inf, np.inf, -np.inf, 3e38], np.float32)
    beta = np.array([0.0, 0.0, 0.0, 3e38], np.float32)
    return cdf, alpha, beta


def exact_fma_f32(a, b, c) -> np.ndarray:
    """Correctly rounded float32 ``a * b + c`` by exact rational arithmetic."""
    out = []
    for x, y, z in zip(a, b, c):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        r = np.float32(float(v))
        cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
        dist = [abs(Fraction(float(w)) - v) for w in cands]
        best = min(dist)
        ties = [w for w, d in zip(cands, dist) if d == best]
        # round half to even: the candidate whose last mantissa bit is 0
        out.append(ties[0] if len(ties) == 1 else
                   next(w for w in ties if not np.float32(w).view(np.int32) & 1))
    return np.array(out, np.float32)


def tie_table(cdf: np.ndarray):
    """A one-row HPT whose column ``c`` holds ``cdf[c - 1]``: the length-1
    query ``bytes([c])`` then has exactly that CDF."""
    cdf_tab = np.zeros((1, 128), np.float32)
    cdf_tab[0, 1 : 1 + cdf.shape[0]] = cdf
    prob_tab = np.full((1, 128), 1.0 / 128, np.float32)
    qb = np.arange(1, 1 + cdf.shape[0], dtype=np.uint8)[:, None]
    ql = np.ones(cdf.shape[0], np.int32)
    return cdf_tab, prob_tab, qb, ql


def entry_key(ti, eid: int, is_delta: bool) -> bytes:
    """Key bytes of a base entry (``is_delta`` False) or a delta entry."""
    if is_delta:
        off, ln, pool = int(ti.de_off[eid]), int(ti.de_len[eid]), ti.db_bytes
    else:
        off, ln, pool = int(ti.ent_off[eid]), int(ti.ent_len[eid]), ti.key_bytes
    return pool[off: off + ln].cpu().numpy().tobytes()


def scan_entries(ti, eids, valid, is_delta):
    """``scan_batch`` windows -> per row a list of (key, int64 value)."""
    from repro_torch.core.tensor_index import lookup_values

    lo, hi = lookup_values(ti, eids, is_delta)
    vals = (hi.long() << 32) | (lo.long() & 0xFFFFFFFF)
    return [[(entry_key(ti, int(e), bool(d)), int(v))
             for e, ok, d, v in zip(er, vr, dr, xr) if ok]
            for er, vr, dr, xr in zip(eids.tolist(), valid.tolist(), is_delta.tolist(),
                                      vals.tolist())]


def collision_keys(seed: int, n: int):
    """At least ``n`` stored keys whose compact leaves hold equal 16-bit
    h-pointer codes (``strings.key_hash16``), and never-stored keys that
    collide with them.  The keys come in clusters of 5 to 10 behind a random
    8-letter prefix, which the model nodes leave together in a compact
    leaf.  A cluster holds two or three stored keys of one code (the later
    ones behind a false match), a stored key whose code one never-stored
    key shares, and stored keys of codes of their own; its never-stored
    keys take the shared codes, so one collides with several stored keys
    and one with one.  Returns ``(keys, absent)``, both sorted."""
    from repro_torch.core.strings import key_hash16

    rng = np.random.default_rng(seed)
    keys, absent = set(), set()
    while len(keys) < n:
        tail = int(rng.integers(4, 9))
        sfx = np.unique(rng.integers(0, 26 ** tail, 8192))  # distinct tails
        cand = np.empty((len(sfx), 9 + tail), np.uint8)
        cand[:, :8] = rng.integers(97, 123, 8)
        cand[:, 8] = ord("/")
        cand[:, 9:] = sfx[:, None] // 26 ** np.arange(tail - 1, -1, -1) % 26 + 97
        codes = key_hash16(cand, np.full(len(cand), cand.shape[1]))
        _, inverse, size = np.unique(codes, return_inverse=True, return_counts=True)
        size = size[inverse]
        several, one, own = (rng.permutation(np.flatnonzero(size == s) if s == 1 else
                                             np.flatnonzero(size >= s)) for s in (3, 2, 1))
        x = np.flatnonzero(codes == codes[several[0]])
        y = np.flatnonzero(codes == codes[next(i for i in one if codes[i] != codes[x[0]])])
        k = min(len(x) - 1, int(rng.integers(2, 4)))
        stored = list(x[:k]) + [y[0]] + list(own[: int(rng.integers(2, 7))])
        keys.update(cand[i].tobytes() for i in stored)
        absent.update(cand[i].tobytes() for i in (x[k], y[1]))
    return sorted(keys), sorted(absent - keys)


def probe_tile(rng, B: int, K: int):
    """K3's inputs ``(hashes, qhash, cnt, frm)``, int32: (B, K) codes, a
    third of the rows drawn from four values (repeated matches); a query
    code taken from its row for 60% of the rows; cnt from -2 to K + 3 and
    frm from -2 to K + 1."""
    h = rng.integers(0, 1 << 16, size=(B, K))
    h[rng.random(B) < 1 / 3] %= 4
    qh = np.where(rng.random(B) < 0.6, h[np.arange(B), rng.integers(0, K, B)],
                  rng.integers(0, 1 << 16, B))
    cnt = rng.integers(-2, K + 4, B)
    frm = rng.integers(-2, K + 2, B)
    return tuple(np.ascontiguousarray(a, np.int32) for a in (h, qh, cnt, frm))


def cnode_probe_stats(ti, qbytes, qlens, item, found, eid) -> dict:
    """What the queries that end at a compact leaf ask of its probe, from
    the walk's terminal ``item`` and the lookup's ``(found, eid)``:
    ``at_cnode`` such queries, ``live`` slots their probes scan (min(cnt,
    cnode_cap) each), ``matches`` 16-bit hash matches among them, ``met``
    the matches a walk meets up to its first equal key, ``false`` those of
    them whose key differs; per query (rows ``at``) ``q_matches`` and
    ``q_false``."""
    import torch

    from repro_torch.core.builder import TAG_CNODE
    from repro_torch.core.walk import item_payload, item_tag
    from repro_torch.kernels.strops import hash16

    at = item_tag(item) == TAG_CNODE
    cid = item_payload(item[at]).clamp(max=ti.cn_base.shape[0] - 1).long()
    base, cnt = ti.cn_base[cid].long(), ti.cn_cnt[cid].long()
    j = torch.arange(ti.cnode_cap, device=item.device)
    live = j[None, :] < cnt[:, None]
    sidx = (base[:, None] + j[None, :]).clamp(0, ti.ch_hash.shape[0] - 1)
    hm = live & (ti.ch_hash[sidx] == hash16(qbytes[at], qlens[at])[:, None])
    key = hm & found[at][:, None] & (ti.ch_ent[sidx] == eid[at][:, None])
    first = torch.where(key.any(1), key.int().argmax(1), ti.cnode_cap)
    met = hm & (j[None, :] <= first[:, None])
    false = hm & (j[None, :] < first[:, None])
    return {"at_cnode": int(at.sum()), "live": int(live.sum()), "matches": int(hm.sum()),
            "met": int(met.sum()), "false": int(false.sum()), "at": at,
            "q_matches": hm.sum(1), "q_false": false.sum(1)}


# Batch sizes at which a group of G lanes per query can go wrong: one
# query, part of a warp or block, one past, and a full batch.
CDF_GROUP_BATCHES = (1, 7, 28, 31, 32, 33, 255, 256, 257, 65536)
CDF_TABLES = ("hpt", "uniform1", "cols256", "ties", "clamped", "underflow", "underflow_hpt")


def underflow_table():
    """A one-row HPT whose characters make ``prob`` underflow in chosen ways
    (characters below ``a`` have probability 0).  With ``prob`` kept
    subnormal instead of flushed as XLA on the CPU flushes it, each pattern
    of :data:`UNDERFLOW_PATTERNS` gives another CDF."""
    cdf = np.zeros(128, np.float32)
    prob = np.zeros(128, np.float32)
    entries = {
        "a": (0.0, 2.0 ** -7),                      # 18 of them: prob 2**-126
        "b": (0.5, 2.0 ** -7),
        "c": (0.0, 2.0 ** -63),                     # two: prob exactly 2**-126
        "d": (1 - 2.0 ** -24, 0.5),                 # 2**-126 * d: rounds to 2**-126, a tie
        "e": (0.0, 2.0 ** -63 * (1 + 2.0 ** -23)),
        "f": (1 - 2.0 ** -23, 0.5),                 # after "ce": rounds up to 2**-126, kept
        "g": (0.0, 2.0 ** -63 * (1 - 2.0 ** -24)),  # after "c": prob rounds to 2**-126, a tie
        "h": (2.0 ** -130, 0.5),                    # a subnormal table cdf
        "i": (0.0, 2.0 ** -140),                    # a subnormal table prob
        "k": (1.0, 2.0 ** 100),
        "m": (0.25, 0.75),
    }
    for ch, (c, pr) in entries.items():
        cdf[ord(ch)], prob[ord(ch)] = c, pr
    return cdf[None, :], prob[None, :]


def underflow_keys(seed: int, n: int):
    """Sorted keys over :func:`underflow_table`'s ``a``, ``b``, ``d``, ``f``
    and ``m``: ``n`` draws of one to three runs of up to 29 ``a`` (CDF 0,
    probability 2**-7) each closed by another character, so that a GetCDF
    from the start of a long run underflows, and ``a`` * k + ``b`` for k in
    15..24 (19 and more underflow)."""
    rng = np.random.default_rng(seed)
    tail = np.frombuffer(b"bdfm", np.uint8)
    keys = {b"a" * k + b"b" for k in range(15, 25)}
    for _ in range(n):
        keys.add(b"".join(b"a" * int(rng.integers(0, 30)) + bytes([int(rng.choice(tail))])
                          for _ in range(int(rng.integers(1, 4)))))
    return sorted(keys)


# Rows of the one-row :func:`underflow_table`, with the CDF XLA on the CPU
# gives (``prob`` flushed when it underflows) beside the one a walk that
# keeps subnormals gives.
UNDERFLOW_PATTERNS = (
    b"a" * 19 + b"b",        # 0; kept: 2**-134
    b"a" * 18 + b"b",        # 0 (2**-127 flushed)
    b"a" * 17 + b"b",        # 2**-120, both
    b"ccd",                  # 0: the product rounds to 2**-126 only in subnormal steps
    b"cef",                  # 2**-126: rounded to 24 bits it is 2**-126
    b"cgk",                  # 0; kept: 2**-126
    b"h",                    # 0; kept: 2**-130
    b"ik",                   # 0; kept: 2**-40
    b"ak" + b"a" * 17 + b"b" + b"m",
    b"m" + b"a" * 30 + b"k",
)


def _underflow_rows(L: int, n: int, _rng):
    """``edge_cdf_rows`` for the underflow tables: ``underflow`` cycles
    :data:`UNDERFLOW_PATTERNS` over the crafted one-row table; alpha and
    beta put the slot of a CDF of 2**-126 one above that of a CDF of 0;
    ``underflow_hpt`` runs up to 60 zero bytes (column 0, whose CDF is 0 in
    every row), then one to three other bytes, over a 1024 x 128 HPT built
    from random zero-free rows, in which about ten zero bytes make ``prob``
    underflow."""
    qb = np.zeros((n, L), np.uint8)
    ql = np.zeros(n, np.int32)
    for i in range(n):
        pat = UNDERFLOW_PATTERNS[i % len(UNDERFLOW_PATTERNS)]
        qb[i, : len(pat)] = np.frombuffer(pat, np.uint8)
        ql[i] = len(pat)
    cdf_tab, prob_tab = underflow_table()
    return (qb, ql, cdf_tab, prob_tab, np.full(n, 2.0 ** 105, np.float32),
            np.full(n, 5 - 2.0 ** -21, np.float32))


def _underflow_hpt_rows(L: int, n: int, rng):
    from repro_torch.core.hpt import build_hpt

    run = rng.integers(0, min(L - 3, 60), n)
    tail = rng.integers(1, 4, n)
    qb = np.where(np.arange(L)[None, :] < run[:, None], 0,
                  rng.integers(1, 128, (n, L))).astype(np.uint8)
    ql = np.minimum(run + tail, L).astype(np.int32)
    qb = np.where(np.arange(L)[None, :] < ql[:, None], qb, 0).astype(np.uint8)
    # built from zero-free rows: column 0 keeps only its smoothing, and a
    # zero byte leaves the hash, hence the row, at 0
    sample = rng.integers(1, 128, (4000, L)).astype(np.uint8)
    hpt = build_hpt(StringSet(sample, rng.integers(1, L + 1, 4000).astype(np.int32)),
                    rows=1024, cols=128)
    return (qb, ql, hpt.cdf_tab, hpt.prob_tab, rng.uniform(1, 5e5, n).astype(np.float32),
            rng.uniform(-4, 4, n).astype(np.float32))


@functools.lru_cache(maxsize=None)
def edge_cdf_rows(L: int, table: str, n: int = 65536):
    """``n`` GetCDF/locate rows of width ``L`` whose row ``i`` is of kind
    ``i % 6`` (so every prefix of more than 5 rows holds every kind):
    qlen 0; start >= qlen; qlen > start + 64; the over-width sentinel
    ``L + 1`` with a start that walks past the row's end; and two random
    kinds.  ``table`` picks the HPT: ``hpt`` (1024 x 128, built from the
    rows), ``uniform1`` (one uniform row), ``cols256`` (1024 x 256, rows
    with any byte), ``clamped`` (1024 x 128, rows with any byte, so that
    the walk hashes and reads characters clamped to 127) or ``ties`` (the
    one-row table of :func:`tie_table`, every row a length-1 query of the
    FMA-tie or saturation cases, with their alpha and beta); ``underflow``
    and ``underflow_hpt`` hold rows whose ``prob`` underflows
    (:func:`_underflow_rows`), each from ``start`` 0.  Returns numpy
    ``(qb, ql, st, cdf_tab, prob_tab, alpha, beta, nslots)``."""
    from repro_torch.core.hpt import build_hpt, uniform_hpt

    rng = np.random.default_rng(1000 * L + CDF_TABLES.index(table))
    if table in ("underflow", "underflow_hpt"):
        make = _underflow_rows if table == "underflow" else _underflow_hpt_rows
        qb, ql, cdf_tab, prob_tab, alpha, beta = make(L, n, rng)
        return (qb, ql, np.zeros(n, np.int32), cdf_tab, prob_tab, alpha, beta,
                np.full(n, 1 << 30, np.int32))
    if table == "ties":
        cases = [np.concatenate(a) for a in zip(tie_cases(), saturation_cases())]
        cdf_tab, prob_tab, qb1, ql1 = tie_table(cases[0])
        pick = np.arange(n) % cases[0].shape[0]
        qb = np.zeros((n, L), np.uint8)
        qb[:, 0] = qb1[pick, 0]
        return (qb, ql1[pick].copy(), np.zeros(n, np.int32), cdf_tab, prob_tab,
                cases[1][pick].copy(), cases[2][pick].copy(), np.full(n, 1 << 30, np.int32))
    top = 128 if table == "hpt" else 256  # bytes past a 128-column table clamp to C - 1
    qb = rng.integers(1, top, (n, L)).astype(np.uint8)
    kind = np.arange(n) % 6
    st = rng.integers(0, 8, n)
    ql = rng.integers(1, L + 1, n)
    ql[kind == 0] = 0
    few = kind == 1
    ql[few] = rng.integers(0, 8, few.sum())
    st[few] = ql[few] + rng.integers(0, 4, few.sum())
    far = kind == 2
    ql[far] = rng.integers(st[far] + 65, L + 2)
    over = kind == 3
    ql[over] = L + 1
    st[over] = rng.integers(0, 40, over.sum())
    late = kind == 5
    st[late] = rng.integers(0, L, late.sum())
    cols = np.arange(L)[None, :]
    qb = np.where(cols < ql[:, None], qb, 0).astype(np.uint8)  # zero padded, as pad_queries
    if table == "uniform1":
        hpt = uniform_hpt(1, 128)
    else:
        C = 256 if table == "cols256" else 128
        sample = StringSet(np.minimum(qb[:4000], C - 1),
                           np.minimum(ql[:4000], L).astype(np.int32))
        hpt = build_hpt(sample, rows=1024, cols=C)
    return (qb, ql.astype(np.int32), st.astype(np.int32), hpt.cdf_tab, hpt.prob_tab,
            rng.uniform(1, 5e5, n).astype(np.float32), rng.uniform(-4, 4, n).astype(np.float32),
            rng.integers(8, 1 << 20, n).astype(np.int32))


def visited_entries(qb, ql, st, R: int, C: int, max_steps: int):
    """The table entries (flat indices ``row * C + column``) that the GetCDF
    walk's active steps read, and how many reads each gets."""
    B, L = qb.shape
    h = np.zeros(B, np.uint64)
    flat = []
    for k in range(min(max_steps, L)):
        pos = st.astype(np.int64) + k
        c = np.minimum(qb[np.arange(B), np.clip(pos, 0, L - 1)].astype(np.int64), C - 1)
        act = pos < ql
        flat.append(((h & np.uint64(R - 1)).astype(np.int64) * C + c)[act])
        h = np.where(act, ((h ^ c.astype(np.uint64)) * np.uint64(FNV_PRIME)) & np.uint64(U32), h)
    return np.unique(np.concatenate(flat), return_counts=True)


def nonfinite_tables(qb, ql, st, cdf_tab, prob_tab, max_steps: int):
    """Copies of the two tables with inf, -inf and NaN entries: inf at the
    entry the walk reads least (the value a query selects); NaN in a column
    the queries use, in a row no query reads there (every read of that
    column is NaN in the one-hot contraction), in the least-read such column,
    or at the next least-read entry where every used column is read in every
    row; -inf and inf in columns no query reads."""
    R, C = cdf_tab.shape
    cdf_tab, prob_tab = cdf_tab.copy(), prob_tab.copy()
    idx, reads = visited_entries(qb, ql, st, R, C, max_steps)
    col_reads = np.bincount(idx % C, weights=reads, minlength=C)
    if idx.size:
        by_reads = idx[np.argsort(reads, kind="stable")]
        cdf_tab.flat[by_reads[0]] = np.inf
        rows_read = np.bincount(idx % C, minlength=C)
        cols = np.flatnonzero((col_reads > 0) & (rows_read < R))
        if cols.size:
            col = int(cols[col_reads[cols].argmin()])
            prob_tab.flat[np.setdiff1d(np.arange(R) * C + col, idx)[0]] = np.nan
        elif idx.size > 1:
            prob_tab.flat[by_reads[1]] = np.nan
    unused = np.flatnonzero(col_reads == 0)
    if unused.size:
        cdf_tab[0, unused[0]] = -np.inf
        prob_tab[R - 1, unused[-1]] = np.inf
    return cdf_tab, prob_tab


def nan_equal(a, b) -> bool:
    """Float32 arrays equal bit for bit where not NaN, with NaN at the same
    places."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all()
                and (a[~nan].view(np.int32) == b[~nan].view(np.int32)).all())


def short_orders(seed: int, width: int = 8):
    """Sorted orders of every length 0..300 over a five-byte alphabet (bytes
    >= 0x80 included), with duplicates and proper prefixes.  Yields
    ``(keys, queries, (ent_sorted, ent_off, ent_len, key_bytes))``: the
    tables as numpy arrays, padded to one entry when ``keys`` is empty, the
    pool padded with ``width + 1`` zero bytes as freeze pads it; the queries
    hold keys, extensions, prefixes, the empty query and one past every key."""
    rng = np.random.default_rng(seed)
    alphabet = [b"a", b"b", b"\x7f", b"\x80", b"\xff"]
    for n in range(301):
        keys = sorted(b"".join(alphabet[int(i)] for i in rng.integers(0, 5, int(m)))
                      for m in rng.integers(1, 4, n))
        lens = np.array([len(k) for k in keys] or [0], np.int32)
        off = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int32)
        pool = np.frombuffer(b"".join(keys) + bytes(width + 1), np.uint8).copy()
        srt = np.arange(lens.shape[0], dtype=np.int32)
        queries = keys[::7] + [k + b"a" for k in keys[::11]] + [k[:-1] for k in keys[::13]]
        queries += [b"", b"\xff\xff\xff\xff", b"a"]
        yield keys, queries, (srt, off, lens, pool)


# Batch sizes at which staged query rows and lane groups can go wrong: one
# query, a ragged warp, a block less one, a block, one past, a full batch.
# The CPU runs the plain versions, which have no blocks, against the
# reference: there a ragged batch of 4,097 stands in for the full one.
WORD_BATCHES = (1, 31, 255, 256, 257, 65536)
WORD_BATCHES_CPU = (1, 31, 255, 256, 257, 4097)
WORD_WIDTH = 40
WORD_WINDOW = 16


def word_edge_case(width: int = WORD_WIDTH, seed: int = 0):
    """Keys, writes and queries for the word-wide string compares of K4 and
    K6, at index width ``width`` (>= 24).

    The stored keys (NUL-free, as the builder demands) hold keys of length 1,
    15, 16, 17 and ``width``, chains of proper prefixes, bytes >= 0x80 and a
    long shared prefix, so that compares run many bytes deep; there are
    enough of them that key offsets fall at every residue mod 16.  The
    writes (``[("put" | "delete", keys)]``, in order) leave a delta view
    with fresh keys between base keys, a key that equals a base key but for
    a trailing zero byte, a run of more than ``WORD_WINDOW`` consecutive
    base keys deleted (tombstones), delta-only keys deleted, and base keys
    deleted then put again, whose live delta entries shadow them.

    Returns ``(keys, writes, queries, starts)``: ``queries`` holds every
    stored key, each with its last byte one up and one down, proper prefixes
    both ways (a query that is a prefix of a key, a key that is a prefix of
    the query), embedded zero bytes against the zero padding, the empty
    query, width-long and over-width (``width + 1`` sentinel) queries;
    ``starts`` adds the ``WORD_WINDOW + 4`` keys before each resurrected key
    (so that it falls at every slot of a window, its edge included) and the
    keys before the tombstone run."""
    assert width >= 24
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ab/.\x01\x7f\x80\x81\xfe\xff", np.uint8)
    stem = b"http://\x80\xffexample.org/"[: width // 2]

    def word(n):
        return alphabet[rng.integers(0, alphabet.shape[0], n)].tobytes()

    keys = {stem + word(int(n)) for n in rng.integers(0, width - len(stem) + 1, 150)}
    keys |= {word(int(n)) for n in rng.integers(1, width + 1, 150)}
    longest = (stem + word(width))[:width]
    keys |= {longest[:n] for n in (1, 2, 8, 15, 16, 17, 24, width - 1, width)}
    keys |= {word(n) for n in (1, 15, 16, 17, width) for _ in range(3)}
    keys = sorted(keys)

    mid = len(keys) // 2
    run = keys[mid: mid + WORD_WINDOW + 8]                # tombstones, longer than a window
    back = [keys[i] for i in (mid // 2, mid // 2 + 40, len(keys) - 3)]  # resurrected
    fresh = sorted({k + word(int(n)) for k, n in zip(keys[::7], rng.integers(1, 4, len(keys)))
                    if len(k) + 3 <= width} - set(keys))
    zero = [k + b"\x00" for k in keys[3::29] if len(k) < width]
    writes = [("put", fresh + zero), ("delete", run + back + fresh[::5]),
              ("put", back + fresh[1::5])]

    def bump(k, d):
        return k[:-1] + bytes([(k[-1] + d) % 256])

    queries = list(keys)
    queries += [bump(k, 1) for k in keys] + [bump(k, -1) for k in keys]
    queries += [k[:-1] for k in keys if len(k) > 1] + [k[: len(k) // 2] for k in keys]
    queries += [k + b"\x00" for k in keys[::3]] + [k + b"\x00\x00a" for k in keys[1::5]]
    queries += [k + b"\x01" for k in keys[2::5]] + [k + b"\xff" for k in keys[::4]]
    queries += [(k * width)[:width] for k in keys[::6]]
    queries += [k + b"~" * (width + 1 - len(k)) for k in keys[::5]]
    queries += [b"", b"\x00", b"\xff" * width, b"\xff" * (width + 1)] + fresh[::3] + zero
    starts = list(queries) + [keys[mid - 1], run[0]]
    for k in back:
        i = keys.index(k)
        starts += keys[max(0, i - WORD_WINDOW - 4): i + 1]
    return keys, writes, queries, starts


def wide_edge_case(width: int, seed: int = 0):
    """Keys, writes and queries for rows wider than a block stages by
    default: 60 keys that share a prefix of up to ``width`` bytes and part in
    their last three, prefixes of it at lengths 1, 16, 17, ``width - 1`` and
    ``width``; writes that put keys one byte past stored ones and delete
    some of each.  Returns ``(keys, writes, queries, starts)`` as
    :func:`word_edge_case` does; the queries hold every key, each with its
    last byte one up and one down, proper prefixes, the empty query and an
    over-width (``width + 1``) sentinel, and ``starts`` is the same list."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 256, width, dtype=np.uint8).tobytes()
    keys = {base[: int(n)] + rng.integers(1, 256, 3, dtype=np.uint8).tobytes()
            for n in rng.integers(0, width - 2, 60)}
    keys = sorted(keys | {base[:n] for n in (1, 16, 17, width - 1, width)})
    fresh = sorted({k + b"\x01" for k in keys[::3] if len(k) < width} - set(keys))
    writes = [("put", fresh), ("delete", keys[1::4] + fresh[::2])]

    def bump(k, d):
        return k[:-1] + bytes([(k[-1] + d) % 256])

    queries = list(keys) + [bump(k, 1) for k in keys] + [bump(k, -1) for k in keys]
    queries += [k[:-1] for k in keys if len(k) > 1] + [k[: len(k) // 2] for k in keys]
    queries += [b"", base + b"\xff", b"\xff" * (width + 1)] + fresh
    return keys, writes, queries, queries


def word_rows(queries, n: int):
    """The first ``n`` of ``queries`` repeated in turn."""
    return [queries[i % len(queries)] for i in range(n)]


def word_edge_indexes(index_cls, config_cls, builder_config_cls, width: int = WORD_WIDTH,
                      case=word_edge_case, **config):
    """``case`` (:func:`word_edge_case`) bulk-loaded through a package's facade
    (``StringIndex``, ``IndexConfig``, ``LITSConfig`` of either package):
    ``(ti before the writes, ti after them)``.  The keys hold bytes >= 0x80,
    so the HPT has 256 columns."""
    keys, writes, _, _ = case(width)
    vals = np.arange(len(keys), dtype=np.int64) * 3 + 1
    ix = index_cls.bulk_load(keys, vals, config_cls(
        width=width, delta_capacity=256, builder=builder_config_cls(hpt_cols=256), **config))
    empty = ix.ti
    for i, (kind, batch) in enumerate(writes):
        if kind == "put":
            ix.put_batch(batch, np.arange(len(batch)) + 1000 * (i + 1))
        else:
            ix.delete_batch(batch)
    return empty, ix.ti


def trimmed(ti):
    """``ti`` with its key pools cut to the bytes they use, so that the
    aligned 16-byte chunks of the last keys pass the pools' ends (the byte
    path of the word compares)."""
    import dataclasses

    n_key = ti.key_bytes.shape[0] - (ti.width + 1)
    return dataclasses.replace(ti, key_bytes=ti.key_bytes[:n_key],
                               db_bytes=ti.db_bytes[: max(int(ti.db_used), 1)])


# a reduced arch on the card against the CPU port: cuBLAS's bf16 products
# round in another order
LM_CARD_TOL = 6e-2
# the first decode step's logits against forward's on S+1 tokens through 30
# layers: the reference's 6e-2 (its test's, at 2 layers) grown as the
# reference's own gap grows from 2 to 30 layers (x2.2 at the reduced width,
# test_torch_lm_model.py's test_decode_vs_forward_gap_grows_with_depth_as_in_reference),
# rounded down
LM_DEPTH_TOL = 0.1


def lm_pair(arch: str, dev):
    """A reduced arch's port model on the CPU and the same weights on ``dev``."""
    import torch

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import LMModel

    cfg = ARCHS[arch].reduced()
    cpu = LMModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = LMModel(cfg, device=dev, generator=torch.Generator(dev).manual_seed(1))
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


def lm_card_vs_cpu(arch: str, dev, close, seed: int = 3) -> list:
    """The reduced ``arch`` on ``dev`` against the port on the CPU with the
    same weights: prefill and two decode steps, both fed the CPU's greedy
    tokens (an encoder-only arch: its forward), on 2 rows of 12 positions
    from ``default_rng(seed)``.  ``close(what, got, want)`` compares each
    pair of logits (``got`` on ``dev``, ``want`` on the CPU); its results in
    order."""
    import torch

    cfg, cpu, card = lm_pair(arch, dev)
    rng = np.random.default_rng(seed)
    B, S = 2, 12
    if not cfg.decoder:
        fr = torch.from_numpy(rng.standard_normal((B, S, cfg.frontend_dim)).astype(
            np.float32)).to(torch.bfloat16)
        with torch.no_grad():
            return [close("forward", card.forward({"frames": fr.to(dev)}),
                          cpu.forward({"frames": fr}))]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    cc, cl = cpu.prefill({"tokens": toks}, max_len=S + 4)
    gc, gl = card.prefill({"tokens": toks.to(dev)}, max_len=S + 4)
    out = [close("prefill", gl, cl)]
    for step in range(2):
        tok = torch.argmax(cl[:, : cfg.vocab], -1).to(torch.int32)
        cc, cl = cpu.decode_step(cc, tok, S + step)
        gc, gl = card.decode_step(gc, tok.to(dev), S + step)
        out.append(close(f"decode step {step}", gl, cl))
    return out


# a gradient held to another package's or device's: within LM_GRAD_RTOL of
# its norm, plus LM_GRAD_NOISE of the whole gradient's norm for a tensor that
# is rounding noise on both sides (a top-1 router's gate is divided by
# itself: zero in exact arithmetic; test_torch_lm_grad.py's
# test_top1_router_grad_is_rounding_noise)
LM_GRAD_RTOL = 2e-2
LM_GRAD_NOISE = 1e-6


def _f64(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float64)


def grad_errors(got: dict, want: dict) -> dict:
    """{name: (|got - want|, the bound it must stay under)} for two dicts of
    gradients with the same names (tensors on any device, or arrays)."""
    want = {k: _f64(v) for k, v in want.items()}
    total = np.sqrt(sum(float(np.sum(w * w)) for w in want.values()))
    return {k: (float(np.linalg.norm(_f64(got[k]) - w)),
                LM_GRAD_RTOL * float(np.linalg.norm(w)) + LM_GRAD_NOISE * total)
            for k, w in want.items()}


def lm_train_batch(cfg, rng, B: int, S: int) -> dict:
    """A labelled batch for ``cfg`` as CPU tensors: tokens (hubert: frames),
    labels with two masked (-1), internvl's patches."""
    import torch

    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :2] = -1
    batch = {"labels": torch.from_numpy(labels)}
    if cfg.frontend == "frame":
        fr = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
        batch["frames"] = torch.from_numpy(fr).to(torch.bfloat16)
        return batch
    batch["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    if cfg.frontend == "patch":
        pt = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        batch["patches"] = torch.from_numpy(pt).to(torch.bfloat16)
    return batch


def lm_train_step_card_vs_cpu(arch: str, dev, seed: int = 3) -> dict:
    """One train step (AdamW with float32 moments, accum 1) of the reduced
    ``arch`` on ``dev`` and on the CPU port, same weights and batch (2 rows
    of 16): each side's loss, grad norm and lr, ``grad_errors`` of the
    step's gradients, and the largest parameter difference after it."""
    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import optimizer as opt

    cfg, cpu, card = lm_pair(arch, dev)
    batch = lm_train_batch(cfg, np.random.default_rng(seed), 2, 16)
    ocfg = opt.AdamWConfig(state_dtype=torch.float32)
    out = {}
    for name, m, b in (("cpu", cpu, batch), ("card", card, {k: v.to(dev) for k, v in
                                                             batch.items()})):
        _, met = make_train_step(m, ocfg)(opt.init_state(m.param_tree(), ocfg), b)
        out[name] = {k: float(v) for k, v in met.items()}
    out["grads"] = grad_errors({k: p.grad for k, p in card.params().items()},
                               {k: p.grad for k, p in cpu.params().items()})
    out["param_err"] = max(float((a.detach().cpu() - b.detach()).abs().max())
                           for a, b in zip(card.parameters(), cpu.parameters()))
    return out


@contextlib.contextmanager
def remat_policy(policy: str):
    """``REPRO_REMAT_POLICY`` set to ``policy`` inside the block (``off``:
    left as it is; the caller passes ``remat=False``), restored after."""
    before = os.environ.get("REPRO_REMAT_POLICY")
    if policy != "off":
        os.environ["REPRO_REMAT_POLICY"] = policy
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("REPRO_REMAT_POLICY", None)
        else:
            os.environ["REPRO_REMAT_POLICY"] = before


def remat_grads(model, batch, policies=("off", "none", "dots")) -> dict:
    """Every parameter's gradient of ``model.loss(batch)`` with remat off and
    under each ``REPRO_REMAT_POLICY``: {policy: {name: gradient copy}}."""
    from repro_torch.launch.steps import zero_grads

    out = {}
    for policy in policies:
        with remat_policy(policy):
            zero_grads(model)
            loss, _ = model.loss(batch, remat=policy != "off")
            loss.backward()
        out[policy] = {k: p.grad.clone() for k, p in model.params().items()}
    return out


def train_crash_resume(dev, root: str):
    """``tests/test_fault_tolerance.py``'s run on the port: the reduced
    deepseek on ``dev``, 10 steps of batches of 4 × 16, checkpoints every 3
    steps; killed at step 7 in ``root/crash`` and resumed, and uninterrupted
    in ``root/clean``.  Returns (the resumed run's output, its parameters,
    the clean run's parameters), the parameters as {name: copy}."""
    import torch

    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import LMModel
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig, train

    r = ARCHS["deepseek-7b"].reduced()
    m = LMModel(r, device=dev)
    pipe = TokenPipeline(PipelineConfig(vocab=r.vocab, seq_len=16, global_batch=4))
    ocfg = opt.AdamWConfig(lr=1e-3, state_dtype=torch.float32, warmup_steps=2, total_steps=20)
    crash, clean = os.path.join(root, "crash"), os.path.join(root, "clean")
    try:
        train(m, pipe.batch_at, ocfg, TrainConfig(steps=10, ckpt_every=3, ckpt_dir=crash,
                                                  fail_at_step=7))
    except RuntimeError as e:
        if "injected failure at step 7" not in str(e):
            raise
    else:
        raise AssertionError("the run did not fail at step 7")
    out = train(m, pipe.batch_at, ocfg, TrainConfig(steps=10, ckpt_every=3, ckpt_dir=crash))
    resumed = {k: p.detach().clone() for k, p in m.params().items()}
    train(m, pipe.batch_at, ocfg, TrainConfig(steps=10, ckpt_every=3, ckpt_dir=clean))
    return out, resumed, {k: p.detach().clone() for k, p in m.params().items()}


# ---------------------------------------------------------------------------
# the mesh on one rank: every collective is the identity, so each mesh
# result must equal its no-mesh result bit for bit (chip_smoke.py's phase
# mesh and the card tests; on the CPU over a one-rank gloo group)
# ---------------------------------------------------------------------------

def mesh_train_pair(cfg, dev, mesh, batch_at, opt_cfg, tcfg) -> dict:
    """``train_loop.train`` of ``cfg`` on ``dev`` from the same seed-0
    weights, first under ``mesh`` (one rank), then without a mesh, the first
    run's state freed before the second.  Returns {"mesh": ..., "plain":
    ...}: each run's history, peak device memory (GB, the card only) and
    seconds; the mesh run's layout, {name: (local shape, the shape
    ``param_shardings`` gives a rank, placements == its sharding)}; the
    parameters that differ between the runs; and the plain run's model."""
    import time

    import torch

    from repro_torch.distributed.sharding import gather, local_chunk, set_mesh
    from repro_torch.launch import steps
    from repro_torch.models import LMModel
    from repro_torch.train import _tree
    from repro_torch.train.train_loop import train

    cuda = dev.type == "cuda"
    out, kept = {}, None
    for name in ("mesh", "plain"):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model = LMModel(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
        set_mesh(mesh if name == "mesh" else None)
        try:
            t0 = time.time()
            res = train(model, batch_at, opt_cfg, tcfg,
                        generator=torch.Generator(dev).manual_seed(0))
            seconds = time.time() - t0
            if name == "mesh":
                sh = dict(_tree.items(steps.param_shardings(model)))
                layout = {k: (tuple(p.to_local().shape), tuple(local_chunk(
                    torch.empty(p.shape, device="meta"), sh[k], mesh).shape),
                    tuple(p.placements) == sh[k]) for k, p in _tree.items(model.param_tree())}
        finally:
            set_mesh(None)
        r = {"history": res["history"], "seconds": seconds,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0}
        params = dict(_tree.items(model.param_tree()))
        if name == "mesh":
            r["layout"] = layout
            kept = {k: gather(p).detach().cpu() for k, p in params.items()}
            del res, model, params
        else:
            r["differ"] = [k for k, p in params.items()
                           if not torch.equal(p.detach().cpu(), kept[k])]
            r["model"] = model
        out[name] = r
    return out


def moe_block_mesh_vs_plain(model, mesh, x, mode: str) -> list:
    """Layer 0's MoE, its weights cast to bf16, forward and backward (the
    gradient of a fixed projection of its output) on ``x`` under ``mesh`` in
    ``mode`` and without a mesh: the names of what differs among the output
    and the gradients of ``x`` and every weight."""
    import torch

    from repro_torch.distributed.sharding import set_mesh
    from repro_torch.models.layers import cast_tree, moe_apply, sub_params

    c = model.cfg
    with torch.no_grad():
        p = cast_tree(sub_params(model.layer(0), "moe"))
    w = torch.randn(x.shape, generator=torch.Generator(x.device).manual_seed(4),
                    device=x.device)

    def run(on_mesh):
        ps = {k: v.clone().requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        set_mesh(mesh if on_mesh else None)
        try:
            y = moe_apply(xx, ps, top_k=c.top_k, capacity_factor=c.capacity_factor,
                          act=c.mlp_act, mode=mode)
        finally:
            set_mesh(None)
        (y.float() * w).sum().backward()
        return {"out": y.detach(), "x": xx.grad, **{k: v.grad for k, v in ps.items()}}

    got, want = run(True), run(False)
    return [k for k in want if not torch.equal(got[k], want[k])]


def serve_mesh_vs_plain(model, mesh, tokens, steps: int) -> list:
    """``prefill`` of ``tokens`` (B, S) and ``steps`` greedy ``decode_step``
    calls under ``mesh`` and without: what differs among the logits and the
    final caches."""
    import torch

    from repro_torch.distributed.sharding import set_mesh

    def run(on_mesh):
        set_mesh(mesh if on_mesh else None)
        try:
            S = tokens.shape[1]
            cache, logits = model.prefill({"tokens": tokens}, max_len=S + steps)
            outs = [logits]
            for i in range(steps):
                cache, logits = model.decode_step(cache, outs[-1].argmax(-1), S + i)
                outs.append(logits)
        finally:
            set_mesh(None)
        return {**{f"logits{i}": t for i, t in enumerate(outs)},
                **{f"cache/{k}": v for k, v in cache.items()}}

    got, want = run(True), run(False)
    return [k for k in want if not torch.equal(got[k], want[k])]


def compressed_vs_plain(model, mesh, batch, opt_cfg) -> dict:
    """One ``make_compressed_dp_step`` step over ``mesh``'s one-rank data
    axis from the model's weights, zero moments and zero error state, against
    the plain update (``apply_updates``) on each gradient's
    ``dequantize(quantize(g))`` from the same weights.  Returns the
    parameters and error-state leaves that differ, the two metrics, and the
    wire bytes a step (int8 plus a float32 scale a leaf, against float32)."""
    import torch

    from repro_torch.distributed import compression as comp
    from repro_torch.launch.steps import zero_grads
    from repro_torch.train import _tree
    from repro_torch.train import optimizer as opt_mod

    params = model.param_tree()
    before = {k: p.detach().clone() for k, p in _tree.items(params)}
    err = comp.init_error_state(params)
    _, err, met = comp.make_compressed_dp_step(model, opt_cfg, mesh)(
        opt_mod.init_state(params, opt_cfg), err, batch)
    got = {k: p.detach().clone() for k, p in _tree.items(params)}
    with torch.no_grad():
        for k, p in _tree.items(params):
            p.copy_(before[k])
    del before
    zero_grads(model)
    loss, _ = model.loss(batch)
    loss.backward()
    want_err = {}
    with torch.no_grad():
        for k, p in _tree.items(params):
            q, s = comp.quantize(p.grad.float())
            want_err[k] = p.grad.float() - comp.dequantize(q, s)
            p.grad.copy_(comp.dequantize(q, s))
    grads = _tree.map_with_path(lambda _, p: p.grad, params)
    _, _, om = opt_mod.apply_updates(params, grads, opt_mod.init_state(params, opt_cfg), opt_cfg)
    n = [p.numel() for p in _tree.leaves(params)]
    return {"params_differ": [k for k, p in _tree.items(params) if not torch.equal(p, got[k])],
            "err_differ": [k for k, e in _tree.items(err) if not torch.equal(e, want_err[k])],
            "compressed": {k: float(v) for k, v in met.items()},
            "plain": {"loss": float(loss.detach()), **{k: float(v) for k, v in om.items()}},
            "wire_bytes": sum(n) + 4 * len(n), "float32_bytes": 4 * sum(n)}
