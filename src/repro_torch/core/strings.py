"""String-tensor utilities.

Numpy copy of :mod:`repro.core.strings` (the port imports nothing of
``repro``).  The paper operates on C strings (NUL-free byte strings <= 255B).
The index represents a set of strings as a *StringSet*: a zero-padded ``(N, L) uint8``
matrix plus a length vector.  Zero padding preserves lexicographic order for
NUL-free keys: comparing padded rows bytewise (memcmp) is exactly strcmp.

Host-side code uses numpy; the device-side mirrors live in
:mod:`repro_torch.core.tensor_index`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

import numpy as np

MAX_KEY_LEN = 255  # paper: data sets processed to <= 255B


@dataclasses.dataclass
class StringSet:
    """A batch of NUL-free byte strings in padded-matrix form."""

    bytes: np.ndarray  # (N, L) uint8, zero padded
    lens: np.ndarray   # (N,) int32

    def __post_init__(self) -> None:
        assert self.bytes.dtype == np.uint8
        assert self.bytes.ndim == 2
        self.lens = np.asarray(self.lens, dtype=np.int32)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_list(keys: Sequence[bytes], width: int | None = None) -> "StringSet":
        lens = np.array([len(k) for k in keys], dtype=np.int32)
        if len(keys) == 0:
            return StringSet(np.zeros((0, width or 1), np.uint8), lens)
        L = int(lens.max()) if width is None else width
        L = max(L, 1)
        out = np.zeros((len(keys), L), dtype=np.uint8)
        for i, k in enumerate(keys):
            if len(k) > L:
                raise ValueError(f"key {i} longer than width {L}")
            if 0 in k:
                raise ValueError("keys must be NUL-free (C-string semantics, as in the paper)")
            out[i, : len(k)] = np.frombuffer(k, dtype=np.uint8)
        return StringSet(out, lens)

    # -- basic properties --------------------------------------------------
    def __len__(self) -> int:
        return self.bytes.shape[0]

    @property
    def width(self) -> int:
        return self.bytes.shape[1]

    def tolist(self) -> List[bytes]:
        return [self.bytes[i, : self.lens[i]].tobytes() for i in range(len(self))]

    def take(self, idx: np.ndarray) -> "StringSet":
        return StringSet(self.bytes[idx], self.lens[idx])

    def pad_to(self, width: int) -> "StringSet":
        if width < self.width:
            if int(self.lens.max(initial=0)) > width:
                raise ValueError("cannot narrow below max key length")
            return StringSet(np.ascontiguousarray(self.bytes[:, :width]), self.lens)
        if width == self.width:
            return self
        out = np.zeros((len(self), width), dtype=np.uint8)
        out[:, : self.width] = self.bytes
        return StringSet(out, self.lens)


# ---------------------------------------------------------------------------
# Ordering / prefix primitives (numpy, host side)
# ---------------------------------------------------------------------------

def sort_order(ss: StringSet) -> np.ndarray:
    """argsort in lexicographic (strcmp) order.  memcmp over padded rows."""
    if len(ss) == 0:
        return np.zeros((0,), np.int64)
    rows = np.ascontiguousarray(ss.bytes)
    void = rows.view(np.dtype((np.void, rows.shape[1]))).ravel()
    return np.argsort(void, kind="stable")



def is_sorted(ss: StringSet) -> bool:
    """Rows in non-decreasing memcmp order of their padded bytes, the order
    :func:`sort_order` sorts them in.  (The reference compares void views
    with ``<=``, which numpy 2 refuses: ROADMAP Queue 3.)"""
    a, b = ss.bytes[:-1], ss.bytes[1:]
    neq = a != b
    first = neq.argmax(axis=1)
    rows = np.arange(a.shape[0])
    return bool(np.all(~neq.any(axis=1) | (a[rows, first] < b[rows, first])))

def dedup_sorted(ss: StringSet) -> np.ndarray:
    """Indices of unique rows within an already sorted StringSet."""
    if len(ss) == 0:
        return np.zeros((0,), np.int64)
    eq_prev = np.all(ss.bytes[1:] == ss.bytes[:-1], axis=1) & (ss.lens[1:] == ss.lens[:-1])
    keep = np.concatenate([[True], ~eq_prev])
    return np.nonzero(keep)[0]


def pairwise_cpl(a_bytes: np.ndarray, b_bytes: np.ndarray) -> np.ndarray:
    """Common-prefix length of row i of ``a`` with row i of ``b``.

    Operates on padded matrices; the zero padding ensures the cpl never
    exceeds min(len_a, len_b) for NUL-free keys.
    """
    L = min(a_bytes.shape[1], b_bytes.shape[1])
    eq = a_bytes[:, :L] == b_bytes[:, :L]
    # first position where they differ; all-equal rows -> L
    neq = ~eq
    any_neq = neq.any(axis=1)
    first = np.where(any_neq, neq.argmax(axis=1), L)
    return first.astype(np.int32)


def group_cpl(ss: StringSet) -> int:
    """Common prefix length of *all* strings in the (non-empty) set.

    cpl of a sorted list equals cpl(first, last); we do not require sorted
    input and instead reduce columnwise.
    """
    n = len(ss)
    if n == 0:
        return 0
    if n == 1:
        return int(ss.lens[0])
    eq_first = ss.bytes == ss.bytes[0:1]
    all_eq = eq_first.all(axis=0)
    neq = ~all_eq
    cpl = int(neq.argmax()) if neq.any() else ss.width
    return min(cpl, int(ss.lens.min()))


def strip_prefix(ss: StringSet, k: int) -> StringSet:
    """Drop the first ``k`` bytes of every string (suffix view)."""
    if k == 0:
        return ss
    b = ss.bytes[:, k:]
    if b.shape[1] == 0:
        b = np.zeros((len(ss), 1), np.uint8)
    return StringSet(np.ascontiguousarray(b), np.maximum(ss.lens - k, 0))


def compare_to(ss: StringSet, key: bytes) -> np.ndarray:
    """Vectorized strcmp(ss[i], key): returns -1/0/+1 per row."""
    q = StringSet.from_list([key], width=max(ss.width, len(key), 1))
    a = ss.pad_to(q.width).bytes
    b = q.bytes[0]
    neq = a != b[None, :]
    any_neq = neq.any(axis=1)
    first = neq.argmax(axis=1)
    av = a[np.arange(len(ss)), first].astype(np.int32)
    bv = b[first].astype(np.int32)
    out = np.sign(av - bv) * any_neq
    return out.astype(np.int32)


def key_hash16(bytes_mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """16-bit FNV-1a style hash of each key (the paper's h-pointer hash).

    Must match the device implementation (``repro_torch.kernels.strops.hash16``)
    bit-for-bit: uint32 arithmetic, truncated to 16 bits at the end, over
    exactly ``min(len, width)`` bytes where ``width = bytes_mat.shape[1]``.
    Device/host agreement therefore requires hashing through a matrix of the
    *index* width — keys longer than the index width are unrepresentable and
    are rejected at insert time on both paths (tested in test_kernels.py).
    """
    h = np.full(bytes_mat.shape[0], 0x811C9DC5, dtype=np.uint32)
    for k in range(bytes_mat.shape[1]):
        active = lens > k
        c = bytes_mat[:, k].astype(np.uint32)
        nh = (h ^ c) * np.uint32(0x01000193)
        h = np.where(active, nh, h)
    return (h ^ (h >> np.uint32(16))).astype(np.uint32) & np.uint32(0xFFFF)


def pack_prefix_u64(bytes_mat: np.ndarray) -> np.ndarray:
    """First 8 bytes big-endian packed as uint64 (order preserving)."""
    n, L = bytes_mat.shape
    out = np.zeros(n, dtype=np.uint64)
    for k in range(min(8, L)):
        out |= bytes_mat[:, k].astype(np.uint64) << np.uint64(8 * (7 - k))
    return out


def random_strings(
    rng: np.random.Generator,
    n: int,
    min_len: int = 2,
    max_len: int = 32,
    alphabet: bytes = b"abcdefghijklmnopqrstuvwxyz",
) -> List[bytes]:
    lens = rng.integers(min_len, max_len + 1, size=n)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    return [alpha[rng.integers(0, len(alpha), size=l)].tobytes() for l in lens]
