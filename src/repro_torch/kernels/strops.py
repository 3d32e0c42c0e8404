"""String primitives on tensors — the plain-PyTorch counterparts of
:mod:`repro.kernels.strops`, with the same semantics bit for bit.

* Indexing is clamped into the pool, as the reference's ``mode="clip"``
  gathers are: torch indexing would raise on the CPU and assert on the card.
* FNV-1a runs in int64 with ``& 0xFFFFFFFF``, which is uint32 wraparound.
* The first differing byte is found with ``argmax`` over an int tensor,
  which returns the first maximum.

``hash16``/``hash32`` consume exactly ``min(len, width)`` bytes of each
padded row; the ``width + 1`` over-width sentinel (``pad_queries``) is a
length no stored key has, so ``str_eq`` misses it.
"""
from __future__ import annotations

import torch

FNV_PRIME = 0x01000193
FNV_OFFSET = 0x811C9DC5
U32 = 0xFFFFFFFF


def take(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]`` with the index clamped into the pool."""
    return pool[idx.long().clamp(0, pool.shape[0] - 1)]


def gather_bytes(pool: torch.Tensor, off: torch.Tensor, width: int) -> torch.Tensor:
    """(B,) offsets -> (B, width) byte windows from a flat pool (clamped)."""
    return take(pool, off.long()[:, None] + torch.arange(width, device=off.device)[None, :])


def str_eq(qbytes, qlens, pool, off, klen) -> torch.Tensor:
    """Exact string equality: bytes AND length must match."""
    W = qbytes.shape[1]
    kb = gather_bytes(pool, off, W)
    mask = torch.arange(W, device=qbytes.device)[None, :] < klen[:, None]
    kb = torch.where(mask, kb, torch.zeros_like(kb))
    return (kb == qbytes).all(dim=1) & (qlens == klen)


def str_cmp_prefix(qbytes, pool, off, pl) -> torch.Tensor:
    """sign(strncmp(q, pool[off:], pl)) per row; q zero-padded.  int32."""
    W = qbytes.shape[1]
    kb = gather_bytes(pool, off, W)
    mask = torch.arange(W, device=qbytes.device)[None, :] < pl[:, None]
    kv = torch.where(mask, kb.int(), 0)
    qv = torch.where(mask, qbytes.int(), 0)
    neq = kv != qv
    any_neq = neq.any(dim=1)
    first = neq.int().argmax(dim=1, keepdim=True)
    d = qv.gather(1, first)[:, 0] - kv.gather(1, first)[:, 0]
    return torch.sign(d) * any_neq.int()


def _fnv1a(qbytes, qlens) -> torch.Tensor:
    """Rolling FNV-1a over min(len, width) bytes of each padded row (int64)."""
    B, W = qbytes.shape
    h = torch.full((B,), FNV_OFFSET, dtype=torch.int64, device=qbytes.device)
    for k in range(W):
        nh = ((h ^ qbytes[:, k].long()) * FNV_PRIME) & U32
        h = torch.where(qlens > k, nh, h)
    return h


def hash16(qbytes, qlens) -> torch.Tensor:
    """Counterpart of ``strings.key_hash16`` (same width): int32."""
    h = _fnv1a(qbytes, qlens)
    return ((h ^ (h >> 16)) & 0xFFFF).int()


def hash32(qbytes, qlens) -> torch.Tensor:
    """Full 32-bit rolling hash (delta-buffer hash table), as int64 in [0, 2**32)."""
    return _fnv1a(qbytes, qlens)
