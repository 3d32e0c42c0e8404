"""K3: compact-leaf h-pointer probe (paper Sec. 3.3, Alg. 2 l.21-27).

Replaces ``repro/kernels/cnode_probe.py::_probe_kernel``.  For each query
row of a (B, K) tile of 16-bit h-pointer hashes, the first slot ``j`` with
``frm <= j < cnt`` whose hash equals the query hash, else -1.  The kernel
is ``csrc/cnode_probe.cu``; the same ``__device__`` probe runs inside K4's
compact-node resolve, which re-probes from ``idx + 1`` after a false
16-bit match.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def cnode_probe_plain(hashes, qhash, cnt, frm=None) -> torch.Tensor:
    B, K = hashes.shape
    if frm is None:
        frm = torch.zeros(B, dtype=torch.int32, device=hashes.device)
    j = torch.arange(K, device=hashes.device)[None, :]
    match = (hashes.int() == qhash.int()[:, None]) & (j < cnt[:, None]) & (j >= frm[:, None])
    first = match.int().argmax(dim=1).int()
    return torch.where(match.any(dim=1), first, -1)


def cnode_probe_cuda(hashes, qhash, cnt, frm) -> torch.Tensor:
    """Launch K3 on (B, K) int32 hashes and (B,) int32 qhash/cnt/frm."""
    B, K = hashes.shape
    dev = hashes.device
    _build.check(hashes, "hashes", torch.int32, (B, K), dev)
    for name, v in (("qhash", qhash), ("cnt", cnt), ("frm", frm)):
        _build.check(v, name, torch.int32, (B,), dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch("cnode_probe", "lits_cnode_probe", [P, P, P, P, I, I, P],
                  hashes.data_ptr(), qhash.data_ptr(), cnt.data_ptr(), frm.data_ptr(),
                  B, K, out.data_ptr())
    _build.count_launch("cnode_probe")
    return out


def cnode_probe(hashes, qhash, cnt, frm=None) -> torch.Tensor:
    """First matching h-pointer slot per query (or -1): K3 for CUDA tensors,
    the plain version for CPU ones."""
    if not hashes.is_cuda:
        return cnode_probe_plain(hashes, qhash, cnt, frm)
    B, dev = hashes.shape[0], hashes.device
    return cnode_probe_cuda(hashes, qhash, cnt,
                            _build.as_rows(0 if frm is None else frm, B, torch.int32, dev))
