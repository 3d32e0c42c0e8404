"""Logical-axis sharding rules for the production mesh: the port of
:mod:`repro.distributed.sharding` over a
``torch.distributed.device_mesh.DeviceMesh`` and DTensor placements.

Physical meshes (launch/mesh.py):
  single-pod: (data=16, model=16)          axes ("data", "model")
  multi-pod : (pod=2, data=16, model=16)   axes ("pod", "data", "model")

Logical axes used by the model code:

  batch -> all data-parallel axes (("pod",) +) ("data",)
  fsdp  -> parameter sharding over the same data axes (ZeRO-3 style)
  tp    -> ("model",)  tensor/expert parallelism
  None  -> replicated

``spec(*logical)`` gives the reference's PartitionSpec entries as a tuple
(one mesh-axis tuple or ``None`` per tensor dimension); ``named_sharding``
gives the DTensor placements they mean on the mesh (one per mesh dimension).
When no mesh is active (CPU smoke tests) constraints are no-ops, so the same
code runs everywhere.

The collectives over mesh axes (``psum`` and the differentiable
``all_reduce``) are the ones the model's mesh paths need: the
reference's ``shard_map`` bodies call ``jax.lax.psum`` and friends, and its
GSPMD step sums losses and norms over every shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class MeshRules:
    batch: Tuple[str, ...]
    fsdp: Tuple[str, ...]
    tp: Tuple[str, ...]

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        got = getattr(self, logical)
        return got if got else None

    def spec(self, *logical: Optional[str]) -> tuple:
        return tuple(self.resolve(l) for l in logical)


def rules_for_mesh(mesh: DeviceMesh) -> MeshRules:
    names = mesh.mesh_dim_names
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    tp_axes = tuple(a for a in ("model",) if a in names)
    return MeshRules(batch=data_axes, fsdp=data_axes, tp=tp_axes)


def set_mesh(mesh: Optional[DeviceMesh]) -> None:
    _state.mesh = mesh
    _state.rules = rules_for_mesh(mesh) if mesh is not None else None


def get_mesh() -> Optional[DeviceMesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_scope(mesh: Optional[DeviceMesh]):
    """``mesh`` active in this thread inside the block, the one before
    restored after.  The mesh is thread-local, as in the reference, and
    autograd may run a backward (and a checkpointed block's recompute) on a
    thread of its own: code that runs there takes its mesh from the
    forward's thread through this."""
    before = get_mesh()
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(before)


def rules() -> Optional[MeshRules]:
    return getattr(_state, "rules", None)


def spec(*logical: Optional[str]) -> tuple:
    r = rules()
    if r is None:
        return ()
    return r.spec(*logical)


def placements(entries: Sequence, mesh: Optional[DeviceMesh] = None) -> tuple:
    """The DTensor placements of PartitionSpec ``entries`` on ``mesh`` (the
    active one by default): ``Shard(i)`` on every mesh dim that tensor dim i
    maps to, ``Replicate()`` on the others.  A tensor dim over several mesh
    dims is split in their order, major first, as a PartitionSpec splits it."""
    mesh = get_mesh() if mesh is None else mesh
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(entries) if e is not None and name in e]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def named_sharding(*logical: Optional[str]) -> Optional[tuple]:
    mesh = get_mesh()
    if mesh is None:
        return None
    return placements(spec(*logical), mesh)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axis names;
    no-op without a mesh.  With one, a DTensor is redistributed to those
    placements and a plain tensor (a rank's local activations) is returned
    unchanged.  As in the reference, a constraint never changes a value,
    only where its pieces live."""
    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec(*logical), mesh))


# ---------------------------------------------------------------------------
# placing tensors, and collectives over mesh axes
# ---------------------------------------------------------------------------

def axis_size(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    mesh = get_mesh() if mesh is None else mesh
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    """This rank's coordinate along mesh axis ``axis``."""
    mesh = get_mesh() if mesh is None else mesh
    return mesh.get_local_rank(axis)


def local_chunk(t: torch.Tensor, place: Sequence, mesh: Optional[DeviceMesh] = None):
    """This rank's piece of the whole tensor ``t`` under ``place``: split
    along each sharded dim in mesh-dim order by ``torch.chunk``, a rank past
    the last chunk holding an empty piece, as DTensor splits it."""
    mesh = get_mesh() if mesh is None else mesh
    for name, p in zip(mesh.mesh_dim_names, place):
        if isinstance(p, Shard):
            pieces = torch.chunk(t, axis_size(name, mesh), dim=p.dim)
            i = axis_index(name, mesh)
            t = pieces[i] if i < len(pieces) else t.narrow(p.dim, t.shape[p.dim], 0)
    return t


def distribute(t: torch.Tensor, place: Sequence,
               mesh: Optional[DeviceMesh] = None) -> DTensor:
    """A DTensor of placements ``place`` built from the whole tensor ``t``,
    which every rank holds: each rank keeps its own piece (a copy, so that
    ``t`` can be freed), with no communication."""
    mesh = get_mesh() if mesh is None else mesh
    piece = local_chunk(t, place, mesh)
    piece = piece.clone() if piece.numel() < t.numel() else piece.contiguous()
    return DTensor.from_local(piece, mesh, tuple(place), run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())


def gather(t: torch.Tensor, sum_axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """``t`` whole, for use in a product: a DTensor is gathered from its
    shards, and its gradient goes back reduce-scattered, summed over the mesh
    axes ``sum_axes`` (by default the batch axes, whose ranks hold other
    rows) and taken as it is over the others (``model``, whose ranks compute
    the same dense values).  A plain tensor is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    if sum_axes is None:
        r = rules()
        sum_axes = r.batch if r is not None else ()
    grad = [Partial() if a in sum_axes else Replicate() for a in t.device_mesh.mesh_dim_names]
    return t.full_tensor(grad_placements=grad)


def _groups(axes: Sequence[str], mesh: Optional[DeviceMesh] = None) -> list:
    """The process groups of the mesh axes in ``axes`` that hold more than
    one rank (a sum over one rank is the identity)."""
    mesh = get_mesh() if mesh is None else mesh
    return [mesh.get_group(a) for a in axes if axis_size(a, mesh) > 1]


def psum(x: torch.Tensor, axes: Sequence[str],
         mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """The sum of ``x`` over the mesh axes ``axes`` (of ``mesh``, the active
    one by default), outside autograd (losses, token counts, norms,
    metrics)."""
    groups = _groups(axes, mesh)
    if not groups:
        return x
    x = x.detach().clone()
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _AllReduce(torch.autograd.Function):
    """A sum over process groups in the forward and/or the backward."""

    @staticmethod
    def forward(ctx, x, groups, fwd: bool, bwd: bool):
        ctx.groups, ctx.bwd = groups, bwd
        x = x.clone()
        if fwd:
            for g in groups:
                dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, ct):
        ct = ct.clone()
        if ctx.bwd:
            for g in ctx.groups:
                dist.all_reduce(ct, group=g)
        return ct, None, None, None


def all_reduce(x: torch.Tensor, axes: Sequence[str], *, forward: bool = True,
               backward: bool = True) -> torch.Tensor:
    """A differentiable sum over the mesh axes ``axes``, in the forward, the
    backward or both.  Every rank backpropagates its own copy of the loss, so
    the reference's ``shard_map`` transposes read:

    * ``psum`` over axes whose ranks hold different values (the expert
      partials over the fsdp axes): a sum both ways;
    * ``psum`` over ``model`` of the expert outputs, whose cotangent every
      ``model`` rank already holds whole (the reference divides it by the
      axis size, then its transpose sums it back): ``backward=False``;
    * an input replicated over ``model`` whose cotangent the reference sums
      over that axis: ``forward=False``.
    """
    groups = _groups(axes)
    if not groups:
        return x
    return _AllReduce.apply(x, groups, forward, backward)
