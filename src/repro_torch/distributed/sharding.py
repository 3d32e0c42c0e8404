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


def axes_extent(axes: Sequence[str], mesh: Optional[DeviceMesh] = None) -> Tuple[int, int]:
    """(the number of ranks over the mesh axes ``axes`` of ``mesh`` (the
    active one by default), this rank's index among them, the major axis
    first as a PartitionSpec splits a dim); (1, 0) for none."""
    n, j = 1, 0
    for a in axes:
        n, j = n * axis_size(a, mesh), j * axis_size(a, mesh) + axis_index(a, mesh)
    return n, j


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


def _sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """A copy of ``x`` summed over each process group in turn; a bf16 tensor
    is summed in float32 and rounded once, as the reference's partitioner
    on the CPU sums its bf16 all-reduces (XLA promotes them to float32)."""
    y = x.float() if x.dtype == torch.bfloat16 else x.clone()
    for g in groups:
        dist.all_reduce(y, group=g)
    return y.to(x.dtype)


class _AllReduce(torch.autograd.Function):
    """A sum over process groups in the forward and/or the backward."""

    @staticmethod
    def forward(ctx, x, groups, fwd: bool, bwd: bool):
        ctx.groups, ctx.bwd = groups, bwd
        return _sum_over(x, groups) if fwd else x.clone()

    @staticmethod
    def backward(ctx, ct):
        return (_sum_over(ct, ctx.groups) if ctx.bwd else ct.clone()), None, None, None


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


def pmax(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The elementwise max of ``x`` over the mesh axes ``axes``, outside
    autograd."""
    groups = _groups(axes)
    if not groups:
        return x
    x = x.detach().clone()
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


# ---------------------------------------------------------------------------
# dense tensor parallelism over ``model``
# ---------------------------------------------------------------------------
#
# Each ``model`` rank computes its share of the dense work at the reference's
# "tp" points: the columns of a weight split ("fsdp", "tp") and the rows of
# one split ("tp", "fsdp"), so that a rank holds H/m heads, f/m hidden units,
# d_inner/m mamba channels and V/m vocabulary entries.  Activations outside
# those regions are whole on every ``model`` rank.  Every rank backpropagates
# its own copy of the loss, so a region is entered through ``tp_enter`` (the
# identity forward, the cotangent summed over ``model``: each rank's only
# reaches its own share) and left through ``tp_exit`` (the partial products
# summed forward, the identity backward).  On a mesh whose ``model`` axis has
# one rank the sums still go through the axis's process group.

def tp_size() -> int:
    """The ``model`` axis size of the active mesh (1 without one)."""
    mesh = get_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return axis_size("model", mesh)


def tp_rank() -> int:
    """This rank's coordinate on ``model`` (0 without a mesh)."""
    return axis_index("model") if tp_size() > 1 else 0


def _tp_group() -> list:
    mesh = get_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return []
    return [mesh.get_group("model")]


def _tp_all_reduce(x: torch.Tensor, forward: bool, backward: bool) -> torch.Tensor:
    groups = _tp_group()
    return _AllReduce.apply(x, groups, forward, backward) if groups else x


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """``x``, whole on every ``model`` rank, entering a split region: the
    identity forward, the cotangent summed over ``model``."""
    return _tp_all_reduce(x, False, True)


def tp_exit(x: torch.Tensor) -> torch.Tensor:
    """The ranks' partial products of a split region summed over ``model``;
    the identity backward."""
    return _tp_all_reduce(x, True, False)


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """A partial product summed over ``model`` that each rank then uses only
    in its own share (mamba's ``x_proj`` output): a sum both ways."""
    return _tp_all_reduce(x, True, True)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` along dim 0 with split sizes; the backward sends
    the cotangents back the same way."""

    @staticmethod
    def forward(ctx, x, group, out_splits, in_splits):
        ctx.group, ctx.splits = group, (out_splits, in_splits)
        out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), out_splits, in_splits, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        out_splits, in_splits = ctx.splits
        back = ct.new_empty((sum(in_splits),) + tuple(ct.shape[1:]))
        dist.all_to_all_single(back, ct.contiguous(), in_splits, out_splits, group=ctx.group)
        return back, None, None, None


def tp_halves(xz: torch.Tensor):
    """``(xs, z)``, this rank's channels of both halves of a product against
    a ``(d, 2·C)`` weight split ``(·, "tp")`` (mamba's ``in_proj``, whose
    columns are ``[xs | z]``).  The weight is stored in column chunks, so
    over m > 1 ranks rank s's product holds channel chunks 2s and 2s + 1 of
    ``xs`` (s < m/2) or of ``z`` (s >= m/2); one all-to-all over ``model``
    sends each chunk to the rank whose channels it holds: the activations
    move, not the weight.  Without a split, ``xz``'s two halves."""
    m = tp_size()
    if m == 1:
        return torch.chunk(xz, 2, dim=-1)
    r, half = tp_rank(), m // 2
    q = xz.shape[-1] // 2
    dest = 2 * r - (m if r >= half else 0)
    send = xz.reshape(-1, 2, q).transpose(0, 1)             # (2, rows, q)
    in_splits = [1 if i in (dest, dest + 1) else 0 for i in range(m)]
    out_splits = [1 if i in (r // 2, half + r // 2) else 0 for i in range(m)]
    got = _AllToAll.apply(send, _tp_group()[0], out_splits, in_splits)
    xs, z = (t.reshape(xz.shape[:-1] + (q,)) for t in got)
    return xs, z


def tp_piece(w: torch.Tensor, logical: Sequence[Optional[str]], *,
             whole: bool = False) -> torch.Tensor:
    """The piece of weight ``w`` (laid out by ``logical``) this rank computes
    with: gathered over the fsdp axes, and split over ``model`` along its
    ``"tp"`` dim as it is stored, or with ``whole`` gathered whole (the rank
    then takes what it needs).  Its gradient goes back summed over the batch
    axes, kept split over ``model``, or, for a ``whole`` piece, summed over
    ``model`` too; a weight with no ``"tp"`` dim is used alike by every
    ``model`` rank, which all hold its whole gradient.  A plain tensor is
    every rank's whole copy: its ``model`` piece is a slice.  Without a mesh,
    ``w`` itself."""
    mesh = get_mesh()
    if mesh is None:
        return w
    tp_dim = list(logical).index("tp") if "tp" in logical else None
    split = tp_dim is not None and not whole
    if not isinstance(w, DTensor):
        if not split:
            return w
        return local_chunk(w, placements([("model",) if i == tp_dim else None
                                          for i in range(w.dim())], mesh), mesh)
    batch = rules().batch
    place, grad = [], []
    for a in mesh.mesh_dim_names:
        if a == "model" and split:
            place.append(Shard(tp_dim))
            grad.append(Shard(tp_dim))
        else:
            place.append(Replicate())
            partial = a in batch or (a == "model" and tp_dim is not None)
            grad.append(Partial() if partial else Replicate())
    return w.redistribute(mesh, place).to_local(grad_placements=grad)
