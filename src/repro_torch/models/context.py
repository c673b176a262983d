"""Mesh context for mesh-aware layers (the reference's
``repro/models/context.py``): expert parallelism, the sharding constraints
of ``models.common`` and the sharded train step read it. With no mesh set,
every layer takes its collective-free local path, bit for bit as before.

``mesh`` is a ``torch.distributed.DeviceMesh`` with named dims, or an
:class:`AbstractMesh` (names and sizes only, no process group): the spec
functions of ``launch.sharding`` read only axis names and sizes, so the
table can be checked at the production sizes in one process.

:func:`psum`, :func:`all_gather` and :func:`all_to_all` are the
collectives of the sharded step over named axes, differentiable: the
backward of a sum is a sum, of a gather the sum of the ranks' gradients
of this rank's block, of an exchange the reverse exchange. Every rank
evaluates the same global loss and seeds its backward with ``1 / world``,
so these adjoints give each rank its share of the gradient of the loss,
and a parameter's gradient is the sum of its copies' (``launch.train``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["AbstractMesh", "MeshContext", "all_gather", "all_to_all", "axis_rank", "axis_sizes",
           "gathered", "get_mesh_context", "local_shard", "mesh_context", "psum",
           "reduce_over_shards", "set_mesh_context", "shard_like"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes without devices (``jax.sharding.
    AbstractMesh``)."""

    axis_shape: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_shape))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or an :class:`AbstractMesh`."""
    if mesh is None:
        return {}
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


@dataclasses.dataclass(frozen=True)
class MeshContext:
    mesh: Optional[Any] = None
    dp_axes: tuple[str, ...] = ()  # batch / FSDP axes ("pod", "data")
    tp_axis: Optional[str] = None  # tensor-parallel axis ("model")
    ep_axis: Optional[str] = None  # expert-parallel axis (usually == tp_axis)
    fsdp_axes: tuple[str, ...] = ()  # parameter-sharding axes for ZeRO-3
    seq_axis: Optional[str] = None  # KV/sequence sharding axis for long decode

    @property
    def sizes(self) -> dict:
        return axis_sizes(self.mesh)

    @property
    def ep_size(self) -> int:
        if self.mesh is None or self.ep_axis is None:
            return 1
        return self.sizes[self.ep_axis]

    @property
    def token_axes(self) -> tuple[str, ...]:
        """Axes the flattened token dim is sharded over for MoE dispatch."""
        axes = tuple(self.dp_axes)
        if self.ep_axis:
            axes = axes + (self.ep_axis,)
        return axes


_CTX = MeshContext()


def set_mesh_context(ctx: MeshContext) -> None:
    global _CTX
    _CTX = ctx


def get_mesh_context() -> MeshContext:
    return _CTX


@contextlib.contextmanager
def mesh_context(ctx: MeshContext):
    global _CTX
    prev = _CTX
    _CTX = ctx
    try:
        yield
    finally:
        _CTX = prev


def axis_rank(ctx: MeshContext, axis: str) -> int:
    """This rank's coordinate along ``axis`` of the context's mesh."""
    return ctx.mesh.get_local_rank(axis)


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; its backward sums the gradients the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """The ranks' ``x`` concatenated on dim 0 in ``group``'s rank order;
    its backward is the sum of the ranks' gradients of this rank's block
    (an all-reduce, then the block: gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return g.chunk(n)[dist.get_rank(ctx.group)], None


class _AllToAll(torch.autograd.Function):
    """Block j of dim 0 to rank j of ``group``, block i of the result from
    rank i; the backward is the same exchange of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        y = torch.empty_like(g)
        dist.all_to_all_single(y, g, group=ctx.group)
        return y, None


def psum(x, ctx: MeshContext, axes):
    """``x`` summed over the mesh ``axes`` (one all-reduce an axis, in the
    order given), differentiable; the identity over no axes or size-1
    ones."""
    for ax in axes:
        if ctx.sizes[ax] > 1:
            x = _AllReduce.apply(x, ctx.mesh.get_group(ax))
    return x


def all_gather(x, ctx: MeshContext, axis: str):
    """The ranks' ``x`` along ``axis`` concatenated on dim 0 in rank order,
    differentiable."""
    if ctx.sizes[axis] == 1:
        return x
    return _AllGather.apply(x, ctx.mesh.get_group(axis))


def all_to_all(x, ctx: MeshContext, axis: str):
    """``jax.lax.all_to_all(split_axis=0, concat_axis=0)`` over ``axis``:
    block j of dim 0 to the rank at j, differentiable."""
    return _AllToAll.apply(x, ctx.mesh.get_group(axis))


def gathered(t, keep: Optional[str] = None):
    """A DTensor parameter as the plain tensor a rank computes with: all
    its shards gathered (ZeRO-3's gather at the use site), except along the
    mesh axis ``keep``, where this rank's shard stays. Its gradient is the
    sum of every rank's (``Partial``), reduced back onto the parameter's
    placements in the backward. A plain tensor is returned as is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names
    own = [pl if n == keep else Replicate() for n, pl in zip(names, t.placements)]
    grads = [pl if n == keep else Partial() for n, pl in zip(names, t.placements)]
    return t.redistribute(t.device_mesh, own).to_local(grad_placements=grads)


def reduce_over_shards(x, like, op=None):
    """A reduction ``x`` of ``like``'s local shard (a sum by default) over
    the mesh dims on which the DTensor ``like`` is sharded, in place: the
    reduction of the whole tensor. ``x`` as is for a plain ``like``."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(like, DTensor):
        return x
    mesh = like.device_mesh
    for i, pl in enumerate(like.placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=mesh.get_group(i))
    return x


def local_shard(t):
    """A DTensor's local shard (the tensor itself otherwise)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def shard_like(local, like):
    """``local`` as this rank's shard of a DTensor laid out as ``like``
    (``local`` itself for a plain ``like``)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())
