"""Collectives over one axis of the mesh, with their gradients.

What the JAX package gets from `lax.ppermute`, `lax.psum` and the
collectives XLA inserts for a `NamedSharding`, the port calls here
explicitly, as `torch.autograd.Function`s whose backward is the
collective's transpose:

  ring_shift        x to the next rank of the axis (offset 1); backward:
                    the shift back
  sum_over_axis     the sum over the axis; backward: the identity (each
                    rank keeps the gradient of its own term)
  copy_to_axis      the identity; backward: the sum over the axis (each
                    rank's part of the gradient of a shared input)
  gather_over_axis  the ranks' blocks concatenated along a dimension;
                    backward: this rank's own block of the gradient

`torch.distributed.nn.functional`'s `all_reduce` and `all_gather` sum the
gradient in the backward: on an axis over which every rank computes the
same loss (tp, pp and ep here) that gives the axis size times the
gradient, so they are not used.

Every collective goes through the host: a CUDA tensor is copied to the
CPU, sent over the group's backend (gloo: the ranks of a mesh may share
one card, which NCCL refuses) and copied back. A collective over a group
of one rank (`Mesh.group` None) is the identity.

Each rank's backward must run the same collectives in the same order, so
a function whose output feeds nothing on some ranks must still be given
a (zero) gradient there: the callers keep every such output in the graph.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import Axes, Mesh


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True).contiguous()


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """The sum of `x` over the ranks of `axes` (no gradient)."""
    group = mesh.group(axes)
    if group is None:
        return x.detach().clone()
    buf = _host(x)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes) -> List[torch.Tensor]:
    """Every rank's `x` over `axes`, in the order of `Mesh.index` (no
    gradient)."""
    group = mesh.group(axes)
    if group is None:
        return [x.detach().clone()]
    buf = _host(x)
    out = [torch.empty_like(buf) for _ in range(mesh.size(axes))]
    dist.all_gather(out, buf, group=group)
    return [t.to(x.device) for t in out]


def shift(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str,
          offset: int = 1) -> List[torch.Tensor]:
    """Each of `tensors` sent `offset` ranks on around `axis`'s ring, and
    the tensors of the rank `offset` back received in their place (no
    gradient)."""
    n = mesh.size(axis)
    if n == 1 or offset % n == 0:
        return [t.detach().clone() for t in tensors]
    i = mesh.index(axis)
    dst = mesh.rank_at(**{axis: (i + offset) % n})
    src = mesh.rank_at(**{axis: (i - offset) % n})
    sends = [_host(t) for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    works = []
    for tag, (out, into) in enumerate(zip(sends, recvs)):
        works.append(dist.isend(out, dst, tag=tag))
        works.append(dist.irecv(into, src, tag=tag))
    for work in works:
        work.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, offset):
        ctx.mesh, ctx.axis, ctx.offset = mesh, axis, offset
        return shift([x], mesh, axis, offset)[0]

    @staticmethod
    def backward(ctx, g):
        return shift([g], ctx.mesh, ctx.axis, -ctx.offset)[0], None, None, None


class _SumOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh, ctx.axes), None, None


class _GatherOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.index, ctx.size, ctx.dim = mesh.index(axes), x.shape[dim], dim
        return torch.cat(all_gather(x, mesh, axes), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None


def ring_shift(x: torch.Tensor, mesh: Mesh, axis: str, offset: int = 1) -> torch.Tensor:
    return _RingShift.apply(x, mesh, axis, offset)


def sum_over_axis(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    return _SumOverAxis.apply(x, mesh, axes)


def copy_to_axis(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    return _CopyToAxis.apply(x, mesh, axes)


def gather_over_axis(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int = 0) -> torch.Tensor:
    return _GatherOverAxis.apply(x, mesh, axes, dim)
