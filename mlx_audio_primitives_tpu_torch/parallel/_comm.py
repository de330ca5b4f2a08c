"""The collectives of ``shard_map`` bodies, on the groups of a mesh's axes,
with the gradients JAX gives them.

``torch.distributed`` collectives do not differentiate; JAX's do, and its
``shard_map`` tracking of which values vary over an axis picks each
cotangent's collective. Each function here is one ``lax`` collective with
the transpose JAX uses at that place (Megatron's conjugate pair for the
tensor-parallel ones):

* :func:`ppermute`: a ring shift; backward shifts the other way;
* :func:`psum`: ``all_reduce`` SUM whose output is replicated over the
  axis, so its backward is the identity (``torch.distributed.nn``'s
  ``all_reduce`` would sum the cotangents again and scale them by the
  axis size);
* :func:`to_varying`: identity forward, ``all_reduce`` SUM backward, where a
  replicated value enters a computation that differs between the axis's
  ranks (channel-sharded weights, a pipeline stage's mask): the cotangent
  of a replicated value is the sum of its ranks' parts;
* :func:`all_gather`: a tiled ``all_gather``; backward keeps this rank's
  slice of the cotangent;
* :func:`all_to_all`: a tiled ``all_to_all`` (``dist.all_to_all_single``);
  backward is the same exchange with the split and concatenated dimensions
  swapped;
* :func:`psum_` and :func:`pmean_`: an in-place sum or mean over axes for
  values that take no gradient (a loss, gradients).

A group of one rank makes each of them the identity without a call, as
JAX's collectives over an axis of size 1 are. gloo has no ``AVG``, so a
mean is a SUM divided by the group's size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def _shift(x: torch.Tensor, group, shift: int, tag: int) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on in ``group``'s ring and
    return what the rank ``shift`` places back sent."""
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    me = ranks.index(dist.get_rank())
    send = x.contiguous()
    if torch.is_complex(send):
        send = torch.view_as_real(send)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(me + shift) % n], group, tag),
           dist.P2POp(dist.irecv, recv, ranks[(me - shift) % n], group, tag)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.view_as_complex(recv) if torch.is_complex(x) else recv


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift, tag):
        ctx.group, ctx.shift, ctx.tag = group, shift, tag
        return _shift(x, group, shift, tag)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.shift, ctx.tag), None, None, None


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str, shift: int,
             tag: int = 0) -> torch.Tensor:
    """``lax.ppermute`` over the ring ``k -> k + shift`` of ``axis``: every
    rank sends ``x`` on and returns what it receives. ``tag`` tells apart
    the shifts of one schedule."""
    group = _group(mesh, axis)
    if dist.get_world_size(group) == 1:
        return x
    return _Ppermute.apply(x, group, shift, tag)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(torch.view_as_real(out) if torch.is_complex(out) else out, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ToVarying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.psum`` over ``axis``, its output replicated there (backward:
    the identity)."""
    group = _group(mesh, axis)
    if dist.get_world_size(group) == 1:
        return x
    return _Psum.apply(x, group)


def to_varying(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``x``, replicated over ``axis``, entering a computation that varies
    over it: the identity, whose backward sums the cotangent over ``axis``."""
    group = _group(mesh, axis)
    if dist.get_world_size(group) == 1:
        return x
    return _ToVarying.apply(x, group)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    real = torch.view_as_real(moved) if torch.is_complex(moved) else moved
    out = torch.empty((n * real.shape[0], *real.shape[1:]), dtype=real.dtype, device=real.device)
    dist.all_gather_into_tensor(out, real, group=group)
    if torch.is_complex(x):
        out = torch.view_as_complex(out)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = dist.get_process_group_ranks(group).index(dist.get_rank())
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """Tiled ``lax.all_gather`` over ``axis`` along ``dim`` (every rank's
    ``x`` the same shape), in the axis's rank order; backward keeps this
    rank's slice."""
    group = _group(mesh, axis)
    if dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


def _exchange(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Split ``split_dim`` into one chunk per rank of ``group``, send chunk
    ``j`` to rank ``j`` and concatenate what arrives along ``concat_dim``,
    in rank order."""
    n = dist.get_world_size(group)
    moved = x.movedim(split_dim, 0)
    send = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # (rank, chunk in x's layout) -> the ranks' chunks side by side on concat_dim
    chunks = recv.movedim(1, split_dim + 1).movedim(0, concat_dim)
    shape = list(x.shape)
    shape[split_dim] //= n
    shape[concat_dim] *= n
    return chunks.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, ctx.concat_dim, ctx.split_dim), None, None, None


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Tiled ``lax.all_to_all`` over ``axis``: ``split_dim`` is split into
    one chunk per rank, chunk ``j`` goes to rank ``j`` of the axis, and the
    chunks that arrive are concatenated along ``concat_dim`` in the axis's
    rank order. Backward runs the same exchange with the two dimensions
    swapped, the transpose JAX gives it."""
    group = _group(mesh, axis)
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim % x.ndim, concat_dim % x.ndim)


def psum_(x: torch.Tensor, mesh: DeviceMesh, axes: tuple[str, ...]) -> torch.Tensor:
    """``lax.psum`` over ``axes``, in place, for a tensor that takes no
    gradient: one SUM ``all_reduce`` per axis of more than one rank."""
    for axis in axes:
        group = _group(mesh, axis)
        if dist.get_world_size(group) > 1:
            dist.all_reduce(x, group=group)
    return x


def pmean_(x: torch.Tensor, mesh: DeviceMesh, axes: tuple[str, ...]) -> torch.Tensor:
    """``lax.pmean`` over ``axes``, in place, for a tensor that takes no
    gradient: :func:`psum_`, then one divide."""
    n = 1
    for axis in axes:
        n *= dist.get_world_size(_group(mesh, axis))
    psum_(x, mesh, axes)
    if n > 1:
        x.div_(n)
    return x
