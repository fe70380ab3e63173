"""Collectives of the multi-process trainer, as ``torch.autograd.Function``s.
Counterpart of ``visualrwkv_tpu/parallel/collectives.py`` and of the
``ppermute`` / ``psum`` calls of the JAX package's manual regions.

The convention of every path: a parameter's gradient is SUMMED over the
``seq`` ranks (each holds a part of the tokens) and AVERAGED over the
``data`` ranks (each holds a part of the rows), reduced in fp32 and
rounded once to the gradient's dtype (:func:`reduce_gradients`, the
numerics of ``psum_cotangents_f32``).

- :func:`ppermute`: ``x`` to the rank ``shift`` further along a group; the
  backward sends the cotangent the other way. Both directions are posted in
  one ``batch_isend_irecv``, so two ranks never wait on each other.
- :func:`all_reduce_replicated`: the sum (or mean) of a value every rank
  uses alike, whose backward is the identity: the transpose of JAX's
  ``psum`` to an invariant value. (``torch.distributed.nn``'s
  ``all_reduce`` sums the cotangents instead, which counts a replicated
  loss's gradient once a rank.)
- :func:`gather_leaf`: ZeRO-3's parameter gather along the leaf's split dim,
  whose backward sums the cotangent over ``seq`` and reduce-scatters it over
  ``data`` in fp32, divided by the data size.

A group of None is a group of one: nothing is sent.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# fp32 elements a gradient bucket holds (256 MiB): the fp32 copies of bf16
# gradients are made a bucket at a time, never for the whole tree at once
BUCKET_NUMEL = 64 * 1024 * 1024


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


@torch.no_grad()
def reduce_gradients(grads: List[Tensor], group, divide: float = 1.0) -> None:
    """Sum ``grads`` over ``group`` in place, in fp32 buckets of at most
    ``BUCKET_NUMEL`` elements, divide by ``divide`` in fp32 and round once
    to each gradient's dtype. The gradients must be contiguous."""
    grads = [g for g in grads if g.numel()]
    if group is None or not grads:
        if divide != 1.0:
            torch._foreach_div_(grads, divide)
        return
    total = sum(g.numel() for g in grads)
    buf = torch.empty(min(BUCKET_NUMEL, total), dtype=torch.float32, device=grads[0].device)
    pending, fill = [], 0

    def flush():
        nonlocal fill
        part = buf[:fill]
        dist.all_reduce(part, group=group)
        if divide != 1.0:
            part.div_(divide)
        for dst, start in pending:
            dst.copy_(part[start:start + dst.numel()])
        pending.clear()
        fill = 0

    for g in grads:
        flat, off = g.view(-1), 0
        while off < flat.numel():
            n = min(flat.numel() - off, buf.numel() - fill)
            buf[fill:fill + n].copy_(flat[off:off + n])
            pending.append((flat[off:off + n], fill))
            fill, off = fill + n, off + n
            if fill == buf.numel():
                flush()
    if fill:
        flush()


def _exchange(x: Tensor, group, shift: int) -> Tensor:
    D, r = group_size(group), group_rank(group)
    if D == 1 or shift % D == 0:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (r + shift) % D)
    frm = dist.get_global_rank(group, (r - shift) % D)
    ops = [dist.P2POp(dist.isend, x, to, group), dist.P2POp(dist.irecv, out, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _exchange(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, -ctx.shift), None, None


def ppermute(x: Tensor, group, shift: int = 1) -> Tensor:
    """``x`` of the rank ``shift`` places back along ``group`` (cyclic), the
    JAX ``ppermute`` with pairs ``(s, (s + shift) % D)``. Every rank of the
    group must call it, and must use the result (a rank that discards it
    keeps it in the graph with ``torch.where``), so that the backward's
    exchange runs on every rank too."""
    return _PPermute.apply(x, group, shift)


class _ReplicatedAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mean):
        out = x.detach().clone()
        if group is not None:
            dist.all_reduce(out, group=group)
        return out / group_size(group) if mean else out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce_replicated(x: Tensor, group, mean: bool = False) -> Tensor:
    """The sum (``mean``: the mean) of ``x`` over ``group``, a value every
    rank then holds alike; the backward passes the cotangent through
    unchanged."""
    return _ReplicatedAllReduce.apply(x, group, mean)


def all_gather_along(shard: Tensor, axis: int, group) -> Tensor:
    """The whole leaf from every rank's equal part along ``axis``, in the
    shard's dtype."""
    D = group_size(group)
    if D == 1:
        return shard
    s = shard.contiguous()
    out = torch.empty(D * s.numel(), dtype=s.dtype, device=s.device)
    dist.all_gather_into_tensor(out, s.reshape(-1), group=group)
    parts = out.view(D, *s.shape)
    return parts.reshape(D * s.shape[0], *s.shape[1:]) if axis == 0 else torch.cat(parts.unbind(0), axis)


def reduce_scatter_along(full: Tensor, axis: int, group) -> Tensor:
    """This rank's part along ``axis`` of the sum of ``full`` over ``group``."""
    D = group_size(group)
    if D == 1:
        return full
    parts = torch.stack(full.chunk(D, dim=axis))
    out = torch.empty(parts.shape[1:], dtype=full.dtype, device=full.device)
    dist.reduce_scatter_tensor(out.view(-1), parts.reshape(-1), group=group)
    return out


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, axis, data_group, seq_group):
        ctx.axis, ctx.data_group, ctx.seq_group = axis, data_group, seq_group
        full = all_gather_along(shard, axis, data_group)
        return full.clone() if full is shard else full

    @staticmethod
    def backward(ctx, g):
        g32 = g.float().contiguous()
        if ctx.seq_group is not None:
            dist.all_reduce(g32, group=ctx.seq_group)
        part = reduce_scatter_along(g32, ctx.axis, ctx.data_group) / group_size(ctx.data_group)
        return part.to(g.dtype), None, None, None


def gather_leaf(shard: Tensor, axis: int, data_group, seq_group=None) -> Tensor:
    """ZeRO-3's gather of a parameter split over ``data_group`` along
    ``axis``. Its backward gives the shard its part of the gradient summed
    over ``seq_group``, averaged over ``data_group``, reduced in fp32 and
    rounded once."""
    return _GatherLeaf.apply(shard, axis, data_group, seq_group)
