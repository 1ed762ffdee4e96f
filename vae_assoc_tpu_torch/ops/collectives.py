"""Flat-tensor collectives over a torch.distributed process group.

The counterparts of JAX's ``all_gather(tiled=True)`` and
``psum_scatter(tiled=True)`` along the first axis, used by the
data-parallel InfoNCE gather (ops/losses.py) and the sharded layouts
(parallel/). The process group picks the backend: NCCL for CUDA tensors,
gloo for CPU ones (or for CUDA tensors where the caller names it).

The autograd Functions below carry the collectives whose gradients a
layout writes by hand: Megatron's f and g and the column gather
(parallel/tp.py, and over the stage group parallel/pp.py), and the GPipe
ring's shift (parallel/pp.py). ``torch.distributed.nn.functional``'s
all-reduce would all-reduce the cotangent too, and where every rank
computes the same loss after it, the gradients would come back W times
too large.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# torch 2.13 renames the two flat-tensor collectives (the old names warn);
# older releases have only the old names. The arguments are the same.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[b, ...] on every rank → [W·b, ...], the ranks' rows in rank order."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x.contiguous(), group=group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[W·b, ...] on every rank → [b, ...]: the sum over the ranks of this
    rank's block of rows."""
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),) + tuple(x.shape[1:]))
    _reduce_scatter(out, x.contiguous(), group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group), None


def gather_rows_summed_grad(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_gather_rows` under autograd, whose backward sums the
    cotangent over the ranks and keeps this rank's rows, as JAX's
    ``all_gather`` transposes to ``psum_scatter``: right where every rank's
    loss reads every rank's rows (global negatives in data parallelism)."""
    return _GatherRows.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    """f: identity forward (a view, no copy), all-reduce of the cotangent
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()  # the cotangent may be shared; the all-reduce is in place
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce forward, in place on a fresh tensor (marked dirty, so
    autograd refuses the step if anything saved it), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherColumns(torch.autograd.Function):
    """[B, c] slices of the columns → [B, W·c] in rank order; the backward
    keeps this rank's columns of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.cols = rank, x.shape[1]
        w = dist.get_world_size(group)
        got = all_gather_rows(x, group).view(w, x.shape[0], x.shape[1])
        return got.permute(1, 0, 2).reshape(x.shape[0], w * x.shape[1])

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.rank * ctx.cols:(ctx.rank + 1) * ctx.cols].contiguous(), None, None


def _from_rank(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Rank ``src``'s ``x`` (of this rank's shape) on every rank of ``group``."""
    n = dist.get_world_size(group)
    return all_gather_rows(x, group).view((n,) + tuple(x.shape))[src]


class _RingShift(torch.autograd.Function):
    """Each rank's tensor to the next rank of the group, r → r + 1 mod n,
    JAX's ``ppermute`` with that permutation; the backward shifts the
    cotangent back, r → r − 1. One all-gather carries each: NCCL and gloo
    both run it on CUDA tensors, where gloo has no send/recv."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.group, ctx.rank = group, rank
        return _from_rank(x, group, (rank - 1) % dist.get_world_size(group))

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return _from_rank(g, ctx.group, (ctx.rank + 1) % n), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f over ``group``: where a replicated activation enters a
    split layer."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g over ``group``: the sum of the ranks' partial products
    (``x`` fresh, summed in place)."""
    return _ReduceFromModel.apply(x, group)


def gather_columns(x: torch.Tensor, group, rank: int) -> torch.Tensor:
    """The ranks' column slices side by side, in rank order."""
    return _GatherColumns.apply(x, group, rank)


def ring_shift(x: torch.Tensor, group, rank: int) -> torch.Tensor:
    """The previous rank's ``x`` (``rank`` is this one's in ``group``)."""
    return _RingShift.apply(x, group, rank)
