"""Flat-tensor collectives over a torch.distributed process group.

The counterparts of JAX's ``all_gather(tiled=True)`` and
``psum_scatter(tiled=True)`` along the first axis, used by the
data-parallel InfoNCE gather (ops/losses.py) and the sharded layouts
(parallel/). The process group picks the backend: NCCL for CUDA tensors,
gloo for CPU ones.
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
