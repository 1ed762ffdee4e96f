"""Flat padded slices of tensors over a process group: the storage of the
sharded-state layouts (the JAX package's ``zero._flatten_pad`` and its
sharded clip norm).

A tensor of any shape is flattened and zero-padded so that the group's
size n divides its length, then cut into n slices; rank r stores slice r
(:func:`cut`). Padding, not replication, frees the layout from
divisibility: a [500]-wide bias over 8 ranks is 8 × [63] with 4 zeros.
ZeRO (zero.py) cuts each whole tensor so over the data group; TP × FSDP
(tp_fsdp.py) cuts each rank's tensor-parallel shard. The norms that
clipping compares are here too: of a gradient cut into slices
(``sharded_norm``), and of one some of whose leaves are split over a group
(``split_norm``: TP's model group, PP's stage group).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vae_assoc_tpu_torch.ops.collectives import all_gather_rows, reduce_scatter_rows
from vae_assoc_tpu_torch.train import step as step_mod


def pad_len(size: int, n: int) -> int:
    """``size`` rounded up to a multiple of ``n``."""
    return -(-size // n) * n


def flatten_pad(t: torch.Tensor, n: int) -> torch.Tensor:
    """Any shape → flat with a zero tail so that ``n`` divides the length."""
    flat = t.reshape(-1)
    return F.pad(flat, (0, pad_len(flat.numel(), n) - flat.numel()))


def cut(t: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Rank r's flat slice of ``t`` over n ranks, a fresh tensor."""
    return flatten_pad(t.detach(), n).view(n, -1)[r].clone()


def gather_full(shards: list, shapes: list, n: int, group) -> list:
    """Every rank's slices of each tensor → the whole tensors of ``shapes``,
    in one all-gather over ``group``."""
    lens = [s.numel() for s in shards]
    got = all_gather_rows(torch.cat(shards), group).view(n, -1)
    out, off = [], 0
    for l, shape in zip(lens, shapes):
        numel = torch.Size(shape).numel()
        out.append(got[:, off:off + l].reshape(-1)[:numel].view(shape))
        off += l
    return out


def scatter_mean(grads: list, n: int, group) -> list:
    """Whole gradients on every rank → this rank's slices of their mean over
    ``group``, in one reduce-scatter: each rank keeps the sum of its
    slices, divided by n."""
    send = torch.cat([flatten_pad(g, n).view(n, -1) for g in grads], dim=1)
    mine = reduce_scatter_rows(send.reshape(-1), group).div_(n)
    return list(mine.split([pad_len(g.numel(), n) // n for g in grads]))


def sharded_norm(group):
    """The norm of a gradient whose tensors are disjoint slices of the whole:
    each rank's sum of squares, summed over ``group`` (pads add zeros)."""

    def norm(grads):
        local = step_mod.global_norm(grads)
        sq = local * local
        dist.all_reduce(sq, group=group)
        return torch.sqrt(sq)

    return norm


def split_norm(split: list, group, slice_group=None):
    """The norm of a gradient some of whose tensors are split over ``group``
    (``split[i]`` true) and the rest replicated on it: the split tensors'
    squares summed over the group, the replicated ones' counted once.
    ``slice_group``: a group over which every tensor is further cut into
    slices (TP × FSDP's data group), whose squares are summed over it."""
    on = [i for i, x in enumerate(split) if x]
    off = [i for i, x in enumerate(split) if not x]

    def norm(grads):
        sq = step_mod.global_norm([grads[i] for i in on]).square()
        dist.all_reduce(sq, group=group)
        both = torch.stack([sq, step_mod.global_norm([grads[i] for i in off]).square()])
        if slice_group is not None:
            dist.all_reduce(both, group=slice_group)
        return torch.sqrt(both.sum())

    return norm
