"""Collectives of the port's parallelism, carried through autograd.

A :class:`Group` is one process group of the mesh (the whole world, the
data group or the model group; parallel/mesh.py) seen from this rank: its
size, this rank's index in it, and its raw collectives.  A group of size 1
(one process, or a mesh axis of 1) makes every collective the identity, so
the same code runs in one process without ``torch.distributed``.

Gloo and CUDA tensors: on PyTorch 2.11 (cu128) on an H100, gloo takes CUDA
tensors in ``all_reduce``, ``broadcast``, ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and ``barrier``
(gloo copies them through host memory itself), but ``send`` / ``recv`` of
a CUDA tensor abort the process (``gloo::IoException``, writev: Bad
address).  So the port uses collectives only, passes CUDA tensors to them
as they are, and stages nothing itself (ROADMAP.md records the probe).

The autograd functions (:func:`all_reduce_sum`, :func:`all_gather`,
:func:`halo_exchange`) assume what a data-parallel step computes: every
rank's loss is a term of one global loss, the sum over the ranks.  So the
backward of an all-reduce is the all-reduce of the gradients, and the
backward of an all-gather is the sum over the ranks of the gradients of
this rank's slice (an all-reduce, then the slice: gloo has no
reduce-scatter on CUDA tensors).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


class Group:
    """A process group as this rank sees it.

    ``ranks`` are the global ranks of the group in index order; ``pg`` the
    ``torch.distributed`` group (None for a group of size 1)."""

    def __init__(self, ranks: Sequence[int], rank: int, pg=None):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self.pg = pg
        if self.size > 1 and pg is None:
            raise ValueError(f"a group of {self.size} ranks needs a process group")

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum of ``t`` over the group."""
        if self.size > 1:
            dist.all_reduce(t, group=self.pg)
        return t

    def all_gather_raw(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` in index order."""
        if self.size == 1:
            return t[None]
        src = t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.pg)
        return torch.stack(out)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """The group's first rank's ``t`` on every rank, in place."""
        if self.size > 1:
            dist.broadcast(t, self.ranks[0], group=self.pg)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group, out of place, outside autograd."""
        return self.all_reduce_(t.detach().clone()) if self.size > 1 else t.detach()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.clone()), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather_raw(x)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        return group.all_reduce_(g.contiguous().clone())[group.index], None


def all_reduce_sum(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank; its gradient is the
    sum of the ranks' gradients."""
    if group is None or group.size == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather_stacked(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """(size, *x.shape): the ranks' ``x`` in index order; the gradient of
    this rank's ``x`` is the sum over the ranks of the gradients of its
    entry."""
    if group is None or group.size == 1:
        return x[None]
    return _AllGather.apply(x, group)


def all_gather(x: torch.Tensor, group: Optional[Group], dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in index order (rank 0's
    first), with :func:`all_gather_stacked`'s gradient."""
    if group is None or group.size == 1:
        return x
    return torch.cat(all_gather_stacked(x, group).unbind(0), dim)


def halo_exchange(x: torch.Tensor, top: int, bottom: int, group: Optional[Group],
                  fill: float = 0.0) -> torch.Tensor:
    """``x`` (B, C, h, W), this rank's rows of a map whose H axis is split
    evenly over ``group`` in index order, with the ``top`` rows above it
    and the ``bottom`` rows below it prepended and appended.  Rows past the
    map's edges are ``fill`` (0 for a convolution's padding, ``-inf`` for a
    max pool's).  A halo may reach past the next rank's rows: each rank
    contributes its last ``min(top, h)`` and first ``min(bottom, h)`` rows
    to one all-gather, and a halo is one slice of the ranks' rows in order
    behind (or before) a fill of its own depth.  The gradient of each halo
    row adds into the row it came from (the all-gather's backward).

    Every rank builds the same graph (the slices differ only in their
    offsets): autograd then runs the backward's collectives in the same
    order on every rank, which they need to meet."""
    if top == 0 and bottom == 0:
        return x
    b, c, h, w = x.shape
    n, m = (1, 0) if group is None else (group.size, group.index)
    nt, nb = min(top, h), min(bottom, h)
    slab = torch.cat([x[:, :, h - nt:], x[:, :, :nb]], 2)
    parts = all_gather_stacked(slab, group).unbind(0)  # rank r: its last nt, first nb rows
    # above: fill for the rows over the map, then every rank's last nt rows;
    # when top > h those are whole shards, so the slice reaches past rank m - 1
    above = torch.cat([x.new_full((b, c, top, w), fill)] + [p[:, :, :nt] for p in parts], 2)
    below = torch.cat([p[:, :, nt:] for p in parts] + [x.new_full((b, c, bottom, w), fill)], 2)
    return torch.cat([above.narrow(2, m * nt, top), x,
                      below.narrow(2, (m + 1) * nb, bottom)], 2)
