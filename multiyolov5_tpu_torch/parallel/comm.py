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

import functools
from typing import Optional, Sequence, Tuple

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


def all_gather(x: torch.Tensor, group: Optional[Group], dim: int = 0,
               rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in index order (rank 0's
    first), with :func:`all_gather_stacked`'s gradient.  ``rows``: how many
    entries along ``dim`` each rank gives (None: all of its ``x``, the same
    size on every rank); each rank's ``x`` holds at least its count and at
    most the largest.  gloo gathers equal sizes, so each ``x`` is padded to
    the largest count and every part trimmed to its own."""
    if group is None or group.size == 1:
        return x if rows is None else x.narrow(dim, 0, rows[0])
    if rows is None:
        return torch.cat(all_gather_stacked(x, group).unbind(0), dim)
    top = max(rows)
    pad = list(x.shape)
    pad[dim] = top - x.shape[dim]
    parts = all_gather_stacked(torch.cat([x, x.new_zeros(pad)], dim), group).unbind(0)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, rows)], dim)


def halo_exchange(x: torch.Tensor, top: int, bottom: int, group: Optional[Group],
                  fill: float = 0.0, rows: Optional[Sequence[int]] = None,
                  src: Optional[int] = None) -> torch.Tensor:
    """``x`` (B, C, h, W), this rank's rows of a map whose H axis is split
    over ``group`` in index order, with the ``top`` rows above it and the
    ``bottom`` rows below it prepended and appended.  Rows past the map's
    edges are ``fill`` (0 for a convolution's padding, ``-inf`` for a max
    pool's).

    ``rows``: each rank's row count (None: ``h`` on every rank); a rank of
    count 0 holds none of the map.  ``src``: the rank whose rows ``x`` is
    (this rank, unless it holds none and computes a copy of another's).
    Each rank gives its last ``top`` and first ``bottom`` rows, padded with
    ``fill`` where it has fewer, to one all-gather; a halo is a selection
    of those rows in map order, so it may reach past the next rank.  The
    gradient of each halo row adds into the row it came from (the
    all-gather's backward).

    Every rank builds the same graph (the selections differ only in their
    indices): autograd then runs the backward's collectives in the same
    order on every rank, which they need to meet."""
    if top == 0 and bottom == 0:
        return x
    b, c, h, w = x.shape
    n, m = (1, 0) if group is None else (group.size, group.index)
    rows = [h] * n if rows is None else list(rows)
    src = m if src is None else src
    if rows[src] != h:
        raise ValueError(f"halo_exchange: x has {h} rows, its shard {rows[src]}")
    t = top + bottom
    nt, nb = min(top, h), min(bottom, h)
    slab = torch.cat([x.new_full((b, c, top - nt, w), fill), x[:, :, h - nt:],   # last top rows
                      x[:, :, :nb], x.new_full((b, c, bottom - nb, w), fill)], 2)  # first bottom
    parts = all_gather_stacked(slab, group)                         # (n, B, C, t, W)
    # flat row 0 is the fill; rank r's slab row i is flat row 1 + r * t + i
    flat = torch.cat([x.new_full((b, c, 1, w), fill),
                      parts.permute(1, 2, 0, 3, 4).reshape(b, c, n * t, w)], 2)
    halo = flat.index_select(2, _halo_index(tuple(rows), top, bottom, src, x.device))
    return torch.cat([halo[:, :, :top], x, halo[:, :, top:]], 2)


@functools.lru_cache(maxsize=1024)
def _halo_index(rows: Tuple[int, ...], top: int, bottom: int, src: int,
                device: torch.device) -> torch.Tensor:
    """:func:`halo_exchange`'s rows of the gathered slabs for rank ``src``'s
    halo, on ``device``: built once a plan, so a forward copies no index to
    the card."""
    n, t = len(rows), top + bottom
    starts = [sum(rows[:r]) for r in range(n)]

    def at(g: int) -> int:
        for r in range(n):
            j = g - starts[r]
            if rows[r] and 0 <= j < rows[r]:
                return 1 + r * t + (j - rows[r] + top if j >= rows[r] - top else top + j)
        return 0                                                    # past the map's edges

    a, h = starts[src], rows[src]
    idx = [at(g) for g in range(a - top, a)] + [at(g) for g in range(a + h, a + h + bottom)]
    return torch.tensor(idx, device=device)
