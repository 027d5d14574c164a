"""The ops of a forward whose H axis is split over ranks (parallel/spatial.py).

Inside :func:`sharded`, each rank holds its rows of every activation map
(the rows of the model group's index, rank 0's first), and the blocks call
the ops here for what reads across rows:

* :func:`conv2d`: a conv with vertical reach (3x3 at dilation 1-9, stride
  1 or 2) takes its rows from the other ranks by ``halo_exchange``, then
  convolves without vertical padding: a stride-2 conv on even-aligned
  shards needs 1 row above and none below;
* :func:`max_pool2d` and :func:`max_pool_same`: the same, filled with
  ``-inf``;
* :func:`zero_pad`: top rows on the first rank that holds rows, bottom
  rows on the last;
* :func:`mean_hw`: the global mean as a sum over the group;
* ``resize_bilinear``, ``upsample`` in a mode other than nearest,
  ``adaptive_avg_pool_multi`` (ops/resize.py) and the transformer
  (models/blocks.py) gather the whole map first and keep this rank's rows
  of what they compute (:func:`place`).

Focus, 1x1 convs, nearest upsamples and concats stay local.  Outside
:func:`sharded` every op is the plain one.  Tensors that every rank of the
group holds whole (a pooled map, a global mean) pass through convs under
:func:`whole`, which also tells a global-batch BN (parallel/sync_bn.py) to
count them once, over the data group.

How H splits is a :class:`Plan`: each rank's input rows, in units of the
largest stride (parallel/mesh.py ``split_rows``), so the shards may be
uneven and every pyramid level still gets a whole number of rows a rank.
A map of width ``w`` holds ``rows * w / width`` rows a rank.  A rank whose
share is empty (fewer units than ranks) computes a copy of the last rank
that holds rows and gives nothing to the gathers, the means or the BN
moments.  The few maps off that rule (a zero pad's) carry their row
counts in the running :class:`Shard`.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..parallel.comm import Group, all_gather, all_reduce_sum, halo_exchange


@dataclass(frozen=True)
class Plan:
    """``rows[r]``: rank r's rows of the input map (0 for a rank that holds
    none); ``width``: the input's W."""

    rows: Tuple[int, ...]
    width: int

    def at(self, w: int) -> Optional[Tuple[int, ...]]:
        """Each rank's rows of a map of width ``w`` (None where a rank's
        share is not a whole number of rows)."""
        if any(r * w % self.width for r in self.rows):
            return None
        return tuple(r * w // self.width for r in self.rows)


def src_of(rows, index: int) -> int:
    """The rank whose rows rank ``index`` computes: itself, or the last rank
    that holds rows for one that holds none."""
    return index if rows[index] else max(r for r, n in enumerate(rows) if n)


@dataclass(frozen=True)
class Shard:
    """The running sharded forward: ``model`` the group H is split over,
    ``data`` the group of the other batch rows at this rank's model index;
    ``plan``: how H splits; ``whole``: the tensors at hand are the same on
    every rank of ``model``; ``rows``: the row counts of the maps off the
    plan's rule."""

    model: Group
    data: Group
    plan: Plan
    whole: bool = False
    rows: WeakIdKeyDictionary = field(default_factory=WeakIdKeyDictionary, compare=False)


_ACTIVE: contextvars.ContextVar[Optional[Shard]] = contextvars.ContextVar(
    "multiyolov5_shard", default=None)


def active() -> Optional[Shard]:
    """The running sharded forward, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sharded(model: Group, data: Group, plan: Plan):
    """For the duration, the blocks' ops treat activations as this rank's
    rows of maps split over ``model`` as ``plan`` says."""
    token = _ACTIVE.set(Shard(model, data, plan=plan))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def whole():
    """Inside a sharded forward, for tensors every rank holds whole."""
    s = _ACTIVE.get()
    token = _ACTIVE.set(replace(s, whole=True) if s is not None else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _split() -> Optional[Shard]:
    s = _ACTIVE.get()
    return None if s is None or s.whole or s.model.size == 1 else s


def split() -> bool:
    """True where the tensors at hand are this rank's rows of maps split
    over more than one rank."""
    return _split() is not None


def _rows_at(s: Shard, w: int) -> Tuple[int, ...]:
    """Every rank's rows of a map of width ``w`` on the plan's rule."""
    rows = s.plan.at(w)
    if rows is None:
        raise ValueError(f"shard: a map of width {w} splits into no whole rows "
                         f"under {s.plan}")
    return rows


def _rows(s: Shard, x: torch.Tensor) -> Tuple[int, ...]:
    """Every rank's rows of the map ``x`` (B, C, h, W) is this rank's part of."""
    rows = s.rows.get(x)
    if rows is None:
        rows = _rows_at(s, x.shape[3])
    if rows[src_of(rows, s.model.index)] != x.shape[2]:
        raise ValueError(f"shard: {x.shape[2]} rows where the plan gives {rows}")
    return rows


def _note(s: Shard, y: torch.Tensor, rows: Tuple[int, ...]) -> torch.Tensor:
    """Record ``y``'s row counts where they are off the plan's rule."""
    if rows != s.plan.at(y.shape[3]):
        s.rows[y] = rows
    return y


def holds_rows() -> bool:
    """False on a rank that holds none of a split map's rows (it computes a
    copy of another rank's)."""
    s = _split()
    return s is None or s.plan.rows[s.model.index] > 0


def _windowed(x: torch.Tensor, k: int, st: int, d: int, p: int, fill: float,
              apply: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """A window op along H (kernel ``k``, stride ``st``, dilation ``d``,
    padding ``p``) on this rank's rows: ``apply`` the op without vertical
    padding to the rows with their halo.  Each rank's output rows start at
    its first input row / ``st``; the last rank that holds rows also takes
    the map's last output rows."""
    s = _split()
    rows = _rows(s, x)
    n = len(rows)
    starts = [sum(rows[:r]) for r in range(n)]
    if any(a % st for a, r in zip(starts, rows) if r):
        raise NotImplementedError(f"a stride-{st} window op on shards of {rows} rows")
    keff = d * (k - 1) + 1
    n_out = (sum(rows) + 2 * p - keff) // st + 1
    last = src_of(rows, n - 1)
    outs = tuple(0 if not r else (n_out if i == last else (a + r) // st) - a // st
                 for i, (a, r) in enumerate(zip(starts, rows)))
    # rows below: what a rank's last output row reads past its own rows
    bottom = max(0, keff - st - p,
                 (starts[last] // st + outs[last] - 1) * st - p + keff - sum(rows))
    src = src_of(rows, s.model.index)
    xh = halo_exchange(x, p, bottom, s.model, fill, rows, src)
    return _note(s, apply(xh).narrow(2, 0, outs[src]), outs)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; sharded, on the rows with the halo its taps reach."""
    s = _split()
    if s is None:
        return conv(x)
    return _windowed(x, conv.kernel_size[0], conv.stride[0], conv.dilation[0],
                     conv.padding[0], 0.0,
                     lambda xh: F.conv2d(xh, conv.weight, conv.bias, conv.stride,
                                         (0, conv.padding[1]), conv.dilation, conv.groups))


def max_pool2d(x: torch.Tensor, k: int, st: int, p: int = 0) -> torch.Tensor:
    """``F.max_pool2d(x, k, st, p)``; sharded, on the rows with a halo of
    ``-inf`` (none where the windows stay inside the shards)."""
    if _split() is None:
        return F.max_pool2d(x, k, st, p)
    return _windowed(x, k, st, 1, p, float("-inf"),
                     lambda xh: F.max_pool2d(xh, k, st, (0, p)))


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 same-padding max pool (SPP, reference models/common.py:170)."""
    return max_pool2d(x, k, 1, k // 2)


def zero_pad(x: torch.Tensor, pad) -> torch.Tensor:
    """``F.pad(x, pad)`` for torch's (left, right, top, bottom); sharded,
    the top rows go on the first rank that holds rows and the bottom rows
    on the last, which then hold more rows than the plan's rule says."""
    s = _split()
    if s is None:
        return F.pad(x, pad)
    rows = list(_rows(s, x))
    first, last = min(r for r, n in enumerate(rows) if n), src_of(rows, len(rows) - 1)
    src = src_of(rows, s.model.index)
    left, right, top, bottom = pad
    y = F.pad(x, (left, right, top if src == first else 0, bottom if src == last else 0))
    rows[first] += top
    rows[last] += bottom
    return _note(s, y, tuple(rows))


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """``x.mean((2, 3), keepdim=True)`` over the whole map."""
    s = _split()
    if s is None:
        return x.mean((2, 3), keepdim=True)
    rows = _rows(s, x)
    part = x.float().sum((2, 3), keepdim=True) * (1.0 if rows[s.model.index] else 0.0)
    tot = all_reduce_sum(part, s.model)
    return (tot / (sum(rows) * x.shape[3])).to(x.dtype)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole map of a sharded ``x`` (every rank's rows, H axis 2)."""
    s = _split()
    return x if s is None else all_gather(x, s.model, 2, _rows(s, x))


def place(h: int, w: int) -> Tuple[int, int, int]:
    """(the whole map's rows, this rank's first row, its row count) of a
    map of width ``w`` of which this rank holds ``h`` rows (``(h, 0, h)``
    unsharded): what to keep of a whole map computed on every rank."""
    s = _split()
    if s is None:
        return h, 0, h
    rows = _rows_at(s, w)
    if rows[src_of(rows, s.model.index)] != h:
        raise ValueError(f"shard: {h} rows where the plan gives {rows}")
    src = src_of(rows, s.model.index)
    return sum(rows), sum(rows[:src]), rows[src]


def take_rows(x: torch.Tensor, plan: Plan, group: Group, dim: int = 2) -> torch.Tensor:
    """This rank's input rows of a map split by ``plan``, given each rank's
    own (``x``, on axis ``dim``): itself, or on a rank that holds none a
    copy of the rows it computes, from a gather."""
    if group.size == 1 or all(plan.rows):
        return x
    full = all_gather(x, group, dim, plan.rows)
    src = src_of(plan.rows, group.index)
    return full.narrow(dim, sum(plan.rows[:src]), plan.rows[src])
