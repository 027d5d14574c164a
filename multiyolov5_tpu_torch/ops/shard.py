"""The ops of a forward whose H axis is split over ranks (parallel/spatial.py).

Inside :func:`sharded`, each rank holds its rows of every activation map
(the rows of the model group's index, rank 0's first), and the blocks call
the ops here for what reads across rows:

* :func:`conv2d`: a conv with vertical reach (3x3 at dilation 1-9, stride
  1 or 2) takes its rows from the neighbours by ``halo_exchange``, then
  convolves without vertical padding: a stride-2 conv on even-aligned
  shards needs 1 row above and none below;
* :func:`max_pool_same`: the same, filled with ``-inf``;
* :func:`mean_hw`: the global mean as a sum over the group;
* ``resize_bilinear`` and ``adaptive_avg_pool_multi`` (ops/resize.py)
  gather the whole map first.

Focus, 1x1 convs, nearest upsamples and concats stay local.  Outside
:func:`sharded` every op is the plain one.  Tensors that every rank of the
group holds whole (a pooled map, a global mean) pass through convs under
:func:`whole`, which also tells a global-batch BN (parallel/sync_bn.py) to
count them once, over the data group.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.comm import Group, all_gather, all_reduce_sum, halo_exchange


@dataclass(frozen=True)
class Shard:
    """The running sharded forward: ``model`` the group H is split over,
    ``data`` the group of the other batch rows at this rank's model index;
    ``whole``: the tensors at hand are the same on every rank of ``model``."""

    model: Group
    data: Group
    whole: bool = False


_ACTIVE: contextvars.ContextVar[Optional[Shard]] = contextvars.ContextVar(
    "multiyolov5_shard", default=None)


def active() -> Optional[Shard]:
    """The running sharded forward, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sharded(model: Group, data: Group):
    """For the duration, the blocks' ops treat activations as this rank's
    rows of maps split over ``model``."""
    token = _ACTIVE.set(Shard(model, data))
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


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; sharded, the halo rows its taps reach first.  The
    output's local rows start at this shard's first input row / stride
    (shards of a multiple of the stride), so they need ``padding`` rows
    above and ``dilation * (k - 1) + 1 - stride - padding`` below."""
    s = _split()
    k, st, d, p = conv.kernel_size[0], conv.stride[0], conv.dilation[0], conv.padding[0]
    bottom = d * (k - 1) + 1 - st - p
    if s is None or (p == 0 and bottom == 0):
        return conv(x)
    xh = halo_exchange(x, p, bottom, s.model)
    return F.conv2d(xh, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
                    conv.dilation, conv.groups)


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 same-padding max pool (SPP, reference models/common.py:170)."""
    s = _split()
    if s is None:
        return F.max_pool2d(x, k, 1, k // 2)
    xh = halo_exchange(x, k // 2, k // 2, s.model, fill=float("-inf"))
    return F.max_pool2d(xh, k, 1, (0, k // 2))


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """``x.mean((2, 3), keepdim=True)`` over the whole map."""
    s = _split()
    if s is None:
        return x.mean((2, 3), keepdim=True)
    tot = all_reduce_sum(x.float().sum((2, 3), keepdim=True), s.model)
    return (tot / (x.shape[2] * x.shape[3] * s.model.size)).to(x.dtype)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole map of a sharded ``x`` (every rank's rows, H axis 2)."""
    s = _split()
    return x if s is None else all_gather(x, s.model, 2)


def own_rows(x: torch.Tensor, h: int) -> torch.Tensor:
    """This rank's ``h`` rows of a whole map (``x`` itself unsharded)."""
    s = _split()
    return x if s is None else x[:, :, s.model.index * h:(s.model.index + 1) * h]


def rows_total(h: int) -> int:
    """The whole map's rows for a local ``h``."""
    s = _split()
    return h if s is None else h * s.model.size
