"""Resize and pooling (counterpart of ``multiyolov5_tpu/ops/resize.py``).

The JAX package re-derives torch's semantics as dense matmuls; here the
same functions are torch's own ops on NCHW tensors.  Inside a sharded
forward (ops/shard.py) the bilinear resize, the upsamples other than
nearest and the adaptive pools read the whole map, gathered from the
ranks, and the max pool takes a halo.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import shard


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    whole: bool = False) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=True)``, the seg heads'
    resize (reference models/yolo.py:149-186).  In a sharded forward,
    ``out_hw`` is the local size: the resize reads the whole map (gathered,
    or ``x`` itself where every rank holds it ``whole``) and returns this
    rank's rows."""
    if tuple(x.shape[-2:]) == tuple(out_hw) and not whole:
        return x
    full = x if whole else shard.gather_rows(x)
    total, start, rows = shard.place(int(out_hw[0]), int(out_hw[1]))
    out = F.interpolate(full, size=(total, int(out_hw[1])), mode="bilinear",
                        align_corners=True)
    return out.narrow(2, start, rows)


# the modes torch's nn.Upsample takes on a 4-D map
UPSAMPLE_MODES = ("nearest", "bilinear", "bicubic", "area", "nearest-exact")


def upsample(x: torch.Tensor, scale: int, mode: str) -> torch.Tensor:
    """``nn.Upsample(None, scale, mode)`` (torch's default ``align_corners``).
    A nearest upsample reads only its own rows; in a sharded forward any
    other mode reads the whole map (gathered) and returns this rank's rows."""
    if mode == "nearest":
        return F.interpolate(x, scale_factor=scale, mode=mode)
    full = shard.gather_rows(x)
    _, start, rows = shard.place(x.shape[2] * scale, x.shape[3] * scale)
    return F.interpolate(full, scale_factor=scale, mode=mode).narrow(2, start, rows)


def adaptive_avg_pool_multi(x: torch.Tensor, ks: Sequence[int]) -> List[torch.Tensor]:
    """``[nn.AdaptiveAvgPool2d(k)(x) for k in ks]``.

    Pools a contiguous NCHW copy: on an H100 (700 W) torch's channels_last
    kernel took 0.40-0.84 ms per pool for k = 2, 3, 6 at (1, 128, 64, 128),
    the contiguous one 0.01-0.04 ms.  In a sharded forward the pools are
    of the whole map, the same on every rank."""
    x = shard.gather_rows(x).contiguous()
    return [F.adaptive_avg_pool2d(x, k) for k in ks]


max_pool_same = shard.max_pool_same
