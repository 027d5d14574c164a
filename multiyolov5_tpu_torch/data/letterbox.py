"""Letterbox resize/pad (counterpart of ``multiyolov5_tpu/data/letterbox.py``;
reference utils/datasets.py:818-848).

The same geometry as the JAX package: the ``r`` and ``new_unpad``
rounding, the 0.1-biased pad split, the 114 fill, ``auto``, ``scale_fill``,
``scaleup`` and ``stride``.  The resize runs on the tensor's device as
``F.interpolate(bilinear, align_corners=False)`` in float32, rounded as
floor(x + 0.5): that equals cv2's ``INTER_LINEAR`` exactly at integer
down-scales such as the serving path's 2:1, and within one grey level
elsewhere (cv2 uses 11-bit fixed-point weights).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def _resize(img: torch.Tensor, wh: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) uint8, bilinear like cv2 INTER_LINEAR."""
    x = img.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(wh[1], wh[0]), mode="bilinear", align_corners=False)
    return torch.floor(y + 0.5).clamp_(0, 255).to(torch.uint8)[0].permute(1, 2, 0)


def letterbox(img: Union[np.ndarray, torch.Tensor], new_shape=(640, 640),
              color=(114, 114, 114), auto: bool = True, scale_fill: bool = False,
              scaleup: bool = True, stride: int = 32,
              device: Optional[Union[str, torch.device]] = None):
    """img: (H, W, C) or (H, W) uint8, numpy or torch; a numpy image goes to
    ``device`` (the CPU by default) first.  Returns (padded uint8 tensor on
    the image's device, (rw, rh), (dw, dh))."""
    x = torch.as_tensor(img)
    if device is not None:
        x = x.to(device)
    shape = tuple(x.shape[:2])  # h, w
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # (w, h)
    dw = new_shape[1] - new_unpad[0]
    dh = new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])

    dw /= 2
    dh /= 2

    gray = x.dim() == 2
    if gray:
        x = x[..., None]
    if shape[::-1] != new_unpad:
        x = _resize(x, new_unpad)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    ch = x.shape[2]
    fill = torch.as_tensor(np.asarray(color), dtype=x.dtype).reshape(-1)[:ch]
    out = fill.to(x.device).expand(x.shape[0] + top + bottom,
                                   x.shape[1] + left + right, ch).clone()
    out[top:top + x.shape[0], left:left + x.shape[1]] = x
    return (out[..., 0] if gray else out), ratio, (dw, dh)


def check_img_size(img_size: int, stride: int = 32) -> int:
    """Round up to a stride multiple (reference utils/general.py check_img_size)."""
    return int(math.ceil(img_size / stride) * stride)
