"""Letterbox resize/pad (counterpart of ``multiyolov5_tpu/data/letterbox.py``;
reference utils/datasets.py:818-848).

The same geometry as the JAX package: the ``r`` and ``new_unpad``
rounding, the 0.1-biased pad split, the 114 fill, ``auto``, ``scale_fill``,
``scaleup`` and ``stride``.  The resize is cv2's ``INTER_LINEAR`` on uint8,
reproduced bit for bit in integer torch ops on the tensor's device: 11-bit
fixed-point weights, an exact horizontal pass, and the rounding of cv2's
vectorised vertical pass (see ``_resize``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch


def _taps(src: int, dst: int, clamp: bool):
    """cv2's INTER_LINEAR taps along one axis (imgproc/src/resize.cpp,
    ``resizeGeneric``): the source index pair and the 11-bit weights
    (a0, a1) of each destination index, as numpy int64.

    The coordinate is ``float32((d + 0.5) / (dst / src) - 0.5)``; the weights
    are ``rint((1 - f) * 2048)`` and ``rint(f * 2048)`` in float32, so they
    need not sum to 2048.  Along x (``clamp``) a coordinate left of 0 or at
    ``src - 1`` and past is pinned there with weight (2048, 0); along y only
    the row indices are clipped and the weights stay as computed, so the
    first and last rows of an up-scale blend a row with itself."""
    d = np.arange(dst, dtype=np.float64)
    f = ((d + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        pin = (s < 0) | (s >= src - 1)
        s = np.where(s < 0, 0, np.where(s >= src - 1, src - 1, s))
        f[pin] = 0
    a1 = np.rint(f * np.float32(2048)).astype(np.int64)
    a0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), a0, a1


def _resize(img: torch.Tensor, wh: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) uint8, equal to cv2 ``INTER_LINEAR``.

    The horizontal pass is exact in int32: ``S = p0 * a0 + p1 * a1``.  The
    vertical pass rounds as cv2's SIMD path does (``VResizeLinearVec_32s8u``):
    ``(((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2``."""
    h0, w0 = img.shape[:2]
    dev = img.device

    def taps(src, dst, clamp):
        return [torch.from_numpy(t).to(dev) for t in _taps(src, dst, clamp)]

    x0, x1, a0, a1 = taps(w0, wh[0], True)
    y0, y1, b0, b1 = taps(h0, wh[1], False)
    x = img.to(torch.int32)
    s = x[:, x0] * a0[:, None].int() + x[:, x1] * a1[:, None].int()
    v = (((s[y0] >> 4) * b0[:, None, None].int()) >> 16) \
        + (((s[y1] >> 4) * b1[:, None, None].int()) >> 16)
    return ((v + 2) >> 2).clamp_(0, 255).to(torch.uint8)


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
