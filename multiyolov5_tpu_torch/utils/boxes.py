"""Box math (counterpart of ``multiyolov5_tpu/utils/boxes.py``).

Each function takes a torch tensor (on any device) or a numpy array and
returns the same kind: the eval path runs them on tensors on the card and
on the host-side numpy bookkeeping that mirrors the JAX package's.
``bbox_iou_ciou``, the detection loss's, takes torch tensors only.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _xp(x):
    return np if isinstance(x, np.ndarray) else torch


def xyxy2xywh(x):
    """(..., 4) corner boxes to center-size boxes."""
    return _xp(x).stack([(x[..., 0] + x[..., 2]) / 2, (x[..., 1] + x[..., 3]) / 2,
                         x[..., 2] - x[..., 0], x[..., 3] - x[..., 1]], -1)


def xywh2xyxy(x):
    """(..., 4) center-size boxes to corner boxes."""
    return _xp(x).stack([x[..., 0] - x[..., 2] / 2, x[..., 1] - x[..., 3] / 2,
                         x[..., 0] + x[..., 2] / 2, x[..., 1] + x[..., 3] / 2], -1)


def xywhn2xyxy(x, w=640, h=640, padw=0, padh=0):
    """(..., 4) normalised center-size boxes to pixel corner boxes in a
    ``w`` x ``h`` image placed at (``padw``, ``padh``)."""
    return _xp(x).stack([w * (x[..., 0] - x[..., 2] / 2) + padw,
                         h * (x[..., 1] - x[..., 3] / 2) + padh,
                         w * (x[..., 0] + x[..., 2] / 2) + padw,
                         h * (x[..., 1] + x[..., 3] / 2) + padh], -1)


def clip_coords(boxes, img_shape):
    """Clip xyxy boxes to (h, w); returns a new array."""
    xp = _xp(boxes)
    h, w = img_shape[:2]
    return xp.stack([xp.clip(boxes[..., 0], 0, w), xp.clip(boxes[..., 1], 0, h),
                     xp.clip(boxes[..., 2], 0, w), xp.clip(boxes[..., 3], 0, h)], -1)


def scale_coords(img1_shape, coords, img0_shape, ratio_pad=None):
    """Unmap xyxy coords from the letterboxed frame back to the original
    (reference utils/general.py:319-332); columns past 4 pass through."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    xp = _xp(coords)
    out = xp.stack([coords[..., 0] - pad[0], coords[..., 1] - pad[1],
                    coords[..., 2] - pad[0], coords[..., 3] - pad[1]], -1) / gain
    rest = coords[..., 4:]
    out = clip_coords(out, img0_shape)
    if rest.shape[-1]:
        out = xp.concatenate([out, rest], -1)
    return out


def box_iou(box1, box2):
    """Pairwise IoU of xyxy boxes: (N, 4), (M, 4) -> (N, M)."""
    xp = _xp(box1)
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    lt = xp.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = xp.minimum(box1[:, None, 2:4], box2[None, :, 2:4])
    wh = xp.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter)


def wh_iou(wh1, wh2):
    """Pairwise IoU of (w, h) pairs as boxes sharing a corner: (N, 2), (M,
    2) -> (N, M)."""
    inter = _xp(wh1).minimum(wh1[:, None], wh2[None]).prod(2)
    return inter / (wh1.prod(1)[:, None] + wh2.prod(1)[None] - inter)


def bbox_iou_ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise CIoU of xywh boxes (reference utils/general.py:343-385,
    CIoU branch; multiyolov5_tpu/utils/boxes.py:85-113), on torch tensors.

    The alpha term carries no gradient, like the reference's
    ``torch.no_grad()`` and the JAX package's ``stop_gradient``."""
    b1x1, b1x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
    b1y1, b1y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
    b2x1, b2x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
    b2y1, b2y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2

    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) *
             (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0))
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * torch.square(torch.atan(w2 / h2) - torch.atan(w1 / h1))
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)
