"""K5: sequential greedy NMS truncated at ``max_det``, for candidate lists
longer than K3 takes (the eval path's up to 30000 per image).

Counterpart of ``nms_pallas`` (multiyolov5_tpu/ops/pallas/nms_kernel.py:87).
The kernel is ``csrc/nms_greedy.cu``; its design notes are there.

Both versions test IoU > t in the TPU kernel's division form
``inter / (area_i + area_p - inter + 1e-9) > t`` with float32 constants,
every operation rounded once, so their picks are equal to each other and to
the TPU kernel's.  Rows must be sorted by descending score (``top_k`` in
ops/nms.py): both versions take the first active row as the next pick.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import build

MAX_N = 220 * 1024 * 8        # rows whose active bitmask fits the kernel's shared memory
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]


def nms_greedy_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                     max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (B, N, 4) float32 xyxy (class offset applied), scores (B, N)
    float32, each row sorted descending with <= 0 marking invalid rows ->
    (idx (B, max_det) int32, -1 past the last pick; valid (B, max_det) bool).

    At most ``max_det`` pick/suppress steps per image; the first active row
    is the pick."""
    bsz, n = scores.shape
    dev = boxes.device
    t = torch.tensor(np.float32(iou_thres), device=dev)
    eps = torch.tensor(np.float32(1e-9), device=dev)
    idx = torch.full((bsz, max_det), -1, dtype=torch.int32, device=dev)
    valid = torch.zeros((bsz, max_det), dtype=torch.bool, device=dev)
    for b in range(bsz):
        x1, y1, x2, y2 = boxes[b].unbind(1)
        area = (x2 - x1) * (y2 - y1)
        active = scores[b] > 0
        p = 0
        for k in range(max_det if n else 0):
            # rows before the previous pick are inactive
            p += int(active[p:].view(torch.uint8).argmax())
            if not bool(active[p]):
                break
            idx[b, k], valid[b, k] = p, True
            s = slice(p, n)
            iw = (torch.minimum(x2[s], x2[p]) - torch.maximum(x1[s], x1[p])).clamp_min(0.0)
            ih = (torch.minimum(y2[s], y2[p]) - torch.maximum(y1[s], y1[p])).clamp_min(0.0)
            inter = iw * ih
            iou = inter / (area[s] + area[p] - inter + eps)
            active[s] &= ~(iou > t)
            active[p] = False
    return idx, valid


def nms_greedy(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on CUDA tensors (one launch for the batch), :func:`nms_greedy_plain`
    on CPU tensors."""
    if not build.on_device(boxes, "nms_greedy"):
        return nms_greedy_plain(boxes, scores, iou_thres, max_det)
    build.require(boxes.dim() == 3 and boxes.shape[2] == 4 and boxes.dtype == torch.float32
                  and boxes.is_contiguous() and boxes.data_ptr() % 16 == 0,
                  "nms_greedy: boxes must be contiguous 16-byte aligned (B, N, 4) float32")
    bsz, n, _ = boxes.shape
    build.require(tuple(scores.shape) == (bsz, n) and scores.dtype == torch.float32
                  and scores.is_contiguous() and scores.device == boxes.device,
                  "nms_greedy: scores must be contiguous (B, N) float32")
    build.require(bsz >= 1 and 1 <= n <= MAX_N and max_det >= 1,
                  f"nms_greedy: batch {bsz}, {n} candidates (kernel takes 1..{MAX_N}), "
                  f"max_det {max_det}")
    idx = torch.empty((bsz, max_det), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((bsz, max_det), dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        fn = build.function("mk_nms_greedy", _ARGTYPES)
        err = fn(build.ptr(boxes), build.ptr(scores), bsz, n,
                 float(np.float32(iou_thres)), max_det, build.ptr(idx),
                 build.ptr(valid), build.stream_of(boxes))
    build.check(err, "nms_greedy")
    nms_greedy.launches += 1
    return idx, valid.bool()


nms_greedy.launches = 0
