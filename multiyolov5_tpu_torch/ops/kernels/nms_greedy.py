"""K5: sequential greedy NMS truncated at ``max_det``, for candidate lists
longer than K3 takes (the eval path's up to 30000 per image).

Counterpart of ``nms_pallas`` (multiyolov5_tpu/ops/pallas/nms_kernel.py:87).
The kernel is ``csrc/nms_greedy.cu``; its design notes are there.  It cuts
each image's list into slices over the CTAs of a thread-block cluster:
:func:`plan` picks the cluster size, the rows a CTA and whether the
boxes fit in shared memory, on the host, from
:func:`smem_bytes` (the kernel's shared-memory layout in Python).

Both versions test IoU > t in the TPU kernel's division form
``inter / (area_i + area_p - inter + 1e-9) > t`` with float32 constants,
every operation rounded once, so their picks are equal to each other and to
the TPU kernel's.  Rows must be sorted by descending score (``top_k`` in
ops/nms.py): both versions take the first active row as the next pick.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build

MAX_N = 220 * 1024 * 8        # rows a list may have (the first form's one-CTA bitmask)
MAX_CLUSTER = 16              # CTAs a cluster (above 8 a non-portable size)
SMEM_LIMIT = 227 * 1024 - 2048     # dynamic shared memory a CTA may take
# (longest list, cluster size): a list takes the first entry whose length it
# does not pass.  The fastest cluster size at each list shape of the paths,
# from prof_nms_torch.py --sweep on an H100 (PERF.md §6): one CTA at 1024
# rows, 16 at 30000 (also at bs8, where the clusters run in waves).
PLANS = ((2048, 1), (MAX_N, MAX_CLUSTER))
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


class Plan(NamedTuple):
    """One K5 launch: ``cluster`` CTAs an image (of 512 threads each), CTA
    r over rows [r rows, (r + 1) rows) of the list, ``smem`` bytes of
    dynamic shared memory, the boxes in it if ``resident``."""
    cluster: int
    rows: int
    smem: int
    resident: bool


def smem_bytes(rows: int, resident: bool) -> int:
    """Dynamic shared memory of one CTA, as csrc/nms_greedy.cu smem_bytes
    counts it: 16 bytes of box and 4 of area a row when resident, and the
    active bitmask, a bit a row."""
    return (20 * rows if resident else 0) + rows // 8


def plan(batch: int, n: int, cluster: Optional[int] = None,
         resident: Optional[bool] = None) -> Plan:
    """The launch for ``batch`` lists of ``n`` rows: the cluster size of the
    first of ``PLANS`` that takes n rows (or ``cluster``), the rows a CTA
    rounded up to a word of 32, the cluster cut so that no slice is empty,
    and the boxes in shared memory where they fit (or as ``resident``
    says).  Raises ValueError on a shape or plan the kernel does not take."""
    if batch < 1 or not 1 <= n <= MAX_N:
        raise ValueError(f"nms_greedy: batch {batch}, {n} candidates (kernel takes 1..{MAX_N})")
    c = next(e[1] for e in PLANS if n <= e[0])
    c = c if cluster is None else cluster
    if not 1 <= c <= MAX_CLUSTER:
        raise ValueError(f"nms_greedy: cluster {c} (1..{MAX_CLUSTER})")
    rows = (-(-n // c) + 31) // 32 * 32
    c = -(-n // rows)
    fits = smem_bytes(rows, True) <= SMEM_LIMIT
    res = fits if resident is None else resident
    if res and not fits:
        raise ValueError(f"nms_greedy: {rows} rows a CTA do not fit in shared memory")
    return Plan(c, rows, smem_bytes(rows, res), res)


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


def launch(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int,
           p: Optional[Plan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K5 launch for the batch on CUDA tensors, with the plan ``p`` or
    :func:`plan`'s."""
    build.require(boxes.dim() == 3 and boxes.shape[2] == 4 and boxes.dtype == torch.float32
                  and boxes.is_contiguous() and boxes.data_ptr() % 16 == 0
                  and boxes.device.type == "cuda",
                  "nms_greedy: boxes must be contiguous 16-byte aligned (B, N, 4) float32 "
                  "on the card")
    bsz, n, _ = boxes.shape
    build.require(tuple(scores.shape) == (bsz, n) and scores.dtype == torch.float32
                  and scores.is_contiguous() and scores.device == boxes.device,
                  "nms_greedy: scores must be contiguous (B, N) float32")
    build.require(bsz >= 1 and 1 <= n <= MAX_N and max_det >= 1,
                  f"nms_greedy: batch {bsz}, {n} candidates (kernel takes 1..{MAX_N}), "
                  f"max_det {max_det}")
    p = p or plan(bsz, n)
    idx = torch.empty((bsz, max_det), dtype=torch.int32, device=boxes.device)
    valid = torch.empty((bsz, max_det), dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        fn = build.function("mk_nms_greedy", _ARGTYPES)
        err = fn(build.ptr(boxes), build.ptr(scores), bsz, n,
                 float(np.float32(iou_thres)), max_det, build.ptr(idx),
                 build.ptr(valid), p.cluster, p.rows, p.smem, int(p.resident),
                 build.stream_of(boxes))
    build.check(err, f"nms_greedy {p}")
    nms_greedy.launches += 1
    return idx, valid.bool()


def nms_greedy(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on CUDA tensors (one launch for the batch, planned by
    :func:`plan`), :func:`nms_greedy_plain` on CPU tensors."""
    if not build.on_device(boxes, "nms_greedy"):
        return nms_greedy_plain(boxes, scores, iou_thres, max_det)
    return launch(boxes, scores, iou_thres, max_det)


nms_greedy.launches = 0
