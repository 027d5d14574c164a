"""K3: exact greedy NMS over <= 1024 score-sorted candidates, with the keep
mask packed in the same launch.

Counterpart of ``nms_fixpoint_pallas``
(multiyolov5_tpu/ops/pallas/nms_fixpoint_kernel.py:77).  The kernel is
``csrc/nms.cu``; its design notes are there.  :func:`nms` returns the keep
mask; :func:`nms_packed` the first ``max_det`` kept rows (the serving path's
output, :func:`pack_keep` of the mask).  :func:`plan` picks how many CTAs,
one thread-block cluster, build the suppression mask.

Both versions test IoU > t in the TPU kernel's division-free form
``inter * (1 + t) > t * (area_j + area_i)`` with float32 constants, so their
keep masks are bit-equal to each other and to the TPU kernel's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build

MAX_N = 1024
MAX_CTAS = 16                 # a cluster above 8 CTAs is a non-portable size
# Building CTAs, cut to the pairs of mask words the list has: the fastest at
# the serving list on an H100 (PERF.md, prof_nms_torch.py --sweep: 1, 2,
# 4, 8 and 16 CTAs read 0.091, 0.052, 0.032, 0.022 and 0.017 ms).
CTAS = 16
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _I, ctypes.c_float, ctypes.c_float, _P, _I, _P, _P, _I, _P]


class Plan(NamedTuple):
    """One K3 launch: a cluster of ``ctas`` CTAs of 1024 threads builds the
    mask, CTA 0 sweeps it; ``smem`` bytes of shared memory a CTA."""
    ctas: int
    smem: int


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of one CTA, as csrc/nms.cu smem_bytes counts
    it: 20 bytes of box and area a row and the [32][n + 1] mask words."""
    return 20 * n + 4 * 32 * (n + 1)


def word_pairs(n: int) -> List[Tuple[int, ...]]:
    """The mask's words in the pairs that csrc/nms.cu builds together:
    word w with word nw - 1 - w, the larger first (a word holds the rows
    j < 32 (w + 1) of its 32 columns), one word alone at the middle."""
    nw = -(-n // 32)
    return [(nw - 1 - p,) if nw - 1 - p == p else (nw - 1 - p, p)
            for p in range((nw + 1) // 2)]


@functools.lru_cache(maxsize=64)
def plan(n: int, ctas: Optional[int] = None) -> Plan:
    """The launch for a list of ``n`` rows: ``CTAS`` building CTAs (or
    ``ctas``), at most one a pair of mask words.  Raises ValueError on a
    length or CTA count the kernel does not take."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"nms: {n} candidates, the kernel takes 1..{MAX_N}")
    c = CTAS if ctas is None else ctas
    if not 1 <= c <= MAX_CTAS:
        raise ValueError(f"nms: {c} building CTAs (1..{MAX_CTAS})")
    return Plan(min(c, len(word_pairs(n))), smem_bytes(n))


def suppression(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(N, N) bool S: S[j, i] for j < i where the pair's IoU exceeds t, in
    the kernel's float32 form and order of operations."""
    n = boxes.shape[0]
    t = torch.tensor(np.float32(iou_thres), device=boxes.device)
    one_t = torch.tensor(np.float32(1.0 + iou_thres), device=boxes.device)
    x1, y1, x2, y2 = boxes.unbind(1)
    area = (x2 - x1) * (y2 - y1)
    iw = (torch.minimum(x2[:, None], x2[None]) -
          torch.maximum(x1[:, None], x1[None])).clamp_min(0.0)
    ih = (torch.minimum(y2[:, None], y2[None]) -
          torch.maximum(y1[:, None], y1[None])).clamp_min(0.0)
    over = (iw * ih) * one_t > t * (area[:, None] + area[None])
    return over & torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
              iou_thres: float) -> torch.Tensor:
    """boxes (N, 4) float32 xyxy (class offset applied), scores (N,) sorted
    descending with <= 0 marking invalid rows -> keep (N,) bool.

    Solves keep = valid & ~(S^T keep) by Jacobi rounds, S = :func:`suppression`;
    entries at suppression depth d settle after d + 1 rounds, and the unique
    fixpoint is the sequential greedy result."""
    sup_m = suppression(boxes, iou_thres)
    valid = scores > 0
    keep = valid
    for _ in range(boxes.shape[0]):
        new = valid & ~(sup_m & keep[:, None]).any(0)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def pack_keep(keep: torch.Tensor, max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,) bool keep mask -> (idx (max_det,) int64, valid (max_det,) bool):
    the kept rows in index order (rows are score-ordered), padded with -1
    (multiyolov5_tpu/ops/nms.py:79-90)."""
    n = keep.shape[0]
    key = torch.where(keep, torch.arange(n, 0, -1, device=keep.device), 0)
    vals, idx = torch.topk(key, min(max_det, n))
    valid = vals > 0
    idx = torch.where(valid, idx, -1)
    pad = max_det - idx.shape[0]
    if pad:
        idx = torch.cat([idx, idx.new_full((pad,), -1)])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    return idx, valid


def nms_packed_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                     max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pack_keep` of :func:`nms_plain`."""
    return pack_keep(nms_plain(boxes, scores, iou_thres), max_det)


def launch(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int = 0,
           keep: bool = True, p: Optional[Plan] = None
           ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One K3 call on CUDA tensors with the plan ``p`` or :func:`plan`'s:
    (keep (N,) bool if ``keep``, idx (max_det,) int64 and valid (max_det,)
    bool if ``max_det`` > 0)."""
    n = boxes.shape[0]
    build.require(boxes.device.type == "cuda" and 1 <= n <= MAX_N,
                  f"nms: {n} candidates on {boxes.device}, the kernel takes 1..{MAX_N} "
                  f"on the card")
    build.require(tuple(boxes.shape) == (n, 4) and boxes.dtype == torch.float32
                  and boxes.is_contiguous() and boxes.data_ptr() % 16 == 0,
                  "nms: boxes must be contiguous 16-byte aligned (N, 4) float32")
    build.require(tuple(scores.shape) == (n,) and scores.dtype == torch.float32
                  and scores.is_contiguous() and scores.device == boxes.device,
                  "nms: scores must be contiguous (N,) float32")
    build.require(max_det >= 0, f"nms: max_det {max_det}")
    p = p or plan(n)
    dev = boxes.device
    kp = torch.empty((n,), dtype=torch.uint8, device=dev) if keep else None
    idx = torch.empty((max_det,), dtype=torch.int64, device=dev) if max_det else None
    valid = torch.empty((max_det,), dtype=torch.uint8, device=dev) if max_det else None
    opt = lambda t: build.ptr(t) if t is not None else None   # noqa: E731
    with torch.cuda.device(dev):
        fn = build.function("mk_nms", _ARGTYPES)
        err = fn(build.ptr(boxes), build.ptr(scores), n,
                 float(np.float32(iou_thres)), float(np.float32(1.0 + iou_thres)),
                 opt(kp), max_det, opt(idx), opt(valid), p.ctas, build.stream_of(boxes))
    build.check(err, f"nms {p}")
    nms.launches += 1
    return (kp.view(torch.bool) if keep else None, idx,
            valid.view(torch.bool) if max_det else None)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The keep mask: K3 on CUDA tensors, :func:`nms_plain` on CPU tensors."""
    if not build.on_device(boxes, "nms"):
        return nms_plain(boxes, scores, iou_thres)
    return launch(boxes, scores, iou_thres)[0]


def nms_packed(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx (max_det,) int64, -1 padded; valid (max_det,) bool): K3 with its
    pack on CUDA tensors (one call), :func:`nms_packed_plain` on CPU
    tensors."""
    if not build.on_device(boxes, "nms"):
        return nms_packed_plain(boxes, scores, iou_thres, max_det)
    build.require(max_det >= 1, f"nms_packed: max_det {max_det}")
    _, idx, valid = launch(boxes, scores, iou_thres, max_det, keep=False)
    return idx, valid


nms.launches = 0
