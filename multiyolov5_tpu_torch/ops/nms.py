"""NMS (counterpart of ``multiyolov5_tpu/ops/nms.py``).

Semantics of the reference (utils/general.py:421-509): conf = obj * cls;
single-label keeps obj > conf_thres and conf > conf_thres for the best
class, multi-label keeps every (box, class) pair with conf > conf_thres;
the top ``max_nms`` candidates by conf; per-class NMS through the class
offset ``MAX_WH``; the first ``max_det`` kept candidates in score order.

Both ``nms_planar`` (serving) and ``nms_batched`` (eval) run the greedy
NMS through :func:`nms_fixed`, which routes on the static shape of the
candidate lists: one list of at most 1024 rows to K3 (ops/kernels/nms.py,
one launch that also packs the kept rows), anything else to one K5 launch
for the batch (ops/kernels/nms_greedy.py, a thread-block cluster an
image).  On an H100 80GB HBM3 at 700 W (chip_smoke.py [6],
prof_nms_torch.py): one 1024-row list took 0.018 ms on K3 with its pack
and 0.26 ms on K5; the eval path's four 30000-row lists 0.488 ms in one
K5 launch.  Shapes are static ((B, max_det, 6) plus a validity mask), and
neither route waits for the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.boxes import xywh2xyxy
from .kernels import nms_greedy, nms_packed
from .kernels.nms import MAX_N as K3_MAX_N

MAX_WH = 4096.0   # class-offset magnitude (reference utils/general.py:434)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` values along the last dim, ties resolved lower index
    first like ``lax.top_k`` (``torch.topk`` does not promise an order among
    ties)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
              max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over (B, K, 4) class-offset xyxy boxes and (B, K) scores,
    each row sorted descending with <= 0 marking invalid rows
    (multiyolov5_tpu/ops/nms.py:93-151).

    B = 1 and K <= 1024: one K3 call, which packs its keep mask itself;
    otherwise one K5 launch.  Returns (idx (B, max_det) int64, -1 padded; valid (B, max_det)
    bool), indices into each image's rows."""
    bsz, k = scores.shape
    if bsz == 1 and k <= K3_MAX_N:
        idx, valid = nms_packed(boxes[0], scores[0], iou_thres, max_det)
        return idx[None], valid[None]
    idx, valid = nms_greedy(boxes, scores, iou_thres, max_det)
    return idx.long(), valid


def _gather_dets(cand: torch.Tensor, scores: torch.Tensor, ci: torch.Tensor,
                 idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, max_det, 6) [x1, y1, x2, y2, conf, cls] of the kept rows; zero
    where invalid."""
    safe = idx.clamp(0, scores.shape[1] - 1)
    out = torch.cat([cand.gather(1, safe[..., None].expand(-1, -1, 4)),
                     scores.gather(1, safe)[..., None], ci.gather(1, safe)[..., None]], -1)
    return torch.where(valid[..., None], out, 0.0)


def nms_planar(z: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
               agnostic: bool = False, class_mask: Optional[torch.Tensor] = None,
               max_nms: int = 1024,
               max_det: int = 300) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-label serving NMS (counterpart of ``nms_planar``); the same
    selection as ``nms_batched(multi_label=False)``.

    z: (B, no, N) planar decoded candidates (models/heads.Detect).
    class_mask: optional (nc,) float mask (1 keep / 0 drop).  Returns
    det (B, max_det, 6) [x1, y1, x2, y2, conf, cls] and valid (B, max_det)
    bool; invalid rows are zero."""
    k = min(max_nms, z.shape[2])
    p = z.float()
    obj = p[:, 4]
    cls_conf = p[:, 5:] * obj[:, None]
    conf = cls_conf.amax(1)
    ci_all = cls_conf.argmax(1)
    keep = (obj > conf_thres) & (conf > conf_thres)
    if class_mask is not None:
        # argmax over all classes first, then drop disallowed winners
        # (multiyolov5_tpu/ops/nms.py:262-265)
        keep = keep & (class_mask[ci_all] > 0)
    scores, bi = top_k(torch.where(keep, conf, 0.0), k)
    ci = ci_all.gather(1, bi).float()
    cand = xywh2xyxy(p[:, :4].gather(2, bi[:, None].expand(-1, 4, -1)).transpose(1, 2))
    boxes = cand if agnostic else cand + (ci * MAX_WH)[..., None]
    idx, valid = nms_fixed(boxes.contiguous(), scores.contiguous(), iou_thres, max_det)
    return _gather_dets(cand, scores, ci, idx, valid), valid


def nms_batched(pred: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                multi_label: bool = False, agnostic: bool = False,
                class_mask: Optional[torch.Tensor] = None, max_nms: int = 4096,
                max_det: int = 300) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS over decoded predictions (multiyolov5_tpu/ops/nms.py:154-220).

    Args:
      pred: (B, N, 5+nc) decoded boxes [xywh, obj, cls...] in pixels (a
        transposed view of the Detect head's planar output will do).
      class_mask: optional (nc,) float mask (1 keep / 0 drop), the
        ``--classes`` filter.
    Returns:
      det (B, max_det, 6) [xyxy, conf, cls]; valid (B, max_det) bool.
    """
    bsz, n, no = pred.shape
    nc = no - 5
    multi_label = multi_label and nc > 1
    p = pred.float()
    obj = p[..., 4]
    cls_conf = p[..., 5:] * obj[..., None]                # (B, N, nc)
    if multi_label:
        # per-(box, class) rows: masking before the threshold is equivalent
        # to the reference's post-hoc class filter
        if class_mask is not None:
            cls_conf = cls_conf * class_mask
        flat = torch.where(cls_conf > conf_thres, cls_conf, 0.0).reshape(bsz, -1)
        k = min(max_nms, flat.shape[1])
        scores, flat_idx = top_k(flat, k)
        bi = flat_idx // nc
        ci = (flat_idx % nc).float()
    else:
        # argmax over ALL classes first, then drop boxes whose best class
        # is not allowed (reference utils/general.py:467-473)
        conf = cls_conf.amax(-1)
        ci_all = cls_conf.argmax(-1)
        keep = (obj > conf_thres) & (conf > conf_thres)
        if class_mask is not None:
            keep = keep & (class_mask[ci_all] > 0)
        k = min(max_nms, n)
        scores, bi = top_k(torch.where(keep, conf, 0.0), k)
        ci = ci_all.gather(1, bi).float()
    # xywh -> xyxy only on the gathered top-k rows
    cand = xywh2xyxy(p[..., :4].gather(1, bi[..., None].expand(-1, -1, 4)))
    boxes = cand if agnostic else cand + (ci * MAX_WH)[..., None]
    idx, valid = nms_fixed(boxes.contiguous(), scores.contiguous(), iou_thres, max_det)
    return _gather_dets(cand, scores, ci, idx, valid), valid


def non_max_suppression(pred: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45,
                        classes: Optional[Sequence[int]] = None,
                        agnostic: bool = False, multi_label: bool = False,
                        labels=(), max_nms: int = 4096,
                        max_det: int = 300) -> List[np.ndarray]:
    """The reference's public API (utils/general.py:421): per image an
    (n, 6) numpy array [xyxy, conf, cls].

    pred: (B, N, 5+nc) decoded candidates on any device.  ``labels``
    (autolabelling, test.py --save-hybrid) are injected as conf-1.0
    candidates like reference :448-455."""
    pred = torch.as_tensor(pred)
    nc = pred.shape[2] - 5
    if labels:
        rows = []
        for xi in range(pred.shape[0]):
            lab = np.asarray(labels[xi]) if len(labels) > xi else np.zeros((0, 5))
            v = np.zeros((len(lab), nc + 5), np.float32)
            if len(lab):
                v[:, :4] = lab[:, 1:5]
                v[:, 4] = 1.0
                v[np.arange(len(lab)), lab[:, 0].astype(int) + 5] = 1.0
            rows.append(v)
        m = max(len(r) for r in rows)
        if m:
            padded = np.zeros((pred.shape[0], m, nc + 5), np.float32)
            for xi, r in enumerate(rows):
                padded[xi, : len(r)] = r
            pred = torch.cat([pred.float(), torch.from_numpy(padded).to(pred.device)], 1)

    cmask = None
    if classes is not None:
        cm = np.zeros((nc,), np.float32)
        cm[np.asarray(classes, int)] = 1.0
        cmask = torch.from_numpy(cm).to(pred.device)
    det, valid = nms_batched(pred, conf_thres=conf_thres, iou_thres=iou_thres,
                             multi_label=multi_label, agnostic=agnostic,
                             class_mask=cmask, max_nms=max_nms, max_det=max_det)
    det, valid = det.cpu().numpy(), valid.cpu().numpy()
    return [det[i][valid[i]] for i in range(det.shape[0])]
