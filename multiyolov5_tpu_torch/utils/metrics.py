"""Validation metrics (counterpart of ``multiyolov5_tpu/utils/metrics.py``,
a numpy copy of it; reference utils/metrics.py).

Detection AP bookkeeping runs on host numpy (tiny).  Segmentation eval
(evaluation.seg_validation) takes the class map from the card and
accumulates exact integer histograms on the host via SegMetric;
``seg_confusion_device`` counts the same on the card.  The PR, F1, P and R
curves and the confusion matrix are drawn by ``utils/plots.py``, without
matplotlib.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .boxes import box_iou


def fitness(x: np.ndarray) -> np.ndarray:
    """0.1*mAP@.5 + 0.9*mAP (reference utils/metrics.py:12-15)."""
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return (x[:, :4] * w).sum(1)


def fitness2(x: np.ndarray, miou) -> np.ndarray:
    """Multi-task model-selection metric: 0.1*mAP50 + 0.2*mAP + 0.7*mIoU
    (reference utils/metrics.py:17-22 — made row-wise: the reference's
    np.append flattens multi-row input, which its own comment admits only
    works because train.py always passes one row)."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    m = np.broadcast_to(np.asarray(miou, np.float64).reshape(-1, 1),
                        (x.shape[0], 1))
    w = np.array([0.0, 0.0, 0.1, 0.2, 0.7])
    return (np.concatenate([x[:, :4], m], 1) * w).sum(1)


def compute_ap(recall, precision):
    """101-point interpolated AP (reference utils/metrics.py:87-112)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") \
        else np.trapz(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, plot=False, save_dir=".",
                 names=()):
    """Per-class AP from accumulated stats (reference utils/metrics.py:24-84).

    Returns (p, r, ap (nc, niou), f1, unique_classes) at the max-F1 threshold.
    """
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]

    px, py = np.linspace(0, 1, 1000), []
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        ii = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = ii.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[ii]).cumsum(0)
        tpc = tp[ii].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[ii], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[ii], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if plot and j == 0:
                py.append(np.interp(px, mrec, mpre))

    f1 = 2 * p * r / (p + r + 1e-16)
    if plot:
        from . import plots
        plots.plot_pr_curve(px, py, ap, Path(save_dir) / "PR_curve.png", names)
        plots.plot_mc_curve(px, f1, Path(save_dir) / "F1_curve.png", names, ylabel="F1")
        plots.plot_mc_curve(px, p, Path(save_dir) / "P_curve.png", names, ylabel="Precision")
        plots.plot_mc_curve(px, r, Path(save_dir) / "R_curve.png", names, ylabel="Recall")
    i = f1.mean(0).argmax()
    return p[:, i], r[:, i], ap, f1[:, i], unique_classes.astype("int32")


class ConfusionMatrix:
    """Detection confusion matrix (reference utils/metrics.py:115-187)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray) -> None:
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        detection_classes = detections[:, 5].astype(int)
        if len(labels) and len(detections):
            iou = np.asarray(box_iou(labels[:, 1:], detections[:, :4]))
            xi, xj = np.where(iou > self.iou_thres)
        else:
            xi = np.zeros((0,), int)
        if xi.shape[0]:
            matches = np.concatenate(
                [np.stack([xi, xj], 1), iou[xi, xj][:, None]], 1)
            if xi.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = matches.shape[0] > 0
        m0, m1, _ = matches.T.astype(np.int16)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[gc, detection_classes[m1[j]]] += 1
            else:
                self.matrix[self.nc, gc] += 1
        if n:
            for i, dc in enumerate(detection_classes):
                if not any(m1 == i):
                    self.matrix[dc, self.nc] += 1

    def plot(self, save_dir="", names=()):
        """confusion_matrix.png in ``save_dir`` (utils/plots.py)."""
        from . import plots
        return plots.plot_confusion_matrix(self.matrix, self.nc, save_dir, names)

    def print(self):
        for i in range(self.nc + 1):
            print(" ".join(map(str, self.matrix[i])))


# ---------------------------------------------------------------------------
# Segmentation metrics (reference utils/metrics.py:234-275)
# ---------------------------------------------------------------------------


def batch_pix_accuracy(output: np.ndarray, target: np.ndarray) -> Tuple[int, int]:
    """output: (B, H, W, C) logits or (B, H, W) class map; target: (B, H, W)
    with ignore = -1."""
    predict = output.argmax(-1) if output.ndim == 4 else output
    predict = predict.astype(np.int64) + 1
    target = target.astype(np.int64) + 1
    pixel_labeled = np.sum(target > 0)
    pixel_correct = np.sum((predict == target) * (target > 0))
    return int(pixel_correct), int(pixel_labeled)


def batch_intersection_union(output: np.ndarray, target: np.ndarray,
                             nclass: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class intersection/union with the reference's +1 shift so the
    ignore class (-1) falls outside the histogram range."""
    predict = output.argmax(-1) if output.ndim == 4 else output
    predict = predict.astype(np.int64) + 1
    target = target.astype(np.int64) + 1
    predict = predict * (target > 0).astype(predict.dtype)
    intersection = predict * (predict == target)
    area_inter, _ = np.histogram(intersection, bins=nclass, range=(1, nclass))
    area_pred, _ = np.histogram(predict, bins=nclass, range=(1, nclass))
    area_lab, _ = np.histogram(target, bins=nclass, range=(1, nclass))
    area_union = area_pred + area_lab - area_inter
    return area_inter, area_union


def seg_confusion_device(logits, target, nclass: int):
    """Intersection and union counters on the logits' device (counterpart
    of the JAX ``seg_confusion_device``), for pipelines that keep the
    reduction there.

    logits: (B, C, H, W) NCHW tensor (C = ``nclass``); target: (B, H, W)
    integer tensor, -1 (any negative) ignored; a label of ``nclass`` or
    more counts in the prediction's area only.  Returns (inter (C,), union
    (C,)) int64 tensors on the logits' device: ``bincount`` counts, exact
    at any scale (the JAX float32 sums are exact below 2^24 pixels a
    class)."""
    import torch

    predict = logits.argmax(1).reshape(-1)
    target = torch.as_tensor(target, device=logits.device).reshape(-1).long()
    valid = target >= 0
    pred_v, lab_v = predict[valid], target[valid]
    hit = pred_v[pred_v == lab_v]

    def count(x):
        return torch.bincount(x, minlength=nclass)[:nclass]

    inter = count(hit)
    return inter, count(pred_v) + count(lab_v) - inter


class SegMetric:
    """Streaming mIoU/pixAcc accumulator (reference test.py:31-65 semantics)."""

    def __init__(self, nclass: int):
        self.nclass = nclass
        self.reset()

    def reset(self):
        self.total_inter = np.zeros(self.nclass)
        self.total_union = np.zeros(self.nclass)
        self.total_correct = 0
        self.total_label = 0

    def update(self, output: np.ndarray, target: np.ndarray):
        correct, labeled = batch_pix_accuracy(output, target)
        inter, union = batch_intersection_union(output, target, self.nclass)
        self.total_correct += correct
        self.total_label += labeled
        self.total_inter += inter
        self.total_union += union

    @property
    def pix_acc(self) -> float:
        return 1.0 * self.total_correct / (np.spacing(1) + self.total_label)

    @property
    def iou(self) -> np.ndarray:
        return 1.0 * self.total_inter / (np.spacing(1) + self.total_union)

    @property
    def miou(self) -> float:
        return float(self.iou.mean())
