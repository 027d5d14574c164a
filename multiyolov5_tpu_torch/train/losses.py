"""Training losses (counterpart of ``multiyolov5_tpu/train/losses.py``).

reference utils/loss.py.  Targets arrive padded to (B, T, 5) [cls, x, y, w,
h] normalized, with a (B, T) validity mask, and the assigner builds the full
static lattice of (target, anchor, 5 candidate cells) with a positive mask,
as the JAX package does, so the masked means reproduce the reference's.
The predictions at the lattice are gathered by indexing: the JAX package's
one-hot contraction (multiyolov5_tpu/train/losses.py:147-189) is a TPU
workaround for the scatter in the gather's backward and gives the same
values.

The objectness target ``tobj`` takes the max over lattice entries that land
in one cell, as in the JAX package (its module docstring): the reference's
last-write-wins depends on memory order.  Segmentation logits are planar
(B, C, H, W) here, NHWC there.

Data parallelism: each loss takes an optional ``group`` (parallel/comm.py)
over whose ranks the global batch is split, each rank holding an equal
slice.  A rank's loss is then its term of the global loss: the sums over
its slice over the global normalisers (positive counts, cells, pixels,
class weights, OHEM's threshold from the global pixel losses), so the sum
of the ranks' losses, and of their gradients, is the loss and gradient of
the global batch.  Reported items are the global values on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.comm import Group, all_gather_stacked, all_reduce_sum
from ..utils.boxes import bbox_iou_ciou

# 5 candidate cells: center + left/up/right/down neighbors (g = 0.5 bias)
_OFF = np.array([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]], np.float32) * 0.5


def smooth_bce(eps: float = 0.1) -> Tuple[float, float]:
    return 1.0 - 0.5 * eps, 0.5 * eps


def _bce_logits(logits, targets, pos_weight: float = 1.0):
    """Elementwise BCE-with-logits with pos_weight (torch semantics)."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def _focal_wrap(loss, logits, targets, gamma: float, alpha: float = 0.25):
    """FocalLoss wrapper (reference utils/loss.py:33-60, TF formulation)."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_f * (1.0 - p_t) ** gamma


def _qfocal_wrap(loss, logits, targets, gamma: float, alpha: float = 0.25):
    """QFocalLoss wrapper (reference utils/loss.py:63-86)."""
    p = torch.sigmoid(logits)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_f * torch.abs(targets - p) ** gamma


@dataclass
class DetectionLoss:
    """reference ComputeLoss (utils/loss.py:89-217).  With ``autobalance``
    the per-level objectness weights are state: the call takes them as
    ``balance`` and returns their update, renormalised by the stride-16
    level (``ssi``; reference utils/loss.py:156-161)."""

    nc: int
    na: int
    anchors: np.ndarray          # (nl, na, 2) in grid units (stride-divided)
    strides: Sequence[int]
    hyp: Dict[str, float]
    gr: float = 1.0
    balance: Sequence[float] = field(default_factory=lambda: [4.0, 1.0, 0.4])
    autobalance: bool = False

    def __post_init__(self):
        self.cp, self.cn = smooth_bce(self.hyp.get("label_smoothing", 0.0))
        if len(self.anchors) != 3:
            self.balance = [4.0, 1.0, 0.25, 0.06, 0.02][: len(self.anchors)]
        strides = list(self.strides)
        self.ssi = strides.index(16) if (self.autobalance and 16 in strides) else 0
        self._consts = {}

    def _device_consts(self, dev: torch.device, grids) -> Tuple[torch.Tensor, ...]:
        """(anchors (nl, na, 2), cell offsets (5, 2), per-level gains
        (nl, 4)) on ``dev``, copied there once per device and grid set."""
        key = (dev, grids)
        if key not in self._consts:
            gains = np.array([[nx, ny, nx, ny] for ny, nx in grids], np.float32)
            self._consts[key] = tuple(
                torch.from_numpy(a).to(dev)
                for a in (np.asarray(self.anchors, np.float32), _OFF, gains))
        return self._consts[key]

    def __call__(self, preds: List[torch.Tensor], targets: torch.Tensor,
                 tmask: torch.Tensor, balance: Optional[torch.Tensor] = None,
                 group: Optional[Group] = None):
        """preds: per-level raw maps (B, na, ny, nx, 5+nc) (any float dtype;
        the loss runs in float32); targets: (B, T, 5) [cls, x, y, w, h]
        normalized (padded); tmask: (B, T) bool validity; balance: the
        (nl,) objectness weights carried as state (autobalance); group:
        the ranks whose slices make the global batch (module docstring).
        Returns (loss * B, detached items (lbox, lobj, lcls, loss)), and
        the updated balance when ``balance`` is given; B, the items and
        the balance are the global batch's."""
        B, T = targets.shape[:2]
        ranks = 1 if group is None else group.size
        gsum = (lambda t: t.detach()) if ranks == 1 else group.sum
        na, hyp = self.na, self.hyp
        dev = targets.device
        fl_g = hyp.get("fl_gamma", 0.0)
        lcls = lbox = lobj = torch.zeros((), dtype=torch.float32, device=dev)
        N = B * T
        img_idx = torch.arange(B, device=dev)[:, None].expand(B, T).reshape(-1)
        t_flat = targets.reshape(N, 5).float()
        valid = tmask.reshape(N).bool()
        anchors, off, gains = self._device_consts(
            dev, tuple((p.shape[2], p.shape[3]) for p in preds))
        obj_per_level = []
        b_idx = img_idx[:, None, None].expand(N, na, 5)
        a_idx = torch.arange(na, device=dev)[None, :, None].expand(N, na, 5)

        for i, pi in enumerate(preds):
            pi = pi.float()
            ny, nx = pi.shape[2], pi.shape[3]
            anchors_i, gain = anchors[i], gains[i]                 # (na, 2), (4,)
            txywh = t_flat[:, 1:5] * gain                          # grid units
            gxy, gwh = txywh[:, :2], txywh[:, 2:]

            # anchor-ratio filter (N, na)
            r = gwh[:, None, :] / anchors_i[None, :, :]
            amask = torch.maximum(r, 1.0 / r).amax(-1) < hyp["anchor_t"]
            amask = amask & valid[:, None]

            # neighbor-cell candidates (reference :192-198)
            gxi = gain[:2] - gxy
            jm = (gxy % 1.0 < 0.5) & (gxy > 1.0)                   # (N, 2) -> j, k
            lm = (gxi % 1.0 < 0.5) & (gxi > 1.0)                   # (N, 2) -> l, m
            cand = torch.stack([torch.ones_like(jm[:, 0]), jm[:, 0], jm[:, 1],
                                lm[:, 0], lm[:, 1]], -1)            # (N, 5)

            # full lattice (N, na, 5)
            pos = amask[:, :, None] & cand[:, None, :]
            gij = torch.floor(gxy[:, None, :] - off[None])         # (N, 5, 2)
            gi = gij[..., 0].clamp(0, nx - 1).long()
            gj = gij[..., 1].clamp(0, ny - 1).long()
            gi_b = gi[:, None, :].expand(N, na, 5)
            gj_b = gj[:, None, :].expand(N, na, 5)
            ps = pi[b_idx, a_idx, gj_b, gi_b]                      # (N, na, 5, no)

            # target box relative to the chosen cell
            txy = gxy[:, None, :] - torch.stack([gi, gj], -1).float()  # (N, 5, 2)
            tbox = torch.cat([txy[:, None].expand(N, na, 5, 2),
                              gwh[:, None, None, :].expand(N, na, 5, 2)], -1)
            pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
            pwh = torch.square(torch.sigmoid(ps[..., 2:4]) * 2.0) * anchors_i[None, :, None, :]
            iou = bbox_iou_ciou(torch.cat([pxy, pwh], -1), tbox)   # (N, na, 5)

            n_pos = gsum(pos.sum().float()).clamp(min=1)
            lbox = lbox + torch.where(pos, 1.0 - iou, 0.0).sum() / n_pos

            # objectness target: max-scatter of the clamped detached iou
            iou_d = iou.detach().clamp(min=0.0)
            iou_d = torch.where(pos, (1.0 - self.gr) + self.gr * iou_d, 0.0)
            flat = ((b_idx * na + a_idx) * ny + gj_b) * nx + gi_b
            tobj = torch.zeros(B * na * ny * nx, dtype=torch.float32, device=dev)
            tobj = tobj.scatter_reduce(0, flat.reshape(-1), iou_d.reshape(-1), "amax",
                                       include_self=True).view(pi.shape[:4])
            obj_logit = pi[..., 4]
            obj_loss = _bce_logits(obj_logit, tobj, hyp.get("obj_pw", 1.0))
            if fl_g > 0:
                obj_loss = _focal_wrap(obj_loss, obj_logit, tobj, fl_g)
            obji = obj_loss.sum() / (obj_loss.numel() * ranks)
            obj_per_level.append(obji)
            lobj = lobj + obji * (balance[i] if balance is not None else self.balance[i])

            if self.nc > 1:
                tcls = t_flat[:, 0].long()
                t_onehot = (tcls[:, None] == torch.arange(self.nc, device=dev)).float()
                t_onehot = t_onehot * (self.cp - self.cn) + self.cn
                t_b = t_onehot[:, None, None, :].expand(N, na, 5, self.nc)
                cls_logits = ps[..., 5:]
                cls_loss = _bce_logits(cls_logits, t_b, hyp.get("cls_pw", 1.0))
                if fl_g > 0:
                    cls_loss = _focal_wrap(cls_loss, cls_logits, t_b, fl_g)
                lcls = lcls + torch.where(pos[..., None], cls_loss, 0.0).sum() / (
                    n_pos * self.nc)

        lbox = lbox * hyp["box"]
        lobj = lobj * hyp["obj"]
        lcls = lcls * hyp["cls"]
        loss = lbox + lobj + lcls
        items = gsum(torch.stack([lbox, lobj, lcls, loss]))
        if balance is not None:
            # EMA toward 1e-4 / obji, then renormalised by the stride-16 level
            obji = gsum(torch.stack(obj_per_level))
            new_bal = balance * 0.9999 + 0.0001 / obji
            return loss * (B * ranks), items, new_bal / new_bal[self.ssi]
        return loss * (B * ranks), items


# ---------------------------------------------------------------------------
# Segmentation losses (reference utils/loss.py:221-328), on planar logits
# ---------------------------------------------------------------------------


def _nll(logits: torch.Tensor, target: torch.Tensor, ignore_index: int):
    """(valid (B, H, W) bool, clamped target, -log_softmax at the target)."""
    valid = target != ignore_index
    t = torch.where(valid, target, 0).long()
    logp = F.log_softmax(logits.float(), dim=1)
    return valid, t, -logp.gather(1, t[:, None])[:, 0]


def _gsum(t: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return t if group is None else group.sum(t)


def cross_entropy_seg(logits: torch.Tensor, target: torch.Tensor,
                      weight: Optional[torch.Tensor] = None,
                      ignore_index: int = -1, group: Optional[Group] = None) -> torch.Tensor:
    """Mean CE over non-ignored pixels; logits (B, C, H, W), target (B, H, W)."""
    valid, t, nll = _nll(logits, target, ignore_index)
    if weight is not None:
        wpix = weight.to(nll.device, torch.float32)[t]
        nll = nll * wpix
        denom = torch.where(valid, wpix, 0.0).sum()
    else:
        denom = valid.sum().float()
    return torch.where(valid, nll, 0.0).sum() / _gsum(denom, group).clamp(min=1.0)


def segmentation_loss(preds, target, aux: bool = False, aux_num: int = 2,
                      aux_weight: float = 0.1, weight=None, ignore_index: int = -1,
                      group: Optional[Group] = None):
    """reference SegmentationLosses (utils/loss.py:221-263): plain CE, or CE
    plus the weighted aux heads (BiSe's two: ``aux_weight * 1.5`` and
    ``aux_weight / 2``; one: ``aux_weight``).  ``preds`` are logits at the
    target's size, or a list of them (main first)."""
    def ce(p):
        return cross_entropy_seg(p, target, weight, ignore_index, group)

    if not aux:
        return ce(preds[0] if isinstance(preds, (list, tuple)) else preds)
    if aux_num == 2:
        p1, p2, p3 = preds
        return ce(p1) + aux_weight * 1.5 * ce(p2) + aux_weight / 2.0 * ce(p3)
    p1, p2 = preds
    return ce(p1) + aux_weight * ce(p2)


def seg_focal_loss(logits, target, gamma: float = 2.0, ignore_index: int = -1,
                   group: Optional[Group] = None):
    """reference SegFocalLoss (utils/loss.py:279-297): the reference
    multiplies the *scalar mean CE* by per-pixel (1-p)^gamma then means.
    On a group the CE is the global one (its sum over the ranks, carried
    through autograd) and the mean is over the global pixels."""
    ce = all_reduce_sum(cross_entropy_seg(logits, target, None, ignore_index, group), group)
    t = torch.where(target == ignore_index, 0, target).long()
    pt = torch.softmax(logits.float(), 1).gather(1, t[:, None])[:, 0]
    ranks = 1 if group is None else group.size
    return ((1.0 - pt) ** gamma * ce).sum() / (pt.numel() * ranks)


def _global_places(v: torch.Tensor, group: Optional[Group], descending: bool):
    """(the place of each entry of this rank's ``v`` in the global sorted
    order of every rank's ``v`` (stable: ties by rank, then position, so
    every rank agrees), the gathered values)."""
    allv = all_gather_stacked(v.detach(), group).reshape(-1)
    order = torch.sort(allv, descending=descending, stable=True).indices
    place = torch.empty_like(order)
    place[order] = torch.arange(order.numel(), device=order.device)
    off = (0 if group is None else group.index) * v.numel()
    return place[off:off + v.numel()], allv


def ohem_ce_loss(preds, target, thresh: float = 0.7, ignore_index: int = -1,
                 aux: bool = False, aux_weight=(0.15, 0.05), group: Optional[Group] = None):
    """reference OhemCELoss (utils/loss.py:303-328): keep pixel losses above
    -log(thresh), but at least 1/16 of the valid pixels (top-k); with
    ``aux``, plus the two aux heads' at ``aux_weight``.  On a group, k and
    the kept pixels come from the global sorted pixel losses (all-gathered);
    each rank sums its kept ones over the global k."""
    def once(logits):
        valid, _, nll = _nll(logits, target, ignore_index)
        nll = torch.where(valid, nll, 0.0).reshape(-1)
        n_min = _gsum(valid.sum(), group) // 16
        place, allv = _global_places(nll, group, descending=True)
        k = torch.maximum((allv > -math.log(thresh)).sum(), n_min)
        keep = place < k
        return torch.where(keep, nll, 0.0).sum() / k.clamp(min=1)

    if not aux:
        return once(preds[0] if isinstance(preds, (list, tuple)) else preds)
    return (once(preds[0]) + aux_weight[0] * once(preds[1])
            + aux_weight[1] * once(preds[2]))


def prob_ohem_ce_loss(preds, target, thresh: float = 0.5, min_kept: int = 256,
                      ignore_index: int = -1, aux: bool = False,
                      aux_weight=(0.4, 0.4), class_weight=None,
                      group: Optional[Group] = None):
    """reference ProbOhemCrossEntropy2d (utils/loss.py:332-390): keep the
    pixels whose true-class probability is at most max(thresh, the
    ``min_kept``-th smallest probability); on a group, the global
    ``min_kept``-th (all-gathered) and the global denominator."""
    def once(logits):
        valid = (target != ignore_index).reshape(-1)
        t = torch.where(target == ignore_index, 0, target).long().reshape(-1)
        c = logits.shape[1]
        prob = torch.softmax(logits.float(), 1).permute(0, 2, 3, 1).reshape(-1, c)
        mask_prob = torch.where(valid, prob.gather(1, t[:, None])[:, 0], 1.0)
        sorted_p = torch.sort(all_gather_stacked(mask_prob.detach(), group).reshape(-1)).values
        kth = sorted_p[min(min_kept, sorted_p.shape[0]) - 1]
        kept = valid & (mask_prob <= torch.clamp(kth, min=thresh))
        nll = -torch.log(torch.clamp(prob, min=1e-12)).gather(1, t[:, None])[:, 0]
        if class_weight is not None:
            w = torch.as_tensor(class_weight, dtype=torch.float32, device=nll.device)[t]
            nll = nll * w
            denom = torch.where(kept, w, 0.0).sum()
        else:
            denom = kept.sum().float()
        return torch.where(kept, nll, 0.0).sum() / _gsum(denom, group).clamp(min=1.0)

    if not aux:
        return once(preds[0] if isinstance(preds, (list, tuple)) else preds)
    return (once(preds[0]) + aux_weight[0] * once(preds[1])
            + aux_weight[1] * once(preds[2]))


def pad_targets(labels: List[np.ndarray], max_t: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: list of per-image (n, 5) [cls, xywh] -> padded (B, T, 5) + mask."""
    B = len(labels)
    out = np.zeros((B, max_t, 5), np.float32)
    mask = np.zeros((B, max_t), bool)
    for i, lab in enumerate(labels):
        n = min(len(lab), max_t)
        if n:
            out[i, :n] = lab[:n]
            mask[i, :n] = True
    return out, mask
