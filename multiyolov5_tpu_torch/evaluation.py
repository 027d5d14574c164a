"""Evaluation: detection mAP and segmentation mIoU (counterpart of
``multiyolov5_tpu/evaluation.py``; reference test.py).

``evaluate_detection`` reproduces test.test() (test.py:77-340): the rect
loader's uint8 batches through ``Engine.forward`` (K1 folds the /255, K2
runs the neck), conf 0.001 / iou 0.6 multi-label NMS over up to 30000
(box, class) candidates (one K5 launch a batch), IoU-vector matching over
iouv = linspace(.5, .95, 10), ap_per_class.

``seg_validation`` reproduces test.seg_validation (test.py:31-65): the
head's x8 align-corners upsample, the resize to the label size and the
argmax are one K4 launch on the 1/8-res logits, and the streaming
intersection/union accumulates on the host.  Its float batches (the seg
loader's x / 255) reach the forward unquantised, through K1's float mode.

Both take a port ``Engine``, or build one on ``device`` (the card by
default) in float32 (``half=False``, as ``cli/test.py`` defaults, for exact
metrics).  The host-side bookkeeping is the JAX package's numpy code.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .engine import Engine
from .ops.kernels import upsample_argmax
from .ops.nms import non_max_suppression
from .utils.boxes import box_iou, scale_coords, xywh2xyxy, xyxy2xywh
from .utils.metrics import ConfusionMatrix, SegMetric, ap_per_class


def _engine(engine: Union[Engine, str, None], cfg, device, half) -> Engine:
    """``engine`` itself, or an Engine from a checkpoint path (None: seeded
    weights of ``cfg``)."""
    if isinstance(engine, Engine):
        return engine
    return Engine(engine, cfg=cfg, device=device, half=half)


def _frames(imgs, device: torch.device) -> torch.Tensor:
    """A loader batch (B, H, W, 3), uint8 or float in [0, 1] (the seg
    loader's x / 255), as a contiguous tensor on ``device``: uint8 stays
    uint8, a float batch goes to the forward as float32 (bfloat16 as it
    is), unquantised, as the JAX package feeds it to its forward."""
    x = torch.as_tensor(np.ascontiguousarray(imgs))
    if x.is_floating_point() and x.dtype != torch.bfloat16:
        x = x.float()
    return x.to(device).contiguous()


def _match_predictions(detections: np.ndarray, labels: np.ndarray,
                       iouv: np.ndarray) -> np.ndarray:
    """Per-image TP matrix (n_pred, n_iou), reference test.py:207-245."""
    correct = np.zeros((detections.shape[0], iouv.size), bool)
    if len(labels) == 0 or len(detections) == 0:
        return correct
    detected: set = set()
    tcls = labels[:, 0]
    tbox = labels[:, 1:5]
    for cls in np.unique(tcls):
        ti = np.where(cls == tcls)[0]
        pi = np.where(cls == detections[:, 5])[0]
        if len(pi):
            iou_m = np.asarray(box_iou(detections[pi, :4], tbox[ti]))
            ious = iou_m.max(1)
            idx = iou_m.argmax(1)
            for j in np.where(ious > iouv[0])[0]:
                d = ti[idx[j]]
                if d not in detected:
                    detected.add(d)
                    correct[pi[j]] = ious[j] > iouv
                    if len(detected) == len(labels):
                        break
    return correct


def evaluate_detection(engine: Union[Engine, str, None], loader, names=None,
                       conf_thres: float = 0.001, iou_thres: float = 0.6,
                       plots: bool = False, save_dir: str = ".",
                       verbose: bool = False, single_cls: bool = False,
                       loss_hyp: Optional[Dict] = None,
                       save_txt: bool = False, save_conf: bool = False,
                       save_json: bool = False, anno_json: Optional[str] = None,
                       wandb_logger=None, *, cfg=None,
                       device: Union[str, torch.device] = "cuda", half: bool = False):
    """Detection metrics over ``loader``'s batches (imgs (B, H, W, 3) uint8,
    targets (B, T, 5) [cls, xywh normalized], tmask (B, T) bool, paths,
    shapes: per image ((h0, w0), ratio_pad) or None).

    Returns ((P, R, mAP50, mAP, vbox, vobj, vcls), maps_per_class,
    (t_inf, t_nms, seen)); the times are host seconds around synchronised
    work.  Given ``loss_hyp``, (vbox, vobj, vcls) are the mean over the
    batches of ``DetectionLoss``'s (lbox, lobj, lcls) on Detect's raw maps
    (multiyolov5_tpu/evaluation.py:85-93, :114-117), else 0.

    ``plots`` fills a ``ConfusionMatrix`` and writes it and the PR, F1, P
    and R curves into ``save_dir``; a ``wandb_logger`` with a val table gets
    each of the first ``log_imgs`` images' boxes in original pixels
    (``log_training_progress``)."""
    eng = _engine(engine, cfg, device, half)
    spec = eng.spec
    nc = spec.nc
    iouv = np.linspace(0.5, 0.95, 10)
    stats: List = []
    seen = 0
    t_inf = t_nms = 0.0
    confusion = ConfusionMatrix(nc=nc) if plots else None
    det_loss = None
    if loss_hyp is not None:
        from .train.losses import DetectionLoss
        det_loss = DetectionLoss(
            nc=nc, na=spec.na,
            anchors=np.asarray(spec.anchors, np.float32).reshape(spec.nl, spec.na, 2)
            / np.asarray(spec.strides, np.float32)[:, None, None],
            strides=spec.strides, hyp=loss_hyp)
    loss_items = np.zeros(3)
    n_batches = 0

    jdict: List[Dict] = []
    txt_dir = Path(save_dir) / "labels"
    if save_txt:
        txt_dir.mkdir(parents=True, exist_ok=True)

    for imgs, targets, tmask, paths, shapes in loader:
        n_batches += 1
        x = _frames(imgs, eng.device)
        t0 = time.time()
        z, _ = eng.forward(x) if det_loss is None else eng.forward(x, raw=True)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        t_inf += time.time() - t0
        if det_loss is not None:
            z, raw = z
            with torch.inference_mode():
                _, items = det_loss(raw, torch.as_tensor(targets).to(eng.device),
                                    torch.as_tensor(tmask).to(eng.device))
            loss_items += items[:3].cpu().numpy()
        t0 = time.time()
        with torch.inference_mode():
            preds = non_max_suppression(z.transpose(1, 2), conf_thres=conf_thres,
                                        iou_thres=iou_thres, multi_label=True,
                                        max_nms=30000)  # reference cap (:439)
        t_nms += time.time() - t0

        h, w = imgs.shape[1:3]
        for si, pred in enumerate(preds):
            lmask = tmask[si]
            lab = targets[si][lmask]
            tcls = lab[:, 0].tolist() if len(lab) else []
            seen += 1
            if len(pred) == 0:
                if len(lab):
                    stats.append((np.zeros((0, iouv.size), bool),
                                  np.zeros(0), np.zeros(0), tcls))
                continue
            if single_cls:
                pred = pred.copy()
                pred[:, 5] = 0
            predn = pred.copy()
            if shapes[si] is not None:
                (h0, w0), ratio_pad = shapes[si]
                predn[:, :4] = np.asarray(scale_coords(
                    (h, w), predn[:, :4], (h0, w0), ratio_pad))[:, :4]
            if wandb_logger is not None and wandb_logger.val_table_map \
                    and seen <= wandb_logger.log_imgs:
                # each image's box panel (reference test.py:220-221)
                wandb_logger.log_training_progress(
                    predn, paths[si], dict(enumerate(names or map(str, range(nc)))))
            if save_txt and shapes[si] is not None:
                (h0, w0), _ = shapes[si]
                gn = np.array([w0, h0, w0, h0])
                stem = Path(paths[si]).stem
                with open(txt_dir / f"{stem}.txt", "a") as fh:
                    for *xyxy, pconf, pcls in predn:
                        xywh = (np.asarray(xyxy2xywh(np.array(xyxy)[None])) / gn).ravel()
                        line = (pcls, *xywh, pconf) if save_conf else (pcls, *xywh)
                        fh.write(("%g " * len(line)).rstrip() % line + "\n")
            if save_json:  # pycocotools-style records (reference :300-330)
                stem = Path(paths[si]).stem
                image_id = int(stem) if stem.isnumeric() else stem
                box = np.asarray(xyxy2xywh(predn[:, :4]))
                box[:, :2] -= box[:, 2:] / 2  # center -> top-left
                for p, b in zip(predn.tolist(), box.tolist()):
                    jdict.append({"image_id": image_id,
                                  "category_id": int(p[5]),
                                  "bbox": [round(x, 3) for x in b],
                                  "score": round(p[4], 5)})
            if len(lab):
                tbox = np.asarray(xywh2xyxy(lab[:, 1:5])) * [w, h, w, h]
                if shapes[si] is not None:
                    (h0, w0), ratio_pad = shapes[si]
                    tbox = np.asarray(scale_coords((h, w), tbox, (h0, w0),
                                                   ratio_pad))[:, :4]
                labelsn = np.concatenate([lab[:, 0:1], tbox], 1)
                correct = _match_predictions(predn, labelsn, iouv)
                if confusion is not None:
                    confusion.process_batch(predn, labelsn)
            else:
                correct = np.zeros((pred.shape[0], iouv.size), bool)
            stats.append((correct, pred[:, 4], pred[:, 5], tcls))

    stats_np = [np.concatenate([np.atleast_1d(np.asarray(x[i])) if len(x[i])
                                else np.zeros((0, iouv.size) if i == 0 else 0)
                                for x in stats], 0) for i in range(4)]
    if len(stats_np[0]) and stats_np[0].any():
        p, r, ap, f1, ap_class = ap_per_class(*stats_np, plot=plots, save_dir=save_dir,
                                              names=names or [])
        ap50, ap_m = ap[:, 0], ap.mean(1)
        mp, mr, map50, map_ = p.mean(), r.mean(), ap50.mean(), ap_m.mean()
        nt = np.bincount(stats_np[3].astype(np.int64), minlength=nc)
    else:
        mp = mr = map50 = map_ = 0.0
        ap_m, ap_class = np.zeros(0), np.zeros(0, int)
        nt = np.zeros(nc)

    maps = np.zeros(nc) + map_
    for i, c in enumerate(ap_class):
        maps[int(c)] = ap_m[i]
    if verbose and len(ap_class) and names:
        # per-class table (reference test.py:287-290)
        print(f"{'class':>20s}{'labels':>9s}{'P':>10s}{'R':>10s}"
              f"{'mAP@.5':>10s}{'mAP@.5:.95':>11s}")
        for i, c in enumerate(ap_class):
            print(f"{names[int(c)]:>20s}{int(nt[int(c)]):>9d}{p[i]:>10.3g}"
                  f"{r[i]:>10.3g}{ap50[i]:>10.3g}{ap_m[i]:>11.3g}")
    if confusion is not None:
        confusion.plot(save_dir=save_dir, names=names or [])
    loss_avg = loss_items / max(n_batches, 1)
    if save_json and jdict:
        import json as json_lib
        pred_json = Path(save_dir) / "predictions.json"
        with open(pred_json, "w") as fh:
            json_lib.dump(jdict, fh)
        print(f"saved {len(jdict)} COCO-format predictions to {pred_json}")
        # official COCOeval on the dump (reference test.py:308-330), where
        # pycocotools is installed; the JSON is saved either way
        if anno_json is not None:
            try:
                from pycocotools.coco import COCO
                from pycocotools.cocoeval import COCOeval

                anno = COCO(str(anno_json))
                pred = anno.loadRes(str(pred_json))
                ce = COCOeval(anno, pred, "bbox")
                img_ids = [j["image_id"] for j in jdict]
                if all(isinstance(i, int) for i in img_ids):
                    ce.params.imgIds = sorted(set(img_ids))
                ce.evaluate()
                ce.accumulate()
                ce.summarize()
                map_, map50 = float(ce.stats[0]), float(ce.stats[1])
            except ImportError:
                print("pycocotools not installed: skipping the official "
                      "COCOeval (predictions.json saved for offline eval)")
            except Exception as e:  # malformed annotations etc., ref:328
                print(f"COCOeval failed: {e}")
    print(f"Detection: {seen} images, {int(nt.sum())} labels | "
          f"P {mp:.4g} R {mr:.4g} mAP@.5 {map50:.4g} mAP@.5:.95 {map_:.4g}")
    return (mp, mr, map50, map_, *loss_avg.tolist()), maps, (t_inf, t_nms, seen)


def seg_validation(engine: Union[Engine, str, None], loader, nclass: int,
                   exact: bool = True, *, cfg=None,
                   device: Union[str, torch.device] = "cuda",
                   half: bool = False) -> Tuple[float, float]:
    """Streaming (pixAcc, mIoU) over ``loader``'s (imgs (B, H, W, 3) uint8
    or float in [0, 1], masks (B, H0, W0) int with ignore = -1) batches,
    reference test.py:31-65.  ``exact`` takes the class map from float32
    logits even when the engine runs bfloat16."""
    eng = _engine(engine, cfg, device, half)
    metric = SegMetric(nclass)
    for imgs, masks in loader:
        _, seg = eng.forward(_frames(imgs, eng.device))
        if seg is None:
            raise ValueError("the model has no segmentation head")
        with torch.inference_mode():
            seg = seg.float() if exact else seg
            via = (seg.shape[2] * 8, seg.shape[3] * 8)     # the head's x8 upsample
            pred = upsample_argmax(seg.contiguous(), tuple(masks.shape[1:3]), via_hw=via)
        metric.update(pred.cpu().numpy(), np.asarray(masks))
    print(f"Segmentation: pixAcc {metric.pix_acc:.4f}, mIoU {metric.miou:.4f}")
    return metric.pix_acc, metric.miou
