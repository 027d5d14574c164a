"""Inference app (counterpart of ``multiyolov5_tpu/cli/detect.py``; CLI-compatible
with reference detect.py:242-263).

Outputs per frame (reference detect.py:191-233), under the same names as
the JAX app: the annotated image, the colourised mask (``*_mask``), the
0.4/0.6 overlay (``*_dst``), optional yolo-format txt lines
(``--save-txt``, ``--save-conf``), and with ``--submit`` the
trainId->labelId Cityscapes export ``results/*_pred.png``.  Images are
read and written with the port's codecs (``data/images.py``: PNG, JPEG,
MPO, BMP, TIFF, WebP; the annotated image, ``_mask`` and ``_dst`` keep the
source's suffix, so a ``.jpg`` source gives ``.jpg`` artifacts at cv2's
defaults, a ``.bmp`` cv2's BMP bytes, a ``.tif`` its LZW TIFF and a
``.webp`` a lossless WebP that decodes to what cv2's does; an ``.mpo``
source raises at its first save, as cv2 has no MPO writer, unless
``--nosave``, and so does a ``.webp`` source at its ``_mask`` save, whose
name the JAX app cuts to ``name._maskwebp``, which no writer takes; the
``--submit`` exports stay PNG), boxes drawn by
``utils/plots.py``; nothing here needs cv2.  ``--view-img``,
``--save-as-video`` and video, webcam or stream sources need cv2 and
raise ``NotImplementedError`` before anything runs.

``--device`` picks the card: "" (the default) is ``cuda``, a number
``cuda:N``, ``cpu`` runs every kernel's plain version on the CPU.

Run: ``python -m multiyolov5_tpu_torch.cli.detect --weights w.npz --source dir``.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np

from ..data import images, png
from ..data.cityscapes import CITYSCAPES_COLORMAP, CITYSCAPES_IDMAP, label2image, trainid2id
from ..data.letterbox import check_img_size
from ..data.sources import LoadImages
from ..engine import Engine
from ..utils.boxes import xyxy2xywh
from ..utils.general import increment_path, set_logging
from ..utils.plots import add_weighted, plot_one_box


def select_device(device: str) -> str:
    """"" -> "cuda", "N" -> "cuda:N", "cpu" -> "cpu"."""
    device = str(device).strip().lower()
    if device == "cpu":
        return "cpu"
    return f"cuda:{device}" if device.isnumeric() else (device or "cuda")


def detect(opt):
    source, weights, save_txt = opt.source, opt.weights, opt.save_txt
    save_img = not opt.nosave and not source.endswith(".txt")
    webcam = source.isnumeric() or source.endswith(".txt") or \
        source.lower().startswith(("rtsp://", "rtmp://", "http://", "https://"))
    if webcam:
        raise NotImplementedError("webcam and stream sources need cv2's VideoCapture, "
                                  "which the port does not use")
    if opt.view_img or opt.save_as_video:
        raise NotImplementedError("--view-img and --save-as-video need cv2's windows and "
                                  "video writer, which the port does not use")

    save_dir = Path(increment_path(Path(opt.project) / opt.name, exist_ok=opt.exist_ok))
    (save_dir / "labels" if save_txt else save_dir).mkdir(parents=True, exist_ok=True)
    sub_dir = None
    if opt.submit:
        sub_dir = str(save_dir) + "/results/"
        os.makedirs(sub_dir, exist_ok=True)

    set_logging()
    # a list of weights builds an NMS ensemble (reference attempt_load)
    w = weights if isinstance(weights, list) and len(weights) > 1 else (
        weights[0] if isinstance(weights, list) else weights)
    engine = Engine(w, cfg=opt.cfg, device=select_device(opt.device), half=not opt.no_half)
    imgsz = check_img_size(opt.img_size, engine.stride)
    dataset = LoadImages(source, img_size=imgsz, stride=engine.stride,
                         auto=not (opt.submit or opt.save_as_video))

    names = engine.names
    rng = np.random.RandomState(0)
    colors = [[int(rng.randint(0, 255)) for _ in range(3)] for _ in names]

    t0 = time.time()
    for path, img, im0, _ in dataset:
        t1 = time.time()
        dets, masks = engine(img[None], tuple(im0.shape[:2]), conf=opt.conf_thres,
                             iou=opt.iou_thres, classes=opt.classes,
                             agnostic=opt.agnostic_nms, augment=opt.augment)
        t2 = time.time()
        det, mask_map = dets[0], masks[0]
        p = Path(path)
        save_path = str(save_dir / p.name)
        txt_path = str(save_dir / "labels" / p.stem)
        s = "%gx%g " % img.shape[:2]
        gn = np.array(im0.shape)[[1, 0, 1, 0]]
        if len(det):
            for c in np.unique(det[:, -1]):
                n = int((det[:, -1] == c).sum())
                s += f"{n} {names[int(c)]}{'s' * (n > 1)}, "
            lines = []
            for *xyxy, conf, cls in reversed(det):
                if save_txt:
                    xywh = (xyxy2xywh(np.array(xyxy)[None]) / gn).ravel().tolist()
                    line = (cls, *xywh, conf) if opt.save_conf else (cls, *xywh)
                    lines.append(("%g " * len(line)).rstrip() % line + "\n")
                if save_img:
                    label = f"{names[int(cls)]} {conf:.2f}"
                    plot_one_box(xyxy, im0, label=label, color=colors[int(cls)],
                                 line_thickness=3)
            if lines:
                with open(txt_path + ".txt", "a") as f:
                    f.writelines(lines)
        print(f"{s}Done. ({t2 - t1:.5f}s)")

        mask = dst = None
        if mask_map is not None:
            mask = label2image(mask_map, CITYSCAPES_COLORMAP)[:, :, ::-1]  # BGR
            dst = add_weighted(mask, 0.4, im0, 0.6, 0)
        if opt.submit and mask_map is not None:
            sub_path = sub_dir + str(p.name)
            sub_path = sub_path[:-4] + "_pred.png"
            png.imwrite(sub_path, trainid2id(mask_map, CITYSCAPES_IDMAP))
        if save_img:
            images.imwrite(save_path, im0)
            if mask is not None:
                images.imwrite(save_path[:-4] + "_mask" + save_path[-4:], mask)
                images.imwrite(save_path[:-4] + "_dst" + save_path[-4:], dst)

    if save_txt or save_img:
        print(f"Results saved to {save_dir}")
    print(f"Done. ({time.time() - t0:.3f}s)")
    return str(save_dir)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", nargs="+", type=str, default="yolov5s.pt",
                        help="model .npz or .pt path(s)")
    parser.add_argument("--cfg", type=str, default=None,
                        help="model config (zoo name or yaml) if weights lack one")
    parser.add_argument("--source", type=str, default="data/images")
    parser.add_argument("--img-size", type=int, default=640)
    parser.add_argument("--conf-thres", type=float, default=0.25)
    parser.add_argument("--iou-thres", type=float, default=0.45)
    parser.add_argument("--device", default="",
                        help="'' or N: the card (cuda, cuda:N); cpu: the plain versions on the CPU")
    parser.add_argument("--view-img", action="store_true")
    parser.add_argument("--save-txt", action="store_true")
    parser.add_argument("--save-conf", action="store_true")
    parser.add_argument("--nosave", action="store_true")
    parser.add_argument("--classes", nargs="+", type=int)
    parser.add_argument("--agnostic-nms", action="store_true")
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--update", action="store_true", help="no-op (parity)")
    parser.add_argument("--project", default="runs/detect")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--exist-ok", action="store_true")
    parser.add_argument("--save-as-video", action="store_true")
    parser.add_argument("--submit", action="store_true")
    parser.add_argument("--no-half", action="store_true",
                        help="disable bf16 inference (fp32 exactness)")
    return parser


def main(argv=None):
    opt = build_parser().parse_args(argv)
    print(opt)
    return detect(opt)


if __name__ == "__main__":
    main()
