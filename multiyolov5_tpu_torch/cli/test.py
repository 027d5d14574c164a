"""Eval CLI (counterpart of ``multiyolov5_tpu/cli/test.py``; flag-compatible
with reference test.py:343-406).

Runs detection mAP on the dataset yaml's ``val`` split (the rect
``DetectionLoader``, conf 0.001, iou 0.6, multi-label NMS over up to 30000
candidates) and segmentation pixAcc / mIoU on ``segval`` (the testval
loaders, batch ``max(batch_size // 8, 1)``).  ``--img-size`` (det) and
``--base-size`` (seg) are independent, as in the reference (README.md:80).
It prints the rounded metrics as one JSON line and returns them.

``--device`` picks the card: "" (the default) is ``cuda``, a number
``cuda:N``, ``cpu`` runs every kernel's plain version on the CPU.  The
default is float32 (``--half`` for bfloat16).  ``--task``, ``--augment``
and ``--save-hybrid`` are accepted and ignored, as in the JAX CLI.
``--plots`` writes the PR, F1, P and R curves and the confusion matrix
into ``--save-dir`` (``utils/plots.py``, no matplotlib).  A split's images
may be PNG, JPEG, MPO, BMP, TIFF or WebP; a DNG image raises
``NotImplementedError`` naming it.

Run: ``python -m multiyolov5_tpu_torch.cli.test --weights w.npz --data d.yaml``
(``--data`` may be a JSON file, which needs no PyYAML).
"""

from __future__ import annotations

import argparse
import json

from ..data.detection import DetectionDataset, DetectionLoader
from ..data.hyps import read_yaml
from ..data.segmentation import get_citys_loader, get_citysbdd_loader, get_custom_loader
from ..engine import Engine
from ..evaluation import evaluate_detection, seg_validation
from ..utils.general import set_logging
from .detect import select_device


def run(opt):
    set_logging()
    data = read_yaml(opt.data)        # JSON needs no PyYAML
    w = opt.weights[0] if isinstance(opt.weights, list) else opt.weights
    eng = Engine(w, cfg=opt.cfg, device=select_device(opt.device), half=opt.half)
    spec = eng.spec

    results = {}
    if not opt.seg_only and data.get("val"):
        ds = DetectionDataset(data["val"], img_size=opt.img_size,
                              batch_size=opt.batch_size, augment=False,
                              rect=True, stride=eng.stride, pad=0.5)
        loader = DetectionLoader(ds, batch_size=opt.batch_size,
                                 max_targets=opt.max_targets, shuffle=False,
                                 workers=opt.workers, drop_last=False)
        names = data.get("names", spec.names)
        (mp, mr, map50, map_, *_), _, _ = evaluate_detection(
            eng, loader, names=names, conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
            single_cls=opt.single_cls, verbose=opt.verbose, plots=opt.plots,
            save_dir=opt.save_dir,
            save_txt=opt.save_txt, save_conf=opt.save_conf, save_json=opt.save_json,
            anno_json=(opt.anno_json or data.get("anno_json")))
        results.update(P=mp, R=mr, mAP50=map50, mAP=map_)

    if not opt.det_only and data.get("segval") and spec.n_segcls:
        factory = {"citys": get_citys_loader, "citysbdd": get_citysbdd_loader,
                   "custom": get_custom_loader}[opt.seg_data_kind]
        kwargs = dict(root=data["segval"], split="val", mode="testval",
                      batch_size=max(opt.batch_size // 8, 1),
                      workers=opt.workers, base_size=opt.base_size)
        if opt.seg_data_kind == "custom":
            kwargs["n_segcls"] = spec.n_segcls
        else:
            kwargs["crop_size"] = (opt.base_size, opt.base_size // 2)
        pix_acc, miou = seg_validation(eng, factory(**kwargs), nclass=spec.n_segcls)
        results.update(pixAcc=pix_acc, mIoU=miou)

    print(json.dumps({k: round(float(v), 5) for k, v in results.items()}))
    return results


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--weights", nargs="+", type=str, default="yolov5s.pt",
                   help="model .npz or .pt path")
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--data", type=str, default="data/cityscapes_det.yaml")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--img-size", type=int, default=1024, help="det eval size")
    p.add_argument("--base-size", type=int, default=1024, help="seg long side")
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--task", default="val")
    p.add_argument("--device", default="",
                   help="'' or N: the card (cuda, cuda:N); cpu: the plain versions on the CPU")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--half", action="store_true",
                   help="bf16 inference (default fp32 for exact metrics)")
    p.add_argument("--seg-only", action="store_true")
    p.add_argument("--det-only", action="store_true")
    p.add_argument("--seg-data-kind", choices=["citys", "citysbdd", "custom"],
                   default="citys")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--max-targets", type=int, default=300)
    p.add_argument("--plots", action="store_true")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true")
    p.add_argument("--save-json", action="store_true",
                   help="save COCO-format predictions.json")
    p.add_argument("--save-hybrid", action="store_true",
                   help="unsupported placeholder (reference autolabel mode)")
    p.add_argument("--save-dir", default=".")
    p.add_argument("--anno-json", default=None,
                   help="COCO annotations json for official COCOeval on the "
                        "--save-json dump (reference test.py:308-330)")
    return p


def main(argv=None):
    opt = build_parser().parse_args(argv)
    print(opt)
    return run(opt)


if __name__ == "__main__":
    main()
