"""Cityscapes polygon json -> YOLO txt detection labels.

reference data/citys/2yolo_filter.py: walks leftImg8bit/{split}/{city},
extracts bboxes from gtFine polygon extrema for the 10 detection classes,
writes normalized [cls cx cy w h] txts under labels/{split}, copies images to
images/{split}, and emits yolo_{split}.txt file lists + classes.txt.

Run: python -m multiyolov5_tpu_torch.tools.cityscapes2yolo --root data/citys
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
from pathlib import Path

# 10-class detection label map (reference 2yolo_filter.py:58-68)
LABEL_MAP = {
    "car": 0, "traffic sign": 1, "rider": 2, "person": 3, "bicycle": 4,
    "traffic light": 5, "bus": 6, "motorcycle": 7, "truck": 8, "train": 9,
}


def polygon_bbox(points):
    xs = [float(p[0]) for p in points]
    ys = [float(p[1]) for p in points]
    return min(xs), max(xs), min(ys), max(ys)


def to_yolo(size_wh, bbox):
    """(xmin,xmax,ymin,ymax) -> normalized cx cy w h (with the reference's
    -1 center shift, 2yolo_filter.py:17)."""
    cx = (bbox[0] + bbox[1]) / 2.0 - 1
    cy = (bbox[2] + bbox[3]) / 2.0 - 1
    w = bbox[1] - bbox[0]
    h = bbox[3] - bbox[2]
    return cx / size_wh[0], cy / size_wh[1], w / size_wh[0], h / size_wh[1]


def convert_annotation(image_id: str, label_dir: Path, out_dir: Path,
                       label_map=LABEL_MAP) -> None:
    d = json.load(open(label_dir / f"{image_id}_gtFine_polygons.json"))
    lines = []
    for obj in d["objects"]:
        if obj["label"] not in label_map:
            continue
        x, y, w, h = to_yolo((d["imgWidth"], d["imgHeight"]),
                             polygon_bbox(obj["polygon"]))
        lines.append(f"{label_map[obj['label']]} {x} {y} {w} {h}\n")
    with open(out_dir / f"{image_id}_leftImg8bit.txt", "w") as fh:
        fh.writelines(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".", help="dir containing leftImg8bit/ gtFine/")
    args = ap.parse_args(argv)
    root = Path(args.root)
    image_dir = root / "leftImg8bit"
    label_dir = root / "gtFine"
    img_out = root / "images"
    lbl_out = root / "labels"
    for split in sorted(os.listdir(image_dir)):
        files = []
        (img_out / split).mkdir(parents=True, exist_ok=True)
        (lbl_out / split).mkdir(parents=True, exist_ok=True)
        for city in sorted(os.listdir(image_dir / split)):
            src_img = image_dir / split / city
            src_lbl = label_dir / split / city
            ids = [re.sub(r"_leftImg8bit\.png$", "", s)
                   for s in os.listdir(src_img) if s.endswith(".png")]
            for img_id in ids:
                convert_annotation(img_id, src_lbl, lbl_out / split)
                fname = f"{img_id}_leftImg8bit.png"
                shutil.copy(src_img / fname, img_out / split / fname)
                files.append(f"images/{split}/{fname}\n")
        with open(root / f"yolo_{split}.txt", "w") as fh:
            fh.writelines(files)
        print(f"{split}: {len(files)} images")
    with open(lbl_out / "classes.txt", "w") as fh:
        for k in LABEL_MAP:
            fh.write(k + "\n")
    print(list(LABEL_MAP), len(LABEL_MAP))


if __name__ == "__main__":
    main()
