"""Labelme annotation converters (counterpart of
``multiyolov5_tpu/tools/labelme_convert.py``; reference
data/customdata/convert_tools/).

  * ``labelme2seg``  — polygon json dir -> class-id PNG masks + class_names.txt
                       (negatives -> 255 ignore)
  * ``labelme2det``  — rectangle/polygon json dir -> YOLO txt labels
  * ``voc2yolo`` / ``coco2yolo`` / ``kitti2yolo`` — classic format converters
                       (reference convert2Yolo/Format.py)

Workflow (reference data/customdata/README.md): annotate with labelme ->
convert -> drop into detdata/{images,labels} and {segimages,seglabels}.

Without PIL: the shapes are filled by data/draw.py, Pillow's fill in
numpy; a PNG, JPEG, MPO, BMP, TIFF or WebP ``imageData`` or ``imagePath`` is
read as PIL's ``convert("RGB")`` reads it (data/images.py), and the image
goes out as the JAX tool writes it, ``JPEGImages/<stem>.jpg`` and
``images/<stem>.jpg`` at PIL's ``save`` defaults (data/jpeg.py
``pil_save``).  Another image format (DNG) raises
``NotImplementedError`` naming it.  ``kitti2yolo`` reads an image's size
from its header, as ``Image.open(p).size`` gives it.

Run: python -m multiyolov5_tpu_torch.tools.labelme_convert labelme2seg IN OUT --labels labels.txt
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os
import os.path as osp
from typing import Dict, List, Tuple

import numpy as np

from ..data import draw, images, jpeg, png

def _load_labels(labels_file: str) -> Dict[str, int]:
    """labels file: '__ignore__' -> -1, '_background_' -> 0, rest 1.."""
    name_to_id = {}
    for i, line in enumerate(open(labels_file).read().splitlines()):
        name_to_id[line.strip()] = i - 1
    return name_to_id


def _labelme_image(data: dict, json_path: str) -> np.ndarray:
    """The shape file's image, (H, W, 3) uint8 RGB (PIL's ``convert("RGB")``)."""
    if data.get("imageData"):
        raw = base64.b64decode(data["imageData"])
        if not images.known_signature(raw):
            raise NotImplementedError(
                f"{json_path}: imageData is not PNG, JPEG, BMP, TIFF or WebP; the port "
                "decodes those only")
        return images.decode_rgb(raw, json_path)
    p = osp.join(osp.dirname(json_path), data["imagePath"])
    images.require_readable([p], "labelme imagePath")
    return images.read_rgb(p)


def _shape_to_mask(size_hw, points, shape_type="polygon") -> np.ndarray:
    xy = [tuple(p) for p in points]
    if shape_type == "rectangle":
        (x0, y0), (x1, y1) = xy  # labelme corners may come in any order
        return draw.rectangle(size_hw, [min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1)])
    if shape_type == "circle":
        (cx, cy), (px, py) = xy
        r = ((cx - px) ** 2 + (cy - py) ** 2) ** 0.5
        return draw.ellipse(size_hw, [cx - r, cy - r, cx + r, cy + r])
    return draw.polygon(size_hw, xy)


def labelme2seg(input_dir: str, output_dir: str, labels_file: str) -> None:
    name_to_id = _load_labels(labels_file)
    os.makedirs(osp.join(output_dir, "JPEGImages"), exist_ok=True)
    os.makedirs(osp.join(output_dir, "SegmentationClassPNG"), exist_ok=True)
    class_names = [n for n, i in sorted(name_to_id.items(), key=lambda kv: kv[1])
                   if i >= 0]
    with open(osp.join(output_dir, "class_names.txt"), "w") as fh:
        fh.write("\n".join(class_names))
    for jf in sorted(glob.glob(osp.join(input_dir, "*.json"))):
        data = json.load(open(jf))
        img = _labelme_image(data, jf)
        base = osp.splitext(osp.basename(jf))[0]
        jpeg.pil_save(osp.join(output_dir, "JPEGImages", base + ".jpg"), img)
        h, w = img.shape[:2]
        cls_map = np.zeros((h, w), np.int32)
        for shape in data.get("shapes", []):
            cid = name_to_id.get(shape["label"], -1)
            m = _shape_to_mask((h, w), shape["points"],
                               shape.get("shape_type", "polygon"))
            cls_map[m] = cid
        cls_map[cls_map < 0] = 255  # ignore (reference generate_mask.py:24)
        png.imwrite(osp.join(output_dir, "SegmentationClassPNG", base + ".png"),
                    cls_map.astype(np.uint8))
        print("generated", base + ".png")


def labelme2det(input_dir: str, output_dir: str, labels_file: str) -> None:
    name_to_id = _load_labels(labels_file)
    os.makedirs(osp.join(output_dir, "images"), exist_ok=True)
    os.makedirs(osp.join(output_dir, "labels"), exist_ok=True)
    # detection ids start at 0 for the first real class
    det_ids = {n: i - 1 for n, i in name_to_id.items() if i >= 1}
    for jf in sorted(glob.glob(osp.join(input_dir, "*.json"))):
        data = json.load(open(jf))
        img = _labelme_image(data, jf)
        base = osp.splitext(osp.basename(jf))[0]
        jpeg.pil_save(osp.join(output_dir, "images", base + ".jpg"), img)
        h, w = img.shape[:2]
        lines = []
        for shape in data.get("shapes", []):
            if shape["label"] not in det_ids:
                continue
            pts = np.asarray(shape["points"], np.float64)
            x1, y1 = pts.min(0)
            x2, y2 = pts.max(0)
            cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
            bw, bh = (x2 - x1) / w, (y2 - y1) / h
            lines.append(f"{det_ids[shape['label']]} {cx} {cy} {bw} {bh}\n")
        with open(osp.join(output_dir, "labels", base + ".txt"), "w") as fh:
            fh.writelines(lines)
        print("generated", base + ".txt")


def voc2yolo(xml_dir: str, output_dir: str, names: List[str]) -> None:
    """VOC xml -> YOLO txt (reference convert2Yolo Format.py voc branch)."""
    import xml.etree.ElementTree as ET

    os.makedirs(output_dir, exist_ok=True)
    for xf in sorted(glob.glob(osp.join(xml_dir, "*.xml"))):
        root = ET.parse(xf).getroot()
        w = float(root.find("size/width").text)
        h = float(root.find("size/height").text)
        lines = []
        for obj in root.findall("object"):
            name = obj.find("name").text
            if name not in names:
                continue
            b = obj.find("bndbox")
            x1, y1 = float(b.find("xmin").text), float(b.find("ymin").text)
            x2, y2 = float(b.find("xmax").text), float(b.find("ymax").text)
            lines.append(f"{names.index(name)} {(x1 + x2) / 2 / w} "
                         f"{(y1 + y2) / 2 / h} {(x2 - x1) / w} {(y2 - y1) / h}\n")
        out = osp.join(output_dir, osp.splitext(osp.basename(xf))[0] + ".txt")
        with open(out, "w") as fh:
            fh.writelines(lines)


def coco2yolo(json_file: str, output_dir: str) -> None:
    """COCO instance json -> YOLO txts keyed by image file stem."""
    os.makedirs(output_dir, exist_ok=True)
    d = json.load(open(json_file))
    cats = {c["id"]: i for i, c in enumerate(
        sorted(d["categories"], key=lambda c: c["id"]))}
    imgs = {im["id"]: im for im in d["images"]}
    per_img: Dict[int, list] = {}
    for ann in d["annotations"]:
        im = imgs[ann["image_id"]]
        x, y, bw, bh = ann["bbox"]
        w, h = im["width"], im["height"]
        per_img.setdefault(ann["image_id"], []).append(
            f"{cats[ann['category_id']]} {(x + bw / 2) / w} {(y + bh / 2) / h} "
            f"{bw / w} {bh / h}\n")
    for iid, lines in per_img.items():
        stem = osp.splitext(imgs[iid]["file_name"])[0]
        with open(osp.join(output_dir, stem + ".txt"), "w") as fh:
            fh.writelines(lines)


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of an image file (``Image.open(path).size``)."""
    return images.size(path)


def kitti2yolo(label_dir: str, output_dir: str, names: List[str],
               img_dir: str = None) -> None:
    """KITTI txt (absolute xyxy) -> YOLO txt; image sizes read from img_dir."""
    os.makedirs(output_dir, exist_ok=True)
    for lf in sorted(glob.glob(osp.join(label_dir, "*.txt"))):
        stem = osp.splitext(osp.basename(lf))[0]
        w = h = None
        if img_dir:
            for ext in (".png", ".jpg"):
                p = osp.join(img_dir, stem + ext)
                if osp.exists(p):
                    w, h = image_size(p)
                    break
        assert w, f"no image found for {stem}"
        lines = []
        for row in open(lf).read().splitlines():
            parts = row.split()
            if parts[0] not in names:
                continue
            x1, y1, x2, y2 = map(float, parts[4:8])
            lines.append(f"{names.index(parts[0])} {(x1 + x2) / 2 / w} "
                         f"{(y1 + y2) / 2 / h} {(x2 - x1) / w} {(y2 - y1) / h}\n")
        with open(osp.join(output_dir, stem + ".txt"), "w") as fh:
            fh.writelines(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    for c in ("labelme2seg", "labelme2det"):
        s = sub.add_parser(c)
        s.add_argument("input_dir")
        s.add_argument("output_dir")
        s.add_argument("--labels", required=True)
    s = sub.add_parser("voc2yolo")
    s.add_argument("xml_dir")
    s.add_argument("output_dir")
    s.add_argument("--names", nargs="+", required=True)
    s = sub.add_parser("coco2yolo")
    s.add_argument("json_file")
    s.add_argument("output_dir")
    s = sub.add_parser("kitti2yolo")
    s.add_argument("label_dir")
    s.add_argument("output_dir")
    s.add_argument("--names", nargs="+", required=True)
    s.add_argument("--img-dir")
    a = ap.parse_args(argv)
    if a.cmd == "labelme2seg":
        labelme2seg(a.input_dir, a.output_dir, a.labels)
    elif a.cmd == "labelme2det":
        labelme2det(a.input_dir, a.output_dir, a.labels)
    elif a.cmd == "voc2yolo":
        voc2yolo(a.xml_dir, a.output_dir, a.names)
    elif a.cmd == "coco2yolo":
        coco2yolo(a.json_file, a.output_dir)
    elif a.cmd == "kitti2yolo":
        kitti2yolo(a.label_dir, a.output_dir, a.names, a.img_dir)


if __name__ == "__main__":
    main()
