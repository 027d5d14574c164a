"""The port's host tools against the JAX package's, on the CPU.

* ``tools/cityscapes2yolo.py``: both ``main``s on copies of one seeded
  gtFine/leftImg8bit tree (2 splits, 2 cities each, PNG frames, polygons of
  the 10 detection classes and of others): the output trees (labels, copied
  images, file lists, classes.txt) and the printed lines byte-equal.
* ``tools/labelme_convert.py``: the five subcommands through both ``main``s
  on one seeded input: labelme files with an embedded PNG (``imageData``)
  and with an ``imagePath`` to an RGBA PNG, shapes that are concave,
  self-intersecting, partly off the image, rectangles with their corners in
  every order, circles, an ``__ignore__`` label and an unknown one; VOC
  xml, COCO json and KITTI txt with PNG and JPEG (baseline and progressive)
  images.  Masks pixel-equal, labels, lists and class names byte-equal;
  each image the port writes has the JAX tool's name (``.jpg``) and bytes
  and decodes (in cv2) to the same pixels.  A JPEG ``imageData`` or
  ``imagePath`` is read as the JAX tool reads it; a ``.dng`` raises
  ``NotImplementedError``.
* ``data/draw.py`` against Pillow (12.1) directly: 300 seeded polygons
  (float and integer vertices, convex, concave, self-intersecting, off the
  image, 2 to 12 vertices, one in four passing through a vertex twice),
  300 with vertices repeated one after the other (dense float outlines
  whose vertices truncate to one pixel, integer ones given twice), 200
  rectangles and 200 circles: equal masks.
"""

import base64
import contextlib
import io
import json
import os
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image, ImageDraw

from multiyolov5_tpu.tools import cityscapes2yolo as jax_c2y
from multiyolov5_tpu.tools import labelme_convert as jax_lc
from multiyolov5_tpu_torch.data import draw, png
from multiyolov5_tpu_torch.tools import cityscapes2yolo as c2y
from multiyolov5_tpu_torch.tools import labelme_convert as lc
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

LABELS = ["__ignore__", "_background_", "car", "person", "road"]


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _polygon(rng, w, h, n=None):
    n = n or rng.randint(3, 9)
    return [[float(rng.uniform(-0.2 * w, 1.2 * w)), float(rng.uniform(-0.2 * h, 1.2 * h))]
            for _ in range(n)]


def test_cityscapes2yolo_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    src = tmp_path / "src"
    names = list(c2y.LABEL_MAP) + ["road", "sky", "building"]
    for split in ("train", "val"):
        for city in ("aachen", "bremen"):
            (src / "leftImg8bit" / split / city).mkdir(parents=True)
            (src / "gtFine" / split / city).mkdir(parents=True)
            for i in range(2):
                stem = f"{city}_{i:06d}_000019"
                png.imwrite(str(src / "leftImg8bit" / split / city / f"{stem}_leftImg8bit.png"),
                            rng.randint(0, 256, (32, 64, 3)).astype(np.uint8))
                objs = [{"label": names[rng.randint(len(names))],
                         "polygon": [[int(v) for v in p] for p in _polygon(rng, 2048, 1024)]}
                        for _ in range(rng.randint(0, 7))]
                with open(src / "gtFine" / split / city / f"{stem}_gtFine_polygons.json",
                          "w") as fh:
                    json.dump({"imgWidth": 2048, "imgHeight": 1024, "objects": objs}, fh)
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    for r in roots.values():
        shutil.copytree(src, r)
    out_j = _run(jax_c2y.main, ["--root", roots["jax"]])
    out_p = _run(c2y.main, ["--root", roots["port"]])
    assert out_j == out_p
    tj, tp = _tree_files(roots["jax"]), _tree_files(roots["port"])
    assert sorted(tj) == sorted(tp) and "labels/classes.txt" in tj and "yolo_val.txt" in tj
    for k in tj:
        assert tj[k] == tp[k], k
    assert any(tj[k] for k in tj if k.startswith("labels/train/"))


def _labelme_input(root):
    """Three labelme files (embedded PNG, imagePath to an RGBA PNG, no
    shapes) and the VOC / COCO / KITTI inputs, seeded."""
    rng = np.random.RandomState(1)
    lm = root / "labelme"
    lm.mkdir()
    (root / "labels.txt").write_text("\n".join(LABELS) + "\n")
    rgb = rng.randint(0, 256, (60, 90, 3)).astype(np.uint8)
    rgba = rng.randint(0, 256, (48, 70, 4)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    Image.fromarray(rgba).save(lm / "b.png")
    w, h = 90, 60
    shapes_a = [
        {"label": "car", "points": [[10, 5], [40, 8], [25, 20], [45, 40], [8, 35]]},  # concave
        {"label": "person", "points": [[50, 5], [85, 45], [85, 5], [50, 45]]},  # crossing
        {"label": "road", "points": [[-10.5, 40.2], [30.7, 70.9], [70.2, 50.5]]},  # off image
        {"label": "car", "points": [[60.7, 50.2], [20.3, 30.9]], "shape_type": "rectangle"},
        {"label": "person", "points": [[30, 30], [38.5, 34.2]], "shape_type": "circle"},
        {"label": "__ignore__", "points": [[0, 0], [12, 0], [6, 9]]},
        {"label": "unknown", "points": [[70, 20], [88, 22], [80, 30]]},
    ]
    shapes_b = [{"label": LABELS[2 + k % 3], "points": _polygon(rng, 70, 48)} for k in range(4)]
    shapes_b += [{"label": "road", "points": [[65, 5], [5, 40]], "shape_type": "rectangle"},
                 {"label": "car", "points": [[5, 40], [65, 5]], "shape_type": "rectangle"},
                 {"label": "car", "points": [[68, 2], [60, 30]], "shape_type": "circle"}]
    with open(lm / "a.json", "w") as fh:
        json.dump({"imageData": base64.b64encode(buf.getvalue()).decode(), "shapes": shapes_a,
                   "imagePath": "a.jpg", "imageHeight": h, "imageWidth": w}, fh)
    with open(lm / "b.json", "w") as fh:
        json.dump({"imageData": None, "imagePath": "b.png", "shapes": shapes_b}, fh)
    with open(lm / "c.json", "w") as fh:
        json.dump({"imageData": None, "imagePath": "b.png", "shapes": []}, fh)
    sources = {"a": rgb, "b": rgba[..., :3], "c": rgba[..., :3]}

    voc = root / "voc"
    voc.mkdir()
    for i in range(2):
        objs = "".join(
            f"<object><name>{['car', 'person', 'dog'][rng.randint(3)]}</name><bndbox>"
            f"<xmin>{rng.randint(0, 50)}</xmin><ymin>{rng.randint(0, 40)}</ymin>"
            f"<xmax>{rng.randint(60, 200)}</xmax><ymax>{rng.randint(50, 120)}</ymax>"
            f"</bndbox></object>" for _ in range(3))
        (voc / f"v{i}.xml").write_text(f"<annotation><size><width>200</width><height>120"
                                       f"</height></size>{objs}</annotation>")
    coco = {"categories": [{"id": 7, "name": "b"}, {"id": 3, "name": "a"}],
            "images": [{"id": 1, "file_name": "one.jpg", "width": 640, "height": 480},
                       {"id": 2, "file_name": "two.png", "width": 300, "height": 200}],
            "annotations": [{"image_id": 1 + k % 2, "category_id": (3, 7)[k % 2],
                             "bbox": [float(v) for v in rng.rand(4) * 100]} for k in range(5)]}
    with open(root / "coco.json", "w") as fh:
        json.dump(coco, fh)
    kitti, kimg = root / "kitti", root / "kitti_img"
    kitti.mkdir()
    kimg.mkdir()
    Image.fromarray(rng.randint(0, 256, (37, 121, 3)).astype(np.uint8)).save(kimg / "k0.png")
    Image.fromarray(rng.randint(0, 256, (45, 77, 3)).astype(np.uint8)).save(kimg / "k1.jpg")
    Image.fromarray(rng.randint(0, 256, (33, 50, 3)).astype(np.uint8)).save(
        kimg / "k2.jpg", progressive=True)
    for i in range(3):
        rows = [f"{['Car', 'Pedestrian', 'Tram'][rng.randint(3)]} 0 0 0 "
                + " ".join(f"{v:.2f}" for v in rng.rand(4) * 30) + " 1 1 1 1 1 1 1"
                for _ in range(3)]
        (kitti / f"k{i}.txt").write_text("\n".join(rows) + "\n")
    return sources


def test_labelme_convert_matches_jax(tmp_path):
    src = _labelme_input(tmp_path)
    labels, lm = str(tmp_path / "labels.txt"), str(tmp_path / "labelme")
    for pkg, main in (("jax", jax_lc.main), ("port", lc.main)):
        out = str(tmp_path / pkg)
        logs = [_run(main, ["labelme2seg", lm, out + "/seg", "--labels", labels]),
                _run(main, ["labelme2det", lm, out + "/det", "--labels", labels])]
        _run(main, ["voc2yolo", str(tmp_path / "voc"), out + "/voc", "--names", "car", "person"])
        _run(main, ["coco2yolo", str(tmp_path / "coco.json"), out + "/coco"])
        _run(main, ["kitti2yolo", str(tmp_path / "kitti"), out + "/kitti", "--names", "Car",
                    "Pedestrian", "--img-dir", str(tmp_path / "kitti_img")])
        if pkg == "jax":
            want_logs = logs
    assert logs == want_logs
    tj, tp = _tree_files(tmp_path / "jax"), _tree_files(tmp_path / "port")
    text = [k for k in tj if k.endswith(".txt")]
    assert len(text) == 1 + 3 + 2 + 2 + 3   # class names, det labels, voc, coco, kitti
    for k in text:
        assert tp[k] == tj[k], k
    for stem, rgb in src.items():
        want = np.asarray(Image.open(tmp_path / "jax" / "seg" / "SegmentationClassPNG"
                                     / f"{stem}.png"))
        got = png.read_samples(str(tmp_path / "port" / "seg" / "SegmentationClassPNG"
                                   / f"{stem}.png"))
        assert got.dtype == np.uint8 and np.array_equal(got, want), stem
        for folder in ("seg/JPEGImages", "det/images"):
            k = f"{folder}/{stem}.jpg"
            assert k in tj and k in tp and tp[k] == tj[k], k
            got = cv2.imdecode(np.frombuffer(tp[k], np.uint8), cv2.IMREAD_COLOR)
            want = cv2.imdecode(np.frombuffer(tj[k], np.uint8), cv2.IMREAD_COLOR)
            assert got.shape == rgb.shape and np.array_equal(got, want), k
    assert sorted(tp) == sorted(tj)
    seg_a = png.read_samples(str(tmp_path / "port" / "seg" / "SegmentationClassPNG" / "a.png"))
    assert set(np.unique(seg_a)) == {0, 1, 2, 3, 255}


def test_non_png_images_raise(tmp_path):
    """A JPEG ``imageData`` (EXIF orientation 6, not applied) and a JPEG
    ``imagePath`` give the JAX tool's output; a ``.dng`` ``imagePath``
    raises, naming it; JPEG sizes come from the frame header."""
    rng = np.random.RandomState(5)
    buf = io.BytesIO()
    exif = Image.Exif()
    exif[274] = 6
    Image.fromarray(rng.randint(0, 256, (24, 40, 3)).astype(np.uint8)).save(
        buf, format="JPEG", exif=exif.tobytes())
    (tmp_path / "in").mkdir()
    (tmp_path / "labels.txt").write_text("\n".join(LABELS))
    shapes = [{"label": "car", "points": [[2, 3], [30, 5], [12, 20]]}]
    with open(tmp_path / "in" / "j.json", "w") as fh:
        json.dump({"imageData": base64.b64encode(buf.getvalue()).decode(), "shapes": shapes}, fh)
    Image.fromarray(rng.randint(0, 256, (30, 20, 3)).astype(np.uint8)).save(
        tmp_path / "in" / "p.jpg", progressive=True)
    with open(tmp_path / "in" / "k.json", "w") as fh:
        json.dump({"imageData": None, "imagePath": "p.jpg", "shapes": shapes}, fh)
    for pkg, mod in (("jax", jax_lc), ("port", lc)):
        with contextlib.redirect_stdout(io.StringIO()):
            mod.labelme2seg(str(tmp_path / "in"), str(tmp_path / pkg / "seg"),
                            str(tmp_path / "labels.txt"))
            mod.labelme2det(str(tmp_path / "in"), str(tmp_path / pkg / "det"),
                            str(tmp_path / "labels.txt"))
    tj, tp = _tree_files(tmp_path / "jax"), _tree_files(tmp_path / "port")
    assert sorted(tp) == sorted(tj) and "seg/JPEGImages/j.jpg" in tp
    for k in tj:                       # images and labels byte-equal, masks pixel-equal
        if k.endswith(".png"):
            assert np.array_equal(png.read_samples(str(tmp_path / "port" / k)),
                                  np.asarray(Image.open(tmp_path / "jax" / k))), k
        else:
            assert tp[k] == tj[k], k
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "in" / "b.png")
    os.rename(tmp_path / "in" / "b.png", tmp_path / "in" / "b.dng")
    with open(tmp_path / "in" / "k.json", "w") as fh:
        json.dump({"imageData": None, "imagePath": "b.dng", "shapes": []}, fh)
    with pytest.raises(NotImplementedError, match="b.dng"):
        lc.labelme2det(str(tmp_path / "in"), str(tmp_path / "out"), str(tmp_path / "labels.txt"))
    for progressive in (False, True):
        Image.fromarray(np.zeros((29, 53, 3), np.uint8)).save(tmp_path / "s.jpg",
                                                              progressive=progressive)
        assert lc.image_size(str(tmp_path / "s.jpg")) == Image.open(tmp_path / "s.jpg").size


def _pillow(hw, kind, xy):
    im = Image.new("L", (hw[1], hw[0]), 0)
    d = ImageDraw.Draw(im)
    if kind == "polygon":
        d.polygon([tuple(p) for p in xy], outline=1, fill=1)
    else:
        getattr(d, kind)(xy, fill=1)
    return np.asarray(im, bool)


def _shapes(n_poly=300, n_box=200):
    """Seeded shapes: (hw, kind, coordinates).  "polygon": one in three
    with integer vertices, and one in four passing through one of its
    vertices again further on; "polygon-dup": dense float outlines around
    a centre with vertices that truncate to the same pixel one after the
    other, and integer polygons with a vertex given twice in a row."""
    rng = np.random.RandomState(2)
    out = []
    for i in range(n_poly):
        hw = tuple(int(v) for v in rng.randint(8, 90, 2))
        n = int(rng.randint(2, 13))
        pts = _polygon(rng, hw[1], hw[0], n)
        if i % 3 == 0:                              # integer vertices
            pts = [[int(round(x)), int(round(y))] for x, y in pts]
        if i % 4 == 0 and n >= 3:                   # a vertex passed twice
            a = int(rng.randint(n - 2))
            pts.insert(int(rng.randint(a + 2, n + 1)), list(pts[a]))
        out.append((hw, "polygon", pts))
    for i in range(n_poly):
        hw = tuple(int(v) for v in rng.randint(8, 90, 2))
        if i % 2:
            n = int(rng.randint(5, 40))
            c, r = rng.uniform(0, hw[::-1]), rng.uniform(1, 0.6 * max(hw), n)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            pts = [[float(c[0] + r[k] * np.cos(ang[k])), float(c[1] + r[k] * np.sin(ang[k]))]
                   for k in range(n)]
            pts = [q for p in pts for q in (p, [p[0] + 0.25, p[1] + 0.25])]
        else:
            pts = [[int(round(x)), int(round(y))]
                   for x, y in _polygon(rng, hw[1], hw[0], int(rng.randint(3, 10)))]
            k = int(rng.randint(len(pts)))
            pts.insert(k, list(pts[k]))
        out.append((hw, "polygon-dup", pts))
    for kind in ("rectangle", "ellipse"):
        for _ in range(n_box):
            hw = tuple(int(v) for v in rng.randint(4, 90, 2))
            if kind == "rectangle":
                x = sorted(rng.uniform(-10, hw[1] + 10, 2))
                y = sorted(rng.uniform(-10, hw[0] + 10, 2))
                out.append((hw, kind, [x[0], y[0], x[1], y[1]]))
            else:
                c, p = rng.uniform(-10, max(hw) + 10, 2), rng.uniform(-10, max(hw) + 10, 2)
                r = float(np.hypot(*(c - p))) * rng.uniform(0, 0.6)
                out.append((hw, kind, [c[0] - r, c[1] - r, c[0] + r, c[1] + r]))
    return out


@pytest.mark.parametrize("kind", ["polygon", "rectangle", "ellipse", "polygon-dup"])
def test_fill_equals_pillow(kind):
    cases = [c for c in _shapes() if c[1] == kind]
    assert len(cases) >= 200
    for i, (hw, k, xy) in enumerate(cases):
        k = k.split("-")[0]
        got = getattr(draw, k)(hw, xy)
        want = _pillow(hw, k, xy)
        assert np.array_equal(got, want), (i, hw, xy, int((got != want).sum()))
    with pytest.raises(TypeError):
        draw.polygon((8, 8), [(1, 1)])
