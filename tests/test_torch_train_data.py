"""The port's training loaders (multiyolov5_tpu_torch/data/detection.py and
data/segmentation.py in training mode, data/augment.py, data/pil_ops.py)
against the JAX package's, on the CPU, and the cv2 / Pillow calls they
replace against those libraries.

Trees: seeded PNG frames under ``tmp_path`` written with the port's codec,
64-160 px (the TINY scale): a detection split of 10 frames in four sizes
(shrinks and a grow at ``img_size`` 96) with 1-5 labels each, one label
file empty; a Cityscapes-layout seg split of 4 frames with labelId masks
and a custom one of 3 frames with trainId masks.

* Detection items: the JAX ``ds[i]`` after ``random.seed(s);
  np.random.seed(s)`` against the port's ``item(i, random.Random(s),
  np.random.RandomState(s))``, for mosaic 1 / 0, mixup 0 / 0.5,
  perspective 0 / 1e-3, rect, flipud and fliplr: the images equal (no
  bound: the warps and the colour conversions are cv2's own arithmetic),
  the labels equal to 1e-6.
* ``random_perspective``, ``augment_hsv`` and ``_quad`` alone; the warps
  against cv2 at random maps, the HSV conversions on every 8-bit colour,
  Pillow's blend, L, HSV and NEAREST on every input or at random sizes:
  all equal.
* The loader: the batch plan equals the JAX loader's for each seed and
  epoch, with image weights, rect and quad; a batch is bitwise the same
  with 1 and 3 workers.
* Seg items: modes ``train`` and ``val`` for citys and custom, the JAX
  item after ``random.seed(s)`` against the port's with
  ``random.Random(s)``: the images equal (float32 of equal uint8), the
  masks exactly.
* autoanchor: ``kmean_anchors`` and ``check_anchors`` give the JAX
  anchors on the same labels and seed, to 1e-5.
"""

import random

import cv2
import numpy as np
import pytest
from PIL import Image, ImageEnhance

from multiyolov5_tpu.data import detection as jax_det
from multiyolov5_tpu.data import segmentation as jax_seg
from multiyolov5_tpu.utils import autoanchor as jax_aa
from multiyolov5_tpu_torch.data import augment as A
from multiyolov5_tpu_torch.data import detection as port_det
from multiyolov5_tpu_torch.data import pil_ops as P
from multiyolov5_tpu_torch.data import png
from multiyolov5_tpu_torch.data import segmentation as port_seg
from multiyolov5_tpu_torch.data.hyps import load_hyp
from multiyolov5_tpu_torch.utils import autoanchor as port_aa

from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

DET_HW = [(80, 160)] * 4 + [(150, 100), (64, 64), (120, 160), (72, 96), (96, 144), (100, 70)]
IMG = 96
LABEL_TOL = 1e-6


def _frame(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 2 + yy, yy * 3, (xx + yy) // 2], -1)
    return ((base + rng.randint(0, 60, (h, w, 3))) % 256).astype(np.uint8)


@pytest.fixture(scope="module")
def det_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    rng = np.random.RandomState(0)
    img_dir, lbl_dir = root / "images" / "train", root / "labels" / "train"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(DET_HW):
        png.imwrite(str(img_dir / f"f{i:02d}.png"), _frame(rng, h, w))
        with open(lbl_dir / f"f{i:02d}.txt", "w") as fh:
            if i == 2:
                continue                                # an empty label file
            n = rng.randint(1, 6)
            xy = rng.rand(n, 2) * 0.6 + 0.2
            wh = rng.rand(n, 2) * 0.35 + 0.1
            for row in np.concatenate([rng.randint(0, 3, (n, 1)), xy, wh], 1):
                fh.write("%d %.6f %.6f %.6f %.6f\n" % tuple(row))
    return str(img_dir)


def _hyp(**over):
    hyp = load_hyp("scratch")
    hyp.update(over)
    return hyp


DET_CASES = {
    "mosaic": dict(),
    "mosaic_mixup_perspective_flipud": dict(mixup=0.5, perspective=1e-3, flipud=0.5,
                                            degrees=5.0, shear=2.0),
    "no_mosaic": dict(mosaic=0.0, fliplr=1.0),
    "no_mosaic_perspective": dict(mosaic=0.0, perspective=1e-3, degrees=10.0),
}


def _close_item(got, want, what):
    assert got[0].shape == want[0].shape, what
    assert np.array_equal(got[0], want[0]), f"{what}: {(got[0] != want[0]).sum()} values differ"
    assert got[1].shape == want[1].shape, what
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=LABEL_TOL, err_msg=what)
    assert got[2] == want[2] and got[3] == want[3], what


@pytest.mark.parametrize("case", sorted(DET_CASES) + ["rect"])
def test_detection_item_matches_jax(det_tree, case):
    hyp = _hyp(**DET_CASES.get(case, dict(flipud=0.5)))
    kw = dict(img_size=IMG, batch_size=4, augment=True, hyp=hyp, rect=case == "rect",
              stride=32)
    jds = jax_det.DetectionDataset(det_tree, **kw)
    pds = port_det.DetectionDataset(det_tree, **kw)
    for i in range(len(pds)):
        s = 1000 + 7 * i
        random.seed(s)
        np.random.seed(s)
        want = jds[i]
        got = pds.item(i, random.Random(s), np.random.RandomState(s))
        _close_item(got, want, f"{case} item {i}")


def test_cached_images_and_image_weights_match_jax(det_tree):
    """The RAM cache and the image-weighted ``indices`` give the same items."""
    kw = dict(img_size=IMG, batch_size=4, augment=True, hyp=_hyp(mixup=0.3),
              image_weights=True, cache_images=True)
    jds = jax_det.DetectionDataset(det_tree, **kw)
    pds = port_det.DetectionDataset(det_tree, **kw)
    assert not pds.rect and pds.mosaic
    w = np.random.RandomState(1).rand(len(pds)) + 0.1
    jl = jax_det.DetectionLoader(jds, 4, shuffle=True, seed=3)
    pl = port_det.DetectionLoader(pds, 4, shuffle=True, seed=3)
    jl.set_image_weights(w)
    pl.set_image_weights(w)
    assert [int(i) for i in pds.indices] == [int(i) for i in jds.indices]
    for i in range(len(pds)):
        random.seed(i)
        np.random.seed(i)
        want = jds[i]
        _close_item(pds.item(i, random.Random(i), np.random.RandomState(i)), want, f"item {i}")


def test_random_perspective_and_hsv_alone_match_jax():
    rng = np.random.RandomState(5)
    img = _frame(rng, 120, 90)
    targets = np.array([[0, 10, 12, 50, 70], [1, 40, 30, 85, 110], [2, 0, 0, 3, 3]],
                       np.float64)
    for persp, border in ((0.0, (0, 0)), (5e-4, (-30, -20)), (0.0, (-30, -30))):
        kw = dict(degrees=8, translate=0.2, scale=0.4, shear=3, perspective=persp,
                  border=border)
        random.seed(9)
        want = jax_det.random_perspective(img.copy(), targets.copy(), **kw)
        got = A.random_perspective(img.copy(), targets.copy(), random.Random(9), **kw)
        assert np.array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=LABEL_TOL)
    a, b = img.copy(), img.copy()
    np.random.seed(4)
    jax_det.augment_hsv(a, 0.1, 0.7, 0.4)
    A.augment_hsv(b, np.random.RandomState(4), 0.1, 0.7, 0.4)
    assert np.array_equal(a, b)


def test_warps_and_colour_conversions_equal_cv2():
    rng = np.random.RandomState(6)
    for t in range(12):
        h0, w0 = (int(v) for v in rng.randint(20, 200, 2))
        w, h = (int(v) for v in rng.randint(10, 200, 2))
        img = (rng.rand(h0, w0, 3) * 255).astype(np.uint8)
        m = np.eye(3)
        m[:2] = A.rotation_matrix_2d(rng.uniform(-20, 20), rng.uniform(0.5, 1.5))
        m[:2, 2] = rng.uniform(-w0 / 2, w0, 2)
        m[0, 1] += rng.uniform(-0.1, 0.1)
        if t % 2:
            m[2, :2] = rng.uniform(-1e-3, 1e-3, 2)
            want = cv2.warpPerspective(img, m, dsize=(w, h), borderValue=(114, 114, 114))
            got = A.warp_perspective(img, m, (w, h))
        else:
            want = cv2.warpAffine(img, m[:2], dsize=(w, h), borderValue=(114, 114, 114))
            got = A.warp_affine(img, m[:2], (w, h))
        assert np.array_equal(got, want), t
    ang, sc = rng.uniform(-30, 30), rng.uniform(0.5, 1.5)
    np.testing.assert_array_equal(A.rotation_matrix_2d(ang, sc),
                                  cv2.getRotationMatrix2D(angle=ang, center=(0, 0), scale=sc))
    v = np.arange(256, dtype=np.uint8)
    every = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    import torch
    assert np.array_equal(A.bgr2hsv(torch.from_numpy(every)).numpy(),
                          cv2.cvtColor(every, cv2.COLOR_BGR2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180, dtype=np.uint8), v, v, indexing="ij"),
                   -1).reshape(-1, 3)
    for width in (1, 45, 256):           # the vector loop, its tail, both
        x = hsv[:len(hsv) // width * width].reshape(-1, width, 3)
        assert np.array_equal(A.hsv2bgr(torch.from_numpy(x)).numpy(),
                              cv2.cvtColor(x, cv2.COLOR_HSV2BGR)), width


def test_pillow_ops_equal_pillow():
    v = np.arange(256, dtype=np.uint8)
    every = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    assert np.array_equal(P.rgb2hsv(every), np.asarray(Image.fromarray(every).convert("HSV")))
    assert np.array_equal(P.hsv2rgb(every),
                          np.asarray(Image.fromarray(every, "HSV").convert("RGB")))
    assert np.array_equal(P.to_l(every), np.asarray(Image.fromarray(every).convert("L")))
    a = np.stack([np.repeat(v[:, None], 256, 1)] * 3, -1)
    b = a.transpose(1, 0, 2).copy()
    rng = np.random.RandomState(7)
    for alpha in list(rng.uniform(0, 2, 8)) + [0.0, 1.0, 0.55]:
        assert np.array_equal(P.blend(a, b, alpha),
                              np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b),
                                                     alpha)))
    img = _frame(rng, 37, 53)
    im = Image.fromarray(img)
    for f in (0.55, 1.3):
        for ours, theirs in ((P.brightness, ImageEnhance.Brightness),
                             (P.contrast, ImageEnhance.Contrast), (P.color, ImageEnhance.Color)):
            assert np.array_equal(ours(img, f), np.asarray(theirs(im).enhance(f)))
    for _ in range(40):
        h0, w0, h, w = (int(x) for x in rng.randint(1, 300, 4))
        m = (rng.rand(h0, w0) * 255).astype(np.uint8)
        assert np.array_equal(P.resize_nearest(m, (w, h)),
                              np.asarray(Image.fromarray(m).resize((w, h), Image.NEAREST)))


@pytest.mark.parametrize("image_weights", [False, True])
def test_loader_plan_matches_jax(det_tree, image_weights):
    kw = dict(img_size=IMG, batch_size=4, augment=True, hyp=_hyp(),
              image_weights=image_weights)
    jds = jax_det.DetectionDataset(det_tree, **kw)
    pds = port_det.DetectionDataset(det_tree, **kw)
    w = np.random.RandomState(2).rand(len(pds)) + 0.05
    for seed in (0, 5):
        jl = jax_det.DetectionLoader(jds, 4, shuffle=True, seed=seed, quad=True)
        pl = port_det.DetectionLoader(pds, 4, shuffle=True, seed=seed, quad=True)
        for epoch in range(3):
            if image_weights:
                jl.set_image_weights(w)
                pl.set_image_weights(w)
                assert [int(i) for i in pds.indices] == [int(i) for i in jds.indices]
            assert [b.tolist() for b in pl._plan()] == [b.tolist() for b in jl._plan()]
            jl.epoch += 1
            pl.epoch += 1
    rect = dict(kw, image_weights=False, rect=True)
    jl = jax_det.DetectionLoader(jax_det.DetectionDataset(det_tree, **rect), 4, shuffle=True)
    pl = port_det.DetectionLoader(port_det.DetectionDataset(det_tree, **rect), 4, shuffle=True)
    assert [b.tolist() for b in pl._plan()] == [b.tolist() for b in jl._plan()]
    assert not pl.shuffle


def test_quad_matches_jax():
    rng = np.random.RandomState(8)
    items = [(_frame(rng, 48, 64), np.array([[1, 0.5, 0.5, 0.2, 0.3]], np.float32) + k,
              f"p{k}", None) for k in range(8)]
    loader = jax_det.DetectionLoader.__new__(jax_det.DetectionLoader)
    random.seed(3)
    want = loader._quad(items)
    got = port_det.DetectionLoader._quad(items, random.Random(3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.array_equal(g[0], w[0])
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=LABEL_TOL)


def test_loader_batches_do_not_depend_on_workers(det_tree):
    kw = dict(img_size=IMG, batch_size=4, augment=True, hyp=_hyp(mixup=0.5))
    pds = port_det.DetectionDataset(det_tree, **kw)
    runs = []
    for workers in (1, 3):
        pl = port_det.DetectionLoader(pds, 4, shuffle=True, seed=1, workers=workers, quad=True)
        runs.append([b for _ in range(2) for b in pl])
    assert len(runs[0]) == 4
    for a, b in zip(*runs):
        assert all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
        lab = a[1][a[2]]
        assert (lab[:, 1:] >= 0).all() and (lab[:, 1:] <= 1).all()
        assert (lab[:, 3:] > 0).all()


@pytest.fixture(scope="module")
def seg_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    rng = np.random.RandomState(1)
    for split in ("train", "val"):
        idir = root / "citys" / "leftImg8bit" / split / "aachen"
        mdir = root / "citys" / "gtFine" / split / "aachen"
        idir.mkdir(parents=True)
        mdir.mkdir(parents=True)
        for i in range(4):
            h, w = (96, 160) if i % 2 else (80, 128)
            png.imwrite(str(idir / f"a_{i}_leftImg8bit.png"), _frame(rng, h, w))
            ids = rng.randint(0, 34, (h, w)).astype(np.uint8)
            ids[rng.rand(h, w) < 0.05] = 255
            png.imwrite(str(mdir / f"a_{i}_gtFine_labelIds.png"), ids)
        idir = root / "custom" / "segimages" / split
        mdir = root / "custom" / "seglabels" / split
        idir.mkdir(parents=True)
        mdir.mkdir(parents=True)
        for i in range(3):
            png.imwrite(str(idir / f"c{i}.png"), _frame(rng, 72, 100))
            lab = rng.randint(0, 3, (72, 100)).astype(np.uint8)
            lab[rng.rand(72, 100) < 0.05] = 255
            png.imwrite(str(mdir / f"c{i}.png"), lab)
    return root


@pytest.mark.parametrize("kind,mode", [("citys", "train"), ("citys", "val"),
                                       ("custom", "train"), ("custom", "val")])
def test_seg_item_matches_jax(seg_tree, kind, mode):
    if kind == "citys":
        kw = dict(root=str(seg_tree / "citys"), split=mode, mode=mode, base_size=128,
                  crop_size=(128, 64), batch_size=2, workers=1)
        jl, pl = jax_seg.get_citys_loader(**kw), port_seg.get_citys_loader(**kw)
    else:
        kw = dict(root=str(seg_tree / "custom"), split=mode, mode=mode, base_size=96,
                  batch_size=1, workers=1, n_segcls=3)
        jl, pl = jax_seg.get_custom_loader(**kw), port_seg.get_custom_loader(**kw)
    jds, pds = jl.ds, pl.ds
    for i in range(len(pds)):
        for s in (11 * i, 11 * i + 5):
            random.seed(s)
            want = jds[i]
            got = pds.item(i, random.Random(s) if mode == "train" else None)
            assert got[0].dtype == np.float32 and np.array_equal(got[0], want[0]), (i, s)
            assert np.array_equal(np.asarray(got[1]), np.asarray(want[1])), (i, s)
    assert [b.tolist() for b in pl._plan()] == [b.tolist() for b in jl._plan()]


def test_seg_loader_batches_do_not_depend_on_workers(seg_tree):
    kw = dict(root=str(seg_tree / "citys"), split="train", mode="train", base_size=128,
              crop_size=(128, 64), batch_size=2, seed=4)
    runs = [[b for _ in range(2) for b in port_seg.get_citys_loader(workers=w, **kw)]
            for w in (1, 2)]
    assert len(runs[0]) == 4
    for a, b in zip(*runs):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[0].shape == (2, 64, 128, 3)


def test_autoanchor_matches_jax(det_tree):
    class Spec:
        def __init__(self):
            self.anchors = [[40, 50, 60, 70, 80, 90], [100, 110, 120, 130, 140, 150],
                            [160, 170, 180, 190, 200, 210]]
            self.nl, self.strides = 3, [8, 16, 32]

    jds = jax_det.DetectionDataset(det_tree, img_size=IMG)
    pds = port_det.DetectionDataset(det_tree, img_size=IMG)
    np.random.seed(3)
    want = jax_aa.kmean_anchors(jds, n=9, img_size=IMG, gen=200, verbose=False)
    got = port_aa.kmean_anchors(pds, np.random.RandomState(3), n=9, img_size=IMG, gen=200,
                                verbose=False)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    js, ps = Spec(), Spec()
    np.random.seed(4)
    jax_aa.check_anchors(jds, js, thr=4.0, imgsz=IMG)
    port_aa.check_anchors(pds, ps, np.random.RandomState(4), thr=4.0, imgsz=IMG)
    assert js.anchors != Spec().anchors            # these anchors fail the BPR gate
    np.testing.assert_allclose(np.asarray(ps.anchors), np.asarray(js.anchors), rtol=1e-5)
    a = np.arange(18, dtype=np.float32).reshape(3, 3, 2)[::-1].copy()
    np.testing.assert_array_equal(port_aa.check_anchor_order(a, [8, 16, 32]),
                                  jax_aa.check_anchor_order(a, [8, 16, 32]))
