"""The port's eval loaders (multiyolov5_tpu_torch/data/detection.py and
data/segmentation.py) against the JAX package's, on the CPU.

Each test builds small seeded PNG trees under ``tmp_path`` with the
port's codec:

* detection: ``images/val`` + ``labels/val`` of 11 frames at 256x128 (a
  shrink by 2 at ``img_size`` 128: cv2's ``INTER_AREA`` integer path),
  300x150 (a fractional shrink), 100x60 (a grow: ``INTER_LINEAR``) and
  two portrait 120x200 frames (a second rect bin); one label file
  missing, one empty, one of polygon rows; a ``.txt`` list of ``./``
  entries beside it.
* segmentation: the ``citys`` layout (``leftImg8bit/val/<city>``,
  ``gtFine/val/<city>`` labelIds with 255s), read by the citys and the
  citysbdd loaders; the ``custom`` layout (``segimages``/``seglabels``)
  with a palette mask among gray ones.

The port must give the JAX loaders' ``img_files``, ``labels``, ``shapes``
and ``batch_shapes``, and every batch (images, targets, mask, paths,
``shapes``; seg images float32 and masks) exactly.  A ``.jpg`` in a
detection split (one with EXIF orientation 6) and a BDD-style ``.jpg``
frame in a citysbdd split are read as the JAX loaders read them; a
``.dng`` raises ``NotImplementedError`` up front; the training modes and
options build (tests/test_torch_train_data.py holds them).
"""

import os

import numpy as np
import pytest
from PIL import Image

from multiyolov5_tpu.data import detection as jax_det
from multiyolov5_tpu.data import segmentation as jax_seg
from multiyolov5_tpu_torch.data import detection as port_det
from multiyolov5_tpu_torch.data import png
from multiyolov5_tpu_torch.data import segmentation as port_seg
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

# (h, w) of each detection frame: 2:1 frames shrink by 2 at img_size 128,
# 300x150 by 128/300, 100x60 grows; the portrait ones make a second bin
DET_HW = [(128, 256)] * 6 + [(150, 300), (60, 100), (128, 256), (200, 120), (200, 120)]
IMG_SIZE, BS = 128, 4


def _frame(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 2 + yy, yy * 3, (xx + yy) // 2], -1)
    return ((base + rng.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


def _labels(rng, n):
    xy = rng.rand(n, 2) * 0.6 + 0.2
    wh = rng.rand(n, 2) * 0.3 + 0.05
    return np.concatenate([rng.randint(0, 5, (n, 1)), xy, wh], 1)


@pytest.fixture(scope="module")
def det_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    rng = np.random.RandomState(0)
    img_dir, lbl_dir = root / "images" / "val", root / "labels" / "val"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(DET_HW):
        png.imwrite(str(img_dir / f"f{i:02d}.png"), _frame(rng, h, w))
        if i == 3:
            continue                                    # no label file
        with open(lbl_dir / f"f{i:02d}.txt", "w") as fh:
            if i == 4:
                continue                                # an empty one
            if i == 5:                                  # polygon rows -> boxes
                for _ in range(3):
                    pts = rng.rand(6, 2) * 0.8 + 0.1
                    fh.write(" ".join(["2"] + [f"{v:.5f}" for v in pts.ravel()]) + "\n")
                continue
            for row in _labels(rng, rng.randint(1, 6)):
                fh.write("%d %.6f %.6f %.6f %.6f\n" % tuple(row))
    with open(root / "val.txt", "w") as fh:
        fh.write("\n".join(f"./images/val/f{i:02d}.png" for i in range(len(DET_HW))) + "\n")
    return root


def _det_pair(path, **kw):
    jds = jax_det.DetectionDataset(path, img_size=IMG_SIZE, batch_size=BS, rect=True,
                                   stride=32, pad=0.5, **kw)
    pds = port_det.DetectionDataset(path, img_size=IMG_SIZE, batch_size=BS, rect=True,
                                    stride=32, pad=0.5, **kw)
    return jds, pds


def _same_batches(jl, pl):
    jb, pb = list(jl), list(pl)
    assert len(jb) == len(pb) == len(pl)
    for a, b in zip(jb, pb):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y
    return pb


@pytest.mark.parametrize("source,single_cls", [("dir", False), ("txt", False),
                                               ("list", True)])
def test_detection_loader_matches_jax(det_tree, source, single_cls, capsys):
    path = {"dir": str(det_tree / "images" / "val"), "txt": str(det_tree / "val.txt"),
            "list": [str(det_tree / "images" / "val")]}[source]
    jds, pds = _det_pair(path, single_cls=single_cls)
    assert pds.img_files == jds.img_files and len(pds.img_files) == len(DET_HW)
    assert len(pds.labels) == len(jds.labels)
    for a, b in zip(pds.labels, jds.labels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pds.shapes, jds.shapes)
    np.testing.assert_array_equal(pds.batch_shapes, jds.batch_shapes)
    assert len({tuple(s) for s in pds.batch_shapes}) >= 2          # two rect bins
    assert any(len(lb) == 0 for lb in pds.labels)
    if single_cls:
        assert all((lb[:, 0] == 0).all() for lb in pds.labels)
    for workers in (1, 3):
        jl = jax_det.DetectionLoader(jds, BS, max_targets=8, workers=workers,
                                     drop_last=False)
        pl = port_det.DetectionLoader(pds, BS, max_targets=8, workers=workers,
                                      drop_last=False)
        batches = _same_batches(jl, pl)
        assert [b[0].shape[0] for b in batches] == [4, 4, 3]
        assert batches[0][0].dtype == np.uint8


def test_detection_loader_resize_paths_and_cache(det_tree, monkeypatch):
    """The shrink by 2, the fractional shrink and the grow each run; the
    port's label cache is its own file, read back on a second build
    without scanning the labels again."""
    pds = port_det.DetectionDataset(str(det_tree / "images" / "val"), img_size=IMG_SIZE,
                                    batch_size=BS, rect=True, stride=32, pad=0.5)
    hw0 = {pds.load_image(i)[1] for i in range(len(pds))}
    assert {(128, 256), (150, 300), (60, 100)} <= hw0
    cache = det_tree / "labels" / "val.torchcache.npz"
    assert cache.is_file()
    monkeypatch.setattr(port_det.DetectionDataset, "_cache_labels",
                        lambda *a: pytest.fail("the cache was not read"))
    again = port_det.DetectionDataset(str(det_tree / "images" / "val"), img_size=IMG_SIZE,
                                      batch_size=BS, rect=True, stride=32, pad=0.5)
    assert again.img_files == pds.img_files
    for a, b in zip(again.labels, pds.labels):
        np.testing.assert_array_equal(a, b)


def test_detection_loader_shards(det_tree):
    jds, pds = _det_pair(str(det_tree / "images" / "val"))
    for shard in (0, 1):
        jl = jax_det.DetectionLoader(jds, BS, max_targets=8, workers=2, drop_last=False,
                                     shard=shard, num_shards=2)
        pl = port_det.DetectionLoader(pds, BS, max_targets=8, workers=2, drop_last=False,
                                      shard=shard, num_shards=2)
        _same_batches(jl, pl)


def test_detection_loader_square_matches_jax(det_tree):
    """Without rect, every image is letterboxed to img_size x img_size and
    the batches are consecutive, as in the JAX loader."""
    path = str(det_tree / "images" / "val")
    jds = jax_det.DetectionDataset(path, img_size=IMG_SIZE, batch_size=BS)
    pds = port_det.DetectionDataset(path, img_size=IMG_SIZE, batch_size=BS)
    for drop_last in (False, True):
        jl = jax_det.DetectionLoader(jds, BS, max_targets=8, workers=2, drop_last=drop_last)
        pl = port_det.DetectionLoader(pds, BS, max_targets=8, workers=2, drop_last=drop_last)
        batches = _same_batches(jl, pl)
        assert all(b[0].shape[1:3] == (IMG_SIZE, IMG_SIZE) for b in batches)
        assert len(batches) == (2 if drop_last else 3)


def test_detection_training_parts_and_jpeg_raise(det_tree, tmp_path):
    """The training parts build (tests/test_torch_train_data.py holds their
    items): ``augment`` and ``image_weights`` datasets, a quad loader, a
    shuffled rect loader that keeps the bins in order, as the JAX one;
    a quad batch not divisible by 4 and a ``.dng`` in a split raise; a
    ``.jpg`` (EXIF orientation 6: the cache swaps its shape, ``load_image``
    turns it, as in the JAX loader) is read as the JAX loader reads it."""
    path = str(det_tree / "images" / "val")
    for kw in (dict(augment=True), dict(image_weights=True)):
        pds = port_det.DetectionDataset(path, img_size=IMG_SIZE, **kw)
        jds = jax_det.DetectionDataset(path, img_size=IMG_SIZE, **kw)
        assert (pds.mosaic, pds.rect) == (jds.mosaic, jds.rect)
    pds = port_det.DetectionDataset(path, img_size=IMG_SIZE, batch_size=BS, rect=True)
    with pytest.raises(ValueError, match="divisible by 4"):
        port_det.DetectionLoader(pds, 6, quad=True)
    assert port_det.DetectionLoader(pds, 4, quad=True).quad
    shuffled = port_det.DetectionLoader(pds, 4, shuffle=True)
    assert not shuffled.shuffle
    assert [b.tolist() for b in shuffled._plan()] == [
        b.tolist() for b in port_det.DetectionLoader(pds, 4)._plan()]
    d = tmp_path / "images" / "val"
    d.mkdir(parents=True)
    png.imwrite(str(d / "a.png"), _frame(np.random.RandomState(1), 64, 64))
    exif = Image.Exif()
    exif[274] = 6
    Image.fromarray(_frame(np.random.RandomState(2), 48, 80)).save(d / "b.jpg",
                                                                   exif=exif.tobytes())
    jds = jax_det.DetectionDataset(str(d), img_size=IMG_SIZE)
    pds = port_det.DetectionDataset(str(d), img_size=IMG_SIZE)
    assert pds.img_files == jds.img_files and len(pds.img_files) == 2
    np.testing.assert_array_equal(pds.shapes, jds.shapes)
    assert pds.shapes.tolist()[1] == [48, 80]
    for i in range(2):
        for a, b in zip(pds.load_image(i), jds.load_image(i)):
            np.testing.assert_array_equal(a, b)
    assert pds.load_image(1)[1] == (80, 48)
    e = tmp_path / "dng" / "images"
    e.mkdir(parents=True)
    Image.fromarray(_frame(np.random.RandomState(3), 64, 64)).save(e / "c.png")
    os.rename(e / "c.png", e / "c.dng")
    with pytest.raises(NotImplementedError, match="c.dng"):
        port_det.DetectionDataset(str(e), img_size=IMG_SIZE)


def test_detection_drops_what_jax_drops(tmp_path):
    """An image under 10 px, a label file of non-normalised or negative
    values, one of 4 columns: the JAX cache warns and drops each, and so
    does the port's."""
    d, lbl = tmp_path / "images" / "val", tmp_path / "labels" / "val"
    d.mkdir(parents=True)
    lbl.mkdir(parents=True)
    rng = np.random.RandomState(6)
    rows = {"ok": "1 0.5 0.5 0.2 0.2", "big": "1 1.5 0.5 0.2 0.2", "neg": "1 -0.5 0.5 0.2 0.2",
            "four": "1 0.5 0.5 0.2", "tiny": "1 0.5 0.5 0.2 0.2"}
    for name, row in rows.items():
        hw = (8, 8) if name == "tiny" else (64, 96)
        png.imwrite(str(d / f"{name}.png"), _frame(rng, *hw))
        (lbl / f"{name}.txt").write_text(row + "\n")
    jds = jax_det.DetectionDataset(str(d), img_size=IMG_SIZE, batch_size=BS)
    pds = port_det.DetectionDataset(str(d), img_size=IMG_SIZE, batch_size=BS)
    assert [p.rsplit("/", 1)[1] for p in pds.img_files] == ["ok.png"]
    assert pds.img_files == jds.img_files
    np.testing.assert_array_equal(pds.labels[0], jds.labels[0])


# -- segmentation ------------------------------------------------------------

SEG_HW = (128, 256)


def _labelids(rng, h, w):
    """Cityscapes labelIds (0-33) with a share of 255."""
    m = rng.randint(0, 34, (h, w)).astype(np.uint8)
    m[rng.rand(h, w) < 0.1] = 255
    return m


@pytest.fixture(scope="module")
def seg_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    rng = np.random.RandomState(3)
    for city, n in (("aachen", 3), ("bonn", 2)):
        idir = root / "citys" / "leftImg8bit" / "val" / city
        mdir = root / "citys" / "gtFine" / "val" / city
        idir.mkdir(parents=True)
        mdir.mkdir(parents=True)
        for i in range(n):
            stem = f"{city}_{i:06d}_000019"
            png.imwrite(str(idir / f"{stem}_leftImg8bit.png"), _frame(rng, *SEG_HW))
            png.imwrite(str(mdir / f"{stem}_gtFine_labelIds.png"), _labelids(rng, *SEG_HW))
    idir, mdir = root / "custom" / "segimages" / "val", root / "custom" / "seglabels" / "val"
    idir.mkdir(parents=True)
    mdir.mkdir(parents=True)
    for i in range(4):
        png.imwrite(str(idir / f"c{i}.png"), _frame(rng, 100, 150))
        m = rng.randint(0, 3, (100, 150)).astype(np.uint8)
        m[rng.rand(100, 150) < 0.1] = 255
        if i == 1:                                   # a palette mask: its indices count
            im = Image.fromarray(m, "P")
            im.putpalette(list(rng.randint(0, 256, 256 * 3)))
            im.save(mdir / f"c{i}.png")
            assert Image.open(mdir / f"c{i}.png").mode == "P"
        else:
            png.imwrite(str(mdir / f"c{i}.png"), m)
    return root


def _seg_factories(kind):
    if kind == "custom":
        return jax_seg.get_custom_loader, port_seg.get_custom_loader, dict(n_segcls=3)
    if kind == "citys":
        return jax_seg.get_citys_loader, port_seg.get_citys_loader, dict(crop_size=(128, 64))
    return jax_seg.get_citysbdd_loader, port_seg.get_citysbdd_loader, dict(crop_size=(128, 64))


@pytest.mark.parametrize("kind,base_size,bs", [("citys", 128, 2), ("citysbdd", 96, 2),
                                               ("custom", 128, 1), ("custom", 64, 2)])
def test_seg_testval_loaders_match_jax(seg_tree, kind, base_size, bs):
    jf, pf, kw = _seg_factories(kind)
    root = str(seg_tree / ("custom" if kind == "custom" else "citys"))
    args = dict(root=root, split="val", mode="testval", base_size=base_size,
                batch_size=bs, workers=2, **kw)
    jl, pl = jf(**args), pf(**args)
    assert pl.ds.images == jl.ds.images and pl.ds.mask_paths == jl.ds.mask_paths
    batches = _same_batches(jl, pl)
    imgs, masks = batches[0]
    assert imgs.dtype == np.float32 and imgs.shape[2] == base_size
    assert masks.shape[1:] == ((100, 150) if kind == "custom" else SEG_HW)
    assert (masks == -1).any() and masks.max() > 0


def test_seg_test_mode_matches_jax(seg_tree):
    args = dict(root=str(seg_tree / "citys"), split="val", mode="test", base_size=128,
                batch_size=2, workers=1, crop_size=(128, 64))
    _same_batches(jax_seg.get_citys_loader(**args), port_seg.get_citys_loader(**args))


def test_seg_pairs_and_raises(seg_tree, tmp_path):
    for split in ("val", "trainval"):
        if split == "trainval":
            (seg_tree / "citys" / "leftImg8bit" / "train").mkdir(exist_ok=True)
            (seg_tree / "citys" / "gtFine" / "train").mkdir(exist_ok=True)
        assert (port_seg.get_city_pairs(str(seg_tree / "citys"), split)
                == jax_seg.get_city_pairs(str(seg_tree / "citys"), split))
    assert (port_seg.get_custom_pairs(str(seg_tree / "custom"), "val")
            == jax_seg.get_custom_pairs(str(seg_tree / "custom"), "val"))
    for mode in ("train", "val"):                # built (tests/test_torch_train_data.py)
        assert port_seg.get_citys_loader(root=str(seg_tree / "citys"), split="val",
                                         mode=mode).ds.mode == mode
    with pytest.raises(ValueError, match="seg mode"):
        port_seg.get_citys_loader(root=str(seg_tree / "citys"), split="val", mode="x")
    # a BDD-style .jpg frame with its .png trainId mask in a citysbdd split
    idir = tmp_path / "leftImg8bit" / "val" / "bdd"
    mdir = tmp_path / "gtFine" / "val" / "bdd"
    idir.mkdir(parents=True)
    mdir.mkdir(parents=True)
    Image.fromarray(_frame(np.random.RandomState(4), 64, 64)).save(idir / "x_leftImg8bit.jpg")
    trainids = np.random.RandomState(5).randint(0, 19, (64, 64)).astype(np.uint8)
    trainids[::7] = 255
    png.imwrite(str(mdir / "x_gtFine_labelIds.png"), trainids)
    args = dict(root=str(tmp_path), split="val", mode="testval", base_size=64, batch_size=1,
                workers=1)
    pl = port_seg.get_citysbdd_loader(**args)
    (img, mask), = _same_batches(jax_seg.get_citysbdd_loader(**args), pl)
    assert type(pl.ds).__name__ == "CityBddSegmentation"
    np.testing.assert_array_equal(mask[0], np.where(trainids == 255, -1, trainids.astype(int)))


def test_seg_loader_refuses_mixed_shapes(tmp_path):
    """testval keeps each image's size: a batch of two sizes raises, as the
    JAX loader's np.stack does."""
    idir, mdir = tmp_path / "segimages" / "val", tmp_path / "seglabels" / "val"
    idir.mkdir(parents=True)
    mdir.mkdir(parents=True)
    rng = np.random.RandomState(5)
    for i, hw in enumerate(((64, 128), (80, 128))):
        png.imwrite(str(idir / f"m{i}.png"), _frame(rng, *hw))
        png.imwrite(str(mdir / f"m{i}.png"), np.zeros(hw, np.uint8))
    args = dict(root=str(tmp_path), split="val", mode="testval", base_size=128,
                batch_size=2, workers=1)
    for factory in (jax_seg.get_custom_loader, port_seg.get_custom_loader):
        with pytest.raises(ValueError):
            list(factory(**args))
