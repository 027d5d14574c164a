"""The port's callers of its image codecs against the JAX package's, on the
new still-image forms, on the CPU in float32: BMP (24-bit, RLE8), TIFF
(LZW + predictor 2 in strips; Deflate in tiles with orientation 3), MPO
(EXIF orientation 6), PNG (Adam7 16-bit RGB, ``eXIf`` 6 before and after
the image data, 4-bit palette).

* ``LoadImages``: paths, letterboxed frames and ``img0`` equal.
* ``DetectionDataset``: the label cache's files, shapes (an ``eXIf`` after
  the image data unseen after ``verify``) and verdicts (a BMP with a cut
  header and a PNG with a bad CRC are dropped by both), rect eval batches
  and mosaic train items equal.
* hub: ``AutoShape`` on the paths, boxes within 1e-3, scores within 1e-5,
  at most 1e-4 of the class map differing (tests/test_torch_hub.py's
  weights and bounds).
* ``labelme_convert``: BMP and TIFF ``imagePath`` and BMP ``imageData``
  give the JAX tool's files, byte for byte.
* the seg loaders: 16-bit, 1-bit, 4-bit palette and Adam7 masks give the
  JAX items (train, val, testval) exactly.
* the detect app on BMP, TIFF and PNG sources: the same files, txt within
  tests/test_torch_detect_app.py's bounds, artifacts cv2's writers' bytes
  of their pixels, drawn as the JAX app draws them outside the box bands;
  an MPO source raises at its first save in both apps and writes the same
  txt under ``--nosave --save-txt``.
* chip_smoke.py [19]'s SHA-256 constants equal cv2's and PIL's decodes of
  its seeded files (and cv2's BMP bytes).

WebP (``write_webp_forms``: lossy, lossy + ALPH, lossless with alpha, EXIF
orientations 5-8 and a prefixed 6 that only Pillow reads, an animation)
through the same callers: ``LoadImages``, the label cache and
``load_image``, the seg loaders (WebP images and masks under ``.png``
names, which both read by content), hub (paths, and PIL images opened from
WebP bytes), ``labelme_convert`` (``imagePath`` and ``imageData``) and the
detect app, whose ``.webp`` source gives ``name.webp`` and raises at the
``_mask`` save in both apps (the JAX app cuts it to ``name._maskwebp``),
and under ``--nosave --save-txt --submit`` writes the same txt and
``results/name._pred.png``.  chip_smoke.py [20]'s WebP digests equal cv2's
and PIL's decodes of its committed fixtures.
"""

import base64
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import random

import cv2
import numpy as np
import pytest
from PIL import Image

import _torch_image_writers as W
import _torch_webp_files as wf
import multiyolov5_tpu.hub as jax_hub
from multiyolov5_tpu.cli.detect import main as jax_detect
from multiyolov5_tpu.data import detection as jax_det
from multiyolov5_tpu.data import segmentation as jax_seg
from multiyolov5_tpu.data.sources import LoadImages as JaxLoadImages
from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.tools import labelme_convert as jax_lc
from multiyolov5_tpu.utils.checkpoint import save_npz
from multiyolov5_tpu_torch import hub as port_hub
from multiyolov5_tpu_torch.cli.detect import main as port_detect
from multiyolov5_tpu_torch.data import detection as port_det
from multiyolov5_tpu_torch.data import images
from multiyolov5_tpu_torch.data import segmentation as port_seg
from multiyolov5_tpu_torch.data.hyps import load_hyp
from multiyolov5_tpu_torch.data.sources import LoadImages
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import seeded_state_dict
from multiyolov5_tpu_torch.tools import labelme_convert as port_lc
from multiyolov5_tpu_torch.utils.checkpoint import to_jax_params
from test_torch_detect_app import (APP_BAND_MAX, APP_BAND_SHARE, MASK_SHARE, _bands,
                                   _hold_drawing, _lines)
from test_torch_engine_args import _weights
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 2 + yy, yy * 3, (xx + yy) // 2], -1)
    return ((base + rng.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


def write_forms(d, rng, hw=(48, 80)):
    """One file of each new form under ``d``, RGB frames of ``hw``; returns
    their names."""
    h, w = hw
    os.makedirs(d, exist_ok=True)
    rgb = [_frame(rng, h, w) for _ in range(9)]
    idx = (np.add.outer(np.arange(h) // 4, np.arange(w) // 6) % 16).astype(np.uint8)
    pal = rng.randint(0, 256, (256, 3))
    exif6 = [(b"eXIf", W.exif_tiff(6))]
    files = {
        "a.bmp": W.bmp(rgb[0][..., ::-1], 24),
        "b.bmp": W.bmp(None, 8, palette=pal, compression=1, rle=W.rle8(idx), size=(w, h)),
        "c.tif": W.tiff(rgb[1], 8, 2, "<", 5, 2, rows_per_strip=7),
        "d.tiff": W.tiff(rgb[2], 8, 2, ">", 8, tile=(16, 16), orientation=3),
        "f.png": W.png(rgb[3].astype(np.uint16) * 257 + 3, 16, 2, interlace=True,
                       filters=(1, 2, 3, 4)),
        "g.png": W.png(rgb[4], 8, 2, after=exif6),
        "h.png": W.png(rgb[5], 8, 2, before=exif6),
        "i.png": W.png(idx, 4, 3, palette=pal[:16]),
    }
    for name, data in files.items():
        with open(os.path.join(d, name), "wb") as fh:
            fh.write(data)
    exif = Image.Exif()
    exif[274] = 6
    Image.fromarray(rgb[6]).save(os.path.join(d, "e.mpo"), format="MPO", save_all=True,
                                 append_images=[Image.fromarray(rgb[7][::-1])],
                                 exif=exif.tobytes())
    return sorted(list(files) + ["e.mpo"])


@pytest.fixture(scope="module")
def hub_weights(tmp_path_factory):
    """tests/test_torch_hub.py's weights (its bounds are set for them)."""
    root = tmp_path_factory.mktemp("hw")
    spec = jax_load_spec("yolov5s_city_seg")
    params, state = _weights(spec, 0)
    ckpt = str(root / "w.npz")
    save_npz(ckpt, {"params": {k: np.asarray(v) for k, v in params.items()},
                    "state": {k: np.asarray(v) for k, v in state.items()},
                    "spec_yaml": json.dumps(spec.yaml)})
    return ckpt


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("w")
    spec = load_spec("yolov5s_city_seg")
    params, state = to_jax_params(seeded_state_dict(spec, 0))
    ckpt = str(root / "w.npz")
    save_npz(ckpt, {"params": params, "state": state, "spec_yaml": json.dumps(spec.yaml)})
    return ckpt


def test_load_images_equals_jax(tmp_path):
    names = write_forms(str(tmp_path), np.random.RandomState(1))
    got, want = LoadImages(str(tmp_path), 96, 32), JaxLoadImages(str(tmp_path), 96, 32)
    n = 0
    for (pp, ip, i0p, _), (pj, ij, i0j, _) in zip(got, want):
        assert pp == pj
        np.testing.assert_array_equal(i0p, i0j)
        np.testing.assert_array_equal(ip, ij)
        n += 1
    assert n == len(names) == 9
    turned = {os.path.basename(p): i0.shape[:2] for p, _, i0, _ in LoadImages(str(tmp_path), 96)}
    assert turned["e.mpo"] == turned["g.png"] == turned["h.png"] == (80, 48)


def test_detection_dataset_equals_jax(tmp_path, capsys):
    d, lbl = tmp_path / "images" / "val", tmp_path / "labels" / "val"
    rng = np.random.RandomState(2)
    names = write_forms(str(d), rng)
    (d / "bad.bmp").write_bytes(open(d / "a.bmp", "rb").read()[:20])
    crc = bytearray(open(d / "g.png", "rb").read())
    crc[-20] ^= 0xFF                                   # inside the eXIf chunk after IDAT
    (d / "crc.png").write_bytes(bytes(crc))
    lbl.mkdir(parents=True)
    for name in names + ["bad.bmp", "crc.png"]:
        n = rng.randint(1, 4)
        rows = np.concatenate([rng.randint(0, 3, (n, 1)), rng.rand(n, 2) * 0.5 + 0.25,
                               rng.rand(n, 2) * 0.3 + 0.1], 1)
        (lbl / (name.rsplit(".", 1)[0] + ".txt")).write_text(
            "".join("%d %.6f %.6f %.6f %.6f\n" % tuple(r) for r in rows))
    kw = dict(img_size=96, batch_size=3, rect=True, stride=32, pad=0.5)
    jds, pds = jax_det.DetectionDataset(str(d), **kw), port_det.DetectionDataset(str(d), **kw)
    out = capsys.readouterr().out
    assert out.count("ignoring corrupted") == 4                # each package drops both
    assert pds.img_files == jds.img_files and len(pds.img_files) == 9
    np.testing.assert_array_equal(pds.shapes, jds.shapes)
    shapes = {os.path.basename(f): s.tolist() for f, s in zip(pds.img_files, pds.shapes)}
    assert shapes["e.mpo"] == shapes["h.png"] == [48, 80] and shapes["g.png"] == [80, 48]
    jb = list(jax_det.DetectionLoader(jds, 3, max_targets=4, workers=1, drop_last=False))
    pb = list(port_det.DetectionLoader(pds, 3, max_targets=4, workers=1, drop_last=False))
    assert len(jb) == len(pb) == 3
    for a, b in zip(jb, pb):
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y
    kw = dict(img_size=96, batch_size=2, augment=True, hyp=load_hyp("scratch"))
    jds, pds = jax_det.DetectionDataset(str(d), **kw), port_det.DetectionDataset(str(d), **kw)
    for i in range(len(pds)):
        random.seed(70 + i)
        np.random.seed(70 + i)
        want = jds[i]
        got = pds.item(i, random.Random(70 + i), np.random.RandomState(70 + i))
        assert np.array_equal(got[0], want[0]), i
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)


def test_label_cache_shapes_of_oriented_files_equal_jax(tmp_path):
    """The label cache sizes a file after ``Image.verify()``: an ``eXIf``
    after a PNG's image data is unseen, and a verified TIFF has no EXIF
    left, so its size stays Pillow's (swapped for 5-8, not swapped back
    for 6 and 8) while a JPEG's and MPO's EXIF 6 still swaps."""
    d, lbl = tmp_path / "images" / "val", tmp_path / "labels" / "val"
    rng = np.random.RandomState(6)
    write_forms(str(d), rng)
    rgb = _frame(rng, 48, 80)
    for o in (5, 6, 8):
        (d / f"o{o}.tif").write_bytes(W.tiff(rgb, 8, 2, "<", 5, 2, orientation=o))
    lbl.mkdir(parents=True)
    for f in os.listdir(d):
        (lbl / (f.rsplit(".", 1)[0] + ".txt")).write_text("0 0.5 0.5 0.2 0.2\n")
    kw = dict(img_size=96, batch_size=4, rect=True, stride=32, pad=0.5)
    jds, pds = jax_det.DetectionDataset(str(d), **kw), port_det.DetectionDataset(str(d), **kw)
    assert pds.img_files == jds.img_files and len(pds.img_files) == 12
    np.testing.assert_array_equal(pds.shapes, jds.shapes)
    shapes = {os.path.basename(f): s.tolist() for f, s in zip(pds.img_files, pds.shapes)}
    assert shapes["o5.tif"] == shapes["o6.tif"] == shapes["o8.tif"] == [48, 80]
    assert shapes["e.mpo"] == shapes["h.png"] == [48, 80] and shapes["g.png"] == [80, 48]


def test_hub_paths_equal_jax(tmp_path, hub_weights):
    write_forms(str(tmp_path), np.random.RandomState(3))
    paths = [str(tmp_path / n) for n in ("a.bmp", "b.bmp", "c.tif", "d.tiff", "e.mpo",
                                         "f.png", "g.png")]
    runs = []
    for shape in (jax_hub.AutoShape(JaxEngine(hub_weights, half=False)),
                  port_hub.AutoShape(Engine(hub_weights, device="cpu", half=False))):
        shape.conf = 0.001
        runs.append(shape(list(paths), size=96))
    want, got = runs
    assert got.files == want.files
    for i in range(len(paths)):
        assert got.imgs[i].shape == want.imgs[i].shape
        np.testing.assert_array_equal(got.imgs[i], want.imgs[i])
        a, b = got.pred[i], want.pred[i]
        assert a.shape == b.shape and len(a)
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=0, atol=1e-5)
        assert (got.masks[i] != want.masks[i]).mean() <= 1e-4
    assert got.imgs[3].shape == (48, 80, 3)            # Pillow turned the TIFF (180 degrees)


def _quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        main(argv)


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def test_labelme_convert_equals_jax(tmp_path):
    write_forms(str(tmp_path / "lm"), np.random.RandomState(4))
    labels = tmp_path / "labels.txt"
    labels.write_text("__ignore__\n_background_\ncar\nperson\n")
    bmp_bytes = open(tmp_path / "lm" / "a.bmp", "rb").read()
    for i, (path, data) in enumerate((("c.tif", None), ("d.tiff", None), ("b.bmp", None),
                                      ("x.png", base64.b64encode(bmp_bytes).decode()))):
        shapes = [{"label": "car", "points": [[5, 5], [40, 8], [30, 30]],
                   "shape_type": "polygon"},
                  {"label": "person", "points": [[50, 10], [70, 40]], "shape_type": "rectangle"}]
        with open(tmp_path / "lm" / f"s{i}.json", "w") as fh:
            json.dump({"imagePath": path, "imageData": data, "shapes": shapes}, fh)
    for pkg, main in (("jax", jax_lc.main), ("port", port_lc.main)):
        out = str(tmp_path / pkg)
        _quiet(main, ["labelme2seg", str(tmp_path / "lm"), out + "/seg", "--labels", str(labels)])
        _quiet(main, ["labelme2det", str(tmp_path / "lm"), out + "/det", "--labels", str(labels)])
    tj, tp = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(tp) == sorted(tj) and "seg/JPEGImages/s3.jpg" in tp
    for k in tj:
        if k.endswith(".png"):
            assert np.array_equal(images.read_samples(str(tmp_path / "port" / k)),
                                  np.asarray(Image.open(tmp_path / "jax" / k))), k
        else:
            assert tp[k] == tj[k], k
    assert port_lc.image_size(str(tmp_path / "lm" / "d.tiff")) == \
        Image.open(tmp_path / "lm" / "d.tiff").size


@pytest.mark.parametrize("mode", ["train", "val", "testval"])
def test_seg_masks_equal_jax(tmp_path, mode):
    """Custom seg masks in PNG forms the parent could not read: 16-bit gray
    (uint16 through the mask path), 1-bit (bool), a 4-bit palette, Adam7;
    and a gray + alpha one (PIL pads its first band with 255, the other
    with 0)."""
    rng = np.random.RandomState(5)
    split = "val" if mode == "testval" else mode
    idir, mdir = tmp_path / "segimages" / split, tmp_path / "seglabels" / split
    idir.mkdir(parents=True)
    mdir.mkdir(parents=True)
    for i, (depth, ctype, interlace) in enumerate(((16, 0, False), (1, 0, False), (4, 3, False),
                                                   (8, 0, True), (8, 4, False))):
        h, w = (48, 64) if i % 2 else (40, 72)
        (idir / f"m{i}.png").write_bytes(W.png(_frame(rng, h, w), 8, 2))
        m = rng.randint(0, 2 if depth == 1 else 3, (h, w, 2 if ctype == 4 else 1))
        if depth in (8, 16):
            m[rng.rand(*m.shape) < 0.1] = 255
        kw = {"palette": rng.randint(0, 256, (16, 3))} if ctype == 3 else {}
        (mdir / f"m{i}.png").write_bytes(W.png(m, depth, ctype, interlace, **kw))
    kw = dict(root=str(tmp_path), split=split, mode=mode, base_size=64, batch_size=1, workers=1,
              n_segcls=3)
    jl, pl = jax_seg.get_custom_loader(**kw), port_seg.get_custom_loader(**kw)
    assert pl.ds.images == jl.ds.images and len(pl.ds) == 5
    for i in range(len(pl.ds)):
        random.seed(80 + i)
        want = jl.ds[i]
        got = pl.ds.item(i, random.Random(80 + i) if mode == "train" else None)
        assert np.array_equal(got[0], want[0]), (mode, i)
        gm, wm = np.asarray(got[1]), np.asarray(want[1])
        assert gm.dtype == wm.dtype and np.array_equal(gm, wm), (mode, i)
    assert images.read_samples(str(mdir / "m0.png")).dtype == np.uint16
    assert images.read_samples(str(mdir / "m1.png")).dtype == bool


def _app(main, ckpt, src, project, name, extra=()):
    """tests/test_torch_detect_app.py's run of either app."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(["--weights", ckpt, "--source", src, "--img-size", "256", "--no-half",
                     "--save-txt", "--save-conf", "--conf-thres", "0.8", "--classes", "3", "6",
                     "8", "--project", project, "--name", name, "--exist-ok"] + list(extra))


def test_detect_app_equals_jax(tmp_path, weights):
    """tests/test_torch_detect_app.py's frames, weights, flags and bounds,
    its PNG frames stored as BMP, TIFF, an Adam7 16-bit PNG and an eXIf 6
    PNG."""
    rng = np.random.RandomState(7)
    src = tmp_path / "src"
    src.mkdir()
    frames = [(rng.rand(256, 512, 3) * 255).astype(np.uint8) for _ in range(2)] * 2
    (src / "a.bmp").write_bytes(W.bmp(frames[0], 24))
    (src / "c.tif").write_bytes(W.tiff(frames[1][..., ::-1], 8, 2, "<", 5, 2, rows_per_strip=9))
    (src / "f.png").write_bytes(W.png(frames[2][..., ::-1].astype(np.uint16) * 257, 16, 2,
                                      interlace=True))
    (src / "g.png").write_bytes(W.png(frames[3][..., ::-1], 8, 2,
                                      after=[(b"eXIf", W.exif_tiff(6))]))
    jdir = _app(jax_detect, weights, str(src), str(tmp_path), "jax")
    pdir = _app(port_detect, weights, str(src), str(tmp_path), "port", ["--device", "cpu"])
    tj, tp = _tree(jdir), _tree(pdir)
    assert sorted(tp) == sorted(tj)
    assert {"a.bmp", "a_mask.bmp", "c.tif", "c_dst.tif", "g.png"} <= set(tp)
    shares, maxes = [], []
    for stem, ext in (("a", "bmp"), ("c", "tif"), ("f", "png"), ("g", "png")):
        lp, lj = _lines(f"{pdir}/labels/{stem}.txt"), _lines(f"{jdir}/labels/{stem}.txt")
        assert len(lp) == len(lj) >= 1, stem
        np.testing.assert_array_equal(lp[:, 0], lj[:, 0])
        shape0 = images.imread(str(src / f"{stem}.{ext}")).shape
        gn = np.array(shape0)[[1, 0, 1, 0]]
        np.testing.assert_allclose(lp[:, 1:5] * gn, lj[:, 1:5] * gn, rtol=0, atol=2e-3)
        np.testing.assert_allclose(lp[:, 5], lj[:, 5], rtol=0, atol=2e-5)
        mp, mj = images.imread(f"{pdir}/{stem}_mask.{ext}"), cv2.imread(f"{jdir}/{stem}_mask.{ext}")
        mask_diff = (mp != mj).any(2)
        assert mask_diff.mean() <= MASK_SHARE
        band = _bands(mp.shape, lp)
        for art, allowed in (("", None), ("_dst", mask_diff)):
            got = images.imread(f"{pdir}/{stem}{art}.{ext}")
            np.testing.assert_array_equal(got, cv2.imread(f"{pdir}/{stem}{art}.{ext}"))
            if ext != "png":                            # the bytes cv2.imwrite gives its pixels
                assert tp[f"{stem}{art}.{ext}"] == cv2.imencode(f".{ext}", got)[1].tobytes()
            share, mx = _hold_drawing(got, cv2.imread(f"{jdir}/{stem}{art}.{ext}"), band, allowed)
            shares.append(share)
            maxes.append(mx)
    assert max(shares) <= APP_BAND_SHARE and max(maxes) <= APP_BAND_MAX, (shares, maxes)
    assert images.imread(str(src / "g.png")).shape == (512, 256, 3)
    # MPO: no writer in cv2, so both apps raise at the first save; with
    # --nosave the txt lines are the same
    mpo = tmp_path / "mpo"
    mpo.mkdir()
    Image.fromarray(frames[0]).save(mpo / "m.mpo", format="MPO", save_all=True,
                                    append_images=[Image.fromarray(frames[1])])
    with pytest.raises(cv2.error, match="could not find a writer"):
        _app(jax_detect, weights, str(mpo), str(tmp_path), "jax_mpo")
    with pytest.raises(ValueError, match="could not find a writer"):
        _app(port_detect, weights, str(mpo), str(tmp_path), "port_mpo", ["--device", "cpu"])
    jdir = _app(jax_detect, weights, str(mpo), str(tmp_path), "jax_mpo2", ["--nosave"])
    pdir = _app(port_detect, weights, str(mpo), str(tmp_path), "port_mpo2",
                ["--nosave", "--device", "cpu"])
    assert sorted(_tree(pdir)) == sorted(_tree(jdir)) == ["labels/m.txt"]
    lp, lj = _lines(f"{pdir}/labels/m.txt"), _lines(f"{jdir}/labels/m.txt")
    assert len(lp) == len(lj) >= 1
    np.testing.assert_array_equal(lp[:, 0], lj[:, 0])
    np.testing.assert_allclose(lp[:, 1:5] * 512, lj[:, 1:5] * 512, rtol=0, atol=2e-3)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_digests_equal_libraries():
    """[19] (a) holds the port's decodes on the card against these
    constants; here they are held against cv2's and PIL's decodes of the
    same seeded files (and cv2.imencode's BMP bytes)."""
    cs = _chip_smoke()
    files = cs.image_form_files()
    assert sorted(cs.FORM_DIGESTS) == sorted(files)
    for name, data in files.items():
        arr = np.frombuffer(data, np.uint8)
        want = {"cv2": cv2.imdecode(arr, cv2.IMREAD_COLOR),
                "rgb": np.asarray(Image.open(io.BytesIO(data)).convert("RGB")),
                "samples": np.array(Image.open(io.BytesIO(data)))}
        for k, v in want.items():
            digest = hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            assert digest == cs.FORM_DIGESTS[name][k], (name, k)
    bgr = cs.form_frame(*cs.FORM_HW)[..., ::-1]
    assert hashlib.sha256(cv2.imencode(".bmp", bgr)[1].tobytes()).hexdigest() == \
        cs.BMP_WRITE_DIGEST


needs_libwebp = pytest.mark.skipif(not wf.available(), reason="Pillow's bundled libwebp not found")


def write_webp_forms(d, rng, hw=(48, 80), suffix=".webp"):
    """One WebP file of each form under ``d``, RGB frames of ``hw``;
    returns their names."""
    h, w = hw
    os.makedirs(d, exist_ok=True)
    rgb = [_frame(rng, h, w) for _ in range(6)]
    alpha = ((np.add.outer(np.arange(h), np.arange(w)) * 5) % 256).astype(np.uint8)
    rgba = np.concatenate([rgb[1], alpha[..., None]], -1)
    lossy, lossless = wf.encode(rgb[2], quality=80), wf.encode(rgba, lossless=1)
    small = wf.encode(_frame(rng, h // 2, w // 2), quality=70)
    files = {
        "w1": wf.encode(rgb[0], quality=75, segments=4, partitions=2),
        "w2": wf.encode(rgba, quality=60, alpha_compression=1, alpha_filtering=2),
        "w3": lossless,
        "w5": wf.with_exif(lossy, 5), "w6": wf.with_exif(lossy, 6),
        "w7": wf.with_exif(lossless, 7), "w8": wf.with_exif(wf.encode(rgb[3], lossless=1), 8),
        "wp": wf.with_exif(wf.encode(rgb[4], quality=90), 6, prefix=True),
        "wa": wf.animation([(small, 4, 6), (wf.encode(rgb[5], quality=50), 0, 0)], (w, h)),
    }
    for name, data in files.items():
        with open(os.path.join(d, name + suffix), "wb") as fh:
            fh.write(data)
    return sorted(n + suffix for n in files)


@needs_libwebp
def test_webp_load_images_equals_jax(tmp_path):
    names = write_webp_forms(str(tmp_path), np.random.RandomState(11))
    got, want = LoadImages(str(tmp_path), 96, 32), JaxLoadImages(str(tmp_path), 96, 32)
    n = 0
    for (pp, ip, i0p, _), (pj, ij, i0j, _) in zip(got, want):
        assert pp == pj
        np.testing.assert_array_equal(i0p, i0j)
        np.testing.assert_array_equal(ip, ij)
        n += 1
    assert n == len(names) == 9
    turned = {os.path.basename(p): i0.shape[:2] for p, _, i0, _ in LoadImages(str(tmp_path), 96)}
    assert turned["w5.webp"] == turned["w8.webp"] == (80, 48)
    assert turned["wp.webp"] == turned["w1.webp"] == (48, 80)   # cv2 reads no prefixed EXIF


@needs_libwebp
def test_webp_label_cache_and_load_image_equal_jax(tmp_path):
    """Shapes after ``verify()`` (orientations 5-8: only 6 and 8 swap, and
    the prefixed 6 swaps too, Pillow reading past its prefix), rect eval
    batches and ``load_image``."""
    d, lbl = tmp_path / "images" / "val", tmp_path / "labels" / "val"
    rng = np.random.RandomState(12)
    names = write_webp_forms(str(d), rng)
    (d / "cut.webp").write_bytes(open(d / "w1.webp", "rb").read()[:30])
    lbl.mkdir(parents=True)
    for name in names + ["cut.webp"]:
        (lbl / (name.rsplit(".", 1)[0] + ".txt")).write_text("0 0.5 0.5 0.2 0.2\n1 0.3 0.4 0.1 0.2\n")
    kw = dict(img_size=96, batch_size=4, rect=True, stride=32, pad=0.5)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jds, pds = jax_det.DetectionDataset(str(d), **kw), port_det.DetectionDataset(str(d), **kw)
    assert out.getvalue().count("ignoring corrupted") == 2       # each package drops cut.webp
    assert pds.img_files == jds.img_files and len(pds.img_files) == 9
    np.testing.assert_array_equal(pds.shapes, jds.shapes)
    shapes = {os.path.basename(f): s.tolist() for f, s in zip(pds.img_files, pds.shapes)}
    assert shapes["w6.webp"] == shapes["w8.webp"] == shapes["wp.webp"] == [48, 80]
    assert shapes["w5.webp"] == shapes["w7.webp"] == [80, 48]
    for i in range(len(pds.img_files)):
        for a, b in zip(pds.load_image(i), jds.load_image(i)):
            np.testing.assert_array_equal(a, b)
    jb = list(jax_det.DetectionLoader(jds, 4, max_targets=4, workers=1, drop_last=False))
    pb = list(port_det.DetectionLoader(pds, 4, max_targets=4, workers=1, drop_last=False))
    assert len(jb) == len(pb) == 3
    for a, b in zip(jb, pb):
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@needs_libwebp
@pytest.mark.parametrize("mode", ["train", "val", "testval"])
def test_webp_seg_images_and_masks_equal_jax(tmp_path, mode):
    """WebP images and masks under ``.png`` names: both loaders read them
    by content (a lossless WebP mask is an RGB array to both)."""
    rng = np.random.RandomState(13)
    split = "val" if mode == "testval" else mode
    idir, mdir = tmp_path / "segimages" / split, tmp_path / "seglabels" / split
    write_webp_forms(str(idir), rng, (40, 64), suffix=".png")
    mdir.mkdir(parents=True)
    for name in os.listdir(idir):
        m = rng.randint(0, 3, (40, 64)).astype(np.uint8)
        m[rng.rand(40, 64) < 0.1] = 255
        (mdir / name).write_bytes(wf.encode(np.repeat(m[..., None], 3, 2), lossless=1, exact=1))
    kw = dict(root=str(tmp_path), split=split, mode=mode, base_size=64, batch_size=1, workers=1,
              n_segcls=3)
    jl, pl = jax_seg.get_custom_loader(**kw), port_seg.get_custom_loader(**kw)
    assert pl.ds.images == jl.ds.images and len(pl.ds) == 9
    for i in range(len(pl.ds)):
        random.seed(90 + i)
        want = jl.ds[i]
        got = pl.ds.item(i, random.Random(90 + i) if mode == "train" else None)
        assert np.array_equal(got[0], want[0]), (mode, i)
        gm, wm = np.asarray(got[1]), np.asarray(want[1])
        assert gm.dtype == wm.dtype and np.array_equal(gm, wm), (mode, i)


@needs_libwebp
def test_webp_hub_equals_jax(tmp_path, hub_weights):
    """``AutoShape`` on WebP paths and on PIL images opened from WebP
    bytes, under tests/test_torch_hub.py's bounds."""
    write_webp_forms(str(tmp_path), np.random.RandomState(14))
    paths = [str(tmp_path / n) for n in ("w2.webp", "w6.webp", "wa.webp")]
    runs = []
    for shape in (jax_hub.AutoShape(JaxEngine(hub_weights, half=False)),
                  port_hub.AutoShape(Engine(hub_weights, device="cpu", half=False))):
        shape.conf = 0.001
        pil = Image.open(io.BytesIO(open(tmp_path / "w3.webp", "rb").read()))
        runs.append(shape(list(paths) + [pil], size=64))
    want, got = runs
    assert got.files == want.files
    for i in range(len(paths) + 1):
        assert got.imgs[i].shape == want.imgs[i].shape
        np.testing.assert_array_equal(got.imgs[i], want.imgs[i])
        a, b = got.pred[i], want.pred[i]
        assert a.shape == b.shape and len(a)
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=0, atol=1e-5)
        assert (got.masks[i] != want.masks[i]).mean() <= 1e-4
    assert got.imgs[1].shape == (48, 80, 3)            # Pillow does not turn EXIF 6


@needs_libwebp
def test_webp_labelme_convert_equals_jax(tmp_path):
    """WebP ``imagePath`` (lossy + ALPH, EXIF 6, an animation) and
    ``imageData`` (lossless with alpha) give the JAX tool's files."""
    write_webp_forms(str(tmp_path / "lm"), np.random.RandomState(15))
    labels = tmp_path / "labels.txt"
    labels.write_text("__ignore__\n_background_\ncar\nperson\n")
    raw = open(tmp_path / "lm" / "w3.webp", "rb").read()
    for i, (path, data) in enumerate((("w2.webp", None), ("w6.webp", None), ("wa.webp", None),
                                      ("x.png", base64.b64encode(raw).decode()))):
        shapes = [{"label": "car", "points": [[5, 5], [40, 8], [30, 30]],
                   "shape_type": "polygon"},
                  {"label": "person", "points": [[50, 10], [70, 40]], "shape_type": "rectangle"}]
        with open(tmp_path / "lm" / f"s{i}.json", "w") as fh:
            json.dump({"imagePath": path, "imageData": data, "shapes": shapes}, fh)
    for pkg, main in (("jax", jax_lc.main), ("port", port_lc.main)):
        out = str(tmp_path / pkg)
        _quiet(main, ["labelme2seg", str(tmp_path / "lm"), out + "/seg", "--labels", str(labels)])
        _quiet(main, ["labelme2det", str(tmp_path / "lm"), out + "/det", "--labels", str(labels)])
    tj, tp = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(tp) == sorted(tj) and "seg/JPEGImages/s3.jpg" in tp
    for k in tj:
        if k.endswith(".png"):
            assert np.array_equal(images.read_samples(str(tmp_path / "port" / k)),
                                  np.asarray(Image.open(tmp_path / "jax" / k))), k
        else:
            assert tp[k] == tj[k], k
    assert port_lc.image_size(str(tmp_path / "lm" / "w6.webp")) == \
        Image.open(tmp_path / "lm" / "w6.webp").size


@needs_libwebp
def test_webp_detect_app_equals_jax(tmp_path, weights):
    """A ``.webp`` source through both apps (tests/test_torch_detect_app.py's
    weights, flags and bounds, its 256 x 512 frame stored as lossy WebP):
    with ``--submit`` both write ``results/name._pred.png``, ``name.webp``
    (the port's decoding to its pixels as cv2's file would) and the txt,
    then raise at ``name._maskwebp``; with ``--nosave`` the same txt and
    ``_pred.png``."""
    rng = np.random.RandomState(16)
    src = tmp_path / "src"
    src.mkdir()
    frame = (rng.rand(256, 512, 3) * 255).astype(np.uint8)
    (src / "v.webp").write_bytes(wf.encode(frame, quality=90))
    runs = {}
    for pkg, main, err, extra in (("jax", jax_detect, cv2.error, []),
                                  ("port", port_detect, ValueError, ["--device", "cpu"])):
        with pytest.raises(err, match="could not find a writer"):
            _app(main, weights, str(src), str(tmp_path), pkg, ["--submit"] + extra)
        runs[pkg] = str(tmp_path / pkg)
        _app(main, weights, str(src), str(tmp_path), pkg + "_nosave",
             ["--submit", "--nosave"] + extra)
    for suffix in ("", "_nosave"):
        pdir, jdir = runs["port"] + suffix, runs["jax"] + suffix
        tj, tp = _tree(jdir), _tree(pdir)
        assert sorted(tp) == sorted(tj)
        assert "results/v._pred.png" in tp and ("v.webp" in tp) == (suffix == "")
        lp, lj = _lines(f"{pdir}/labels/v.txt"), _lines(f"{jdir}/labels/v.txt")
        assert len(lp) == len(lj) >= 1
        np.testing.assert_array_equal(lp[:, 0], lj[:, 0])
        gn = np.array([512, 256, 512, 256])
        np.testing.assert_allclose(lp[:, 1:5] * gn, lj[:, 1:5] * gn, rtol=0, atol=2e-3)
        np.testing.assert_allclose(lp[:, 5], lj[:, 5], rtol=0, atol=2e-5)
        pp, pj = (images.read_samples(f"{d}/results/v._pred.png") for d in (pdir, jdir))
        assert (pp != pj).mean() <= MASK_SHARE
    got, want = images.imread(f"{runs['port']}/v.webp"), cv2.imread(f"{runs['jax']}/v.webp")
    np.testing.assert_array_equal(got, cv2.imread(f"{runs['port']}/v.webp"))
    share, mx = _hold_drawing(got, want, _bands(got.shape, _lines(f"{runs['port']}/labels/v.txt")))
    assert share <= APP_BAND_SHARE and mx <= APP_BAND_MAX, (share, mx)
    assert os.path.getsize(f"{runs['port']}/v.webp") <= 2 * os.path.getsize(f"{runs['jax']}/v.webp")


def test_chip_smoke_webp_digests_equal_libraries():
    """[20] (a) holds the port's decodes on the card against
    tests/webp_fixtures/digests.json; here the digests are held against
    cv2's and PIL's decodes of the committed files, which the port's equal."""
    cs = _chip_smoke()
    with open(os.path.join(cs.WEBP_FIXTURES, "digests.json")) as fh:
        want = json.load(fh)
    assert cs.WEBP_BIG in want and len(want) == 5
    total = 0
    for name, digests in want.items():
        path = os.path.join(cs.WEBP_FIXTURES, name)
        total += os.path.getsize(path)
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
        with Image.open(path) as im:
            samples = np.array(im)
        for k, lib, port in (("cv2", cv2.imread(path), images.imread(path)),
                             ("rgb", rgb, images.read_rgb(path)),
                             ("samples", samples, images.read_samples(path))):
            assert hashlib.sha256(np.ascontiguousarray(lib).tobytes()).hexdigest() == digests[k]
            assert hashlib.sha256(np.ascontiguousarray(port).tobytes()).hexdigest() == digests[k]
    assert total <= 1_500_000
    assert images.imread(os.path.join(cs.WEBP_FIXTURES, "exif6_400x300.webp")).shape == (400, 300, 3)
