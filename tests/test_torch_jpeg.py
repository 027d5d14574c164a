"""The port's JPEG codec (multiyolov5_tpu_torch/data/jpeg.py with its host
C++ in csrc/host/jpeg.cpp, and data/images.py) against libjpeg-turbo through
cv2 (OpenCV 5.0) and PIL (Pillow 12.1), and the loaders that read JPEG
against the JAX package's, on the CPU.

* Decoding: 0 differing values against ``cv2.imdecode`` and PIL's
  ``convert("RGB")`` on seeded images encoded by cv2 at q 50, 75, 95 and
  100, at 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 and gray, at sizes that are
  not multiples of the MCU (1x1 and 5x17 among them); with a restart
  interval; progressive files from cv2 and PIL.  EXIF orientations 1-8
  (and a big-endian EXIF) under ``imread`` against ``cv2.imread`` and
  ``cv2.imdecode``, none applied under ``read_rgb``, ``exif_size`` against
  the JAX ``exif_size``.
* Encoding: at cv2's defaults (q95, 4:2:0, BGR in) and PIL's (q75, 4:2:0),
  the scan bytes (SOS to EOI) and the whole file equal ``cv2.imencode``'s
  and PIL's, and decode in cv2 to the same values; PIL's other qualities
  and subsamplings and cv2's gray files too.
* What raises: arithmetic, lossless, 12-bit and CMYK files, truncated and
  corrupt streams, a Huffman table whose lengths overflow, a second SOI,
  planes sized from another file's header, a file that is no format the
  port reads, a ``.dng`` in ``require_readable``.
* Loaders on seeded JPEG files against the JAX ones: ``LoadImages``
  (orientation 6 turned, as cv2 turns it), ``DetectionDataset`` in eval
  and train (mosaic) modes with the label cache's shapes under EXIF 6 and
  8, ``CityBddSegmentation`` in train, val and testval on a mixed .png /
  .jpg split.
* chip_smoke.py [18]'s SHA-256 constants equal cv2's and PIL's encodes and
  decodes of its seeded frames.

Images are 128x96 or smaller but for the digests' frames.
"""

import hashlib
import importlib.util
import io
import os
import random
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from multiyolov5_tpu.data import detection as jax_det
from multiyolov5_tpu.data import segmentation as jax_seg
from multiyolov5_tpu.data.sources import LoadImages as JaxLoadImages
from multiyolov5_tpu_torch.data import detection as port_det
from multiyolov5_tpu_torch.data import images, jpeg, png
from multiyolov5_tpu_torch.data import segmentation as port_seg
from multiyolov5_tpu_torch.data.hyps import load_hyp
from multiyolov5_tpu_torch.data.sources import LoadImages
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(96, 128), (37, 53), (5, 17), (1, 1)]
SAMPLING = {"4:4:4": 0x111111, "4:2:2": 0x211111, "4:2:0": 0x221111, "4:4:0": 0x121111,
            "4:1:1": 0x411111}


def _natural(rng, h, w):
    """Smooth ramps with noise: what a photo's blocks look like to a coder."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 2 + yy, yy * 3, (xx + yy) // 2], -1)
    return ((base + rng.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


def _cv2_encode(img, *params):
    return cv2.imencode(".jpg", img, list(params))[1].tobytes()


def _pil_encode(rgb, **kw):
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _held(data, what):
    """The port's decode of ``data`` equals cv2's and PIL's, value for value."""
    got = jpeg.decode_rgb(data)
    want_pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    want_cv2 = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert got.shape == want_pil.shape, what
    assert (got != want_pil).sum() == 0, what
    assert (jpeg.decode_bgr(data) != want_cv2).sum() == 0, what


def _scan(data):
    return data[data.index(b"\xff\xda"):]


@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
def test_decoder_equals_libjpeg_turbo(sampling):
    rng = np.random.RandomState(len(sampling))
    for h, w in SIZES:
        img = _natural(rng, h, w)
        for q in (50, 75, 95, 100):
            if sampling == "gray":
                data = _cv2_encode(img[..., 1], cv2.IMWRITE_JPEG_QUALITY, q)
            else:
                data = _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, q,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
            _held(data, (sampling, h, w, q))


def test_decoder_restart_interval_and_progressive():
    rng = np.random.RandomState(7)
    for h, w in SIZES[:3]:
        img = _natural(rng, h, w)
        _held(_cv2_encode(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 3), ("restart", h, w))
        _held(_cv2_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1), ("cv2 progressive", h, w))
        for sub in (0, 2):
            _held(_pil_encode(img, progressive=True, quality=80, subsampling=sub),
                  ("PIL progressive", h, w, sub))
    assert b"\xff\xdd" in _cv2_encode(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)


def _exif(orientation, order="<"):
    tiff = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "IH", 8, 1)
    tiff += struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0) + b"\x00" * 4
    return b"Exif\x00\x00" + tiff


def test_exif_orientation(tmp_path):
    rng = np.random.RandomState(3)
    img = _natural(rng, 40, 64)
    for o, order in [(o, "<") for o in range(0, 9)] + [(6, ">"), (8, ">")]:
        path = str(tmp_path / f"o{o}{order == '>'}.jpg")
        kw = {"exif": _exif(o, order)} if o else {}
        Image.fromarray(img).save(path, quality=90, **kw)
        data = open(path, "rb").read()
        want = cv2.imread(path)
        assert (o in (5, 6, 7, 8)) == (want.shape[:2] == (64, 40))
        assert np.array_equal(images.imread(path), want), o
        assert np.array_equal(jpeg.decode_bgr(data),
                              cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
        assert np.array_equal(images.read_rgb(path), np.asarray(Image.open(path).convert("RGB")))
        assert images.exif_size(path) == jax_det.exif_size(Image.open(path)), o
        assert images.size(path) == Image.open(path).size
    # markers before the frame header that run past the first 64 KiB read
    sof = data.index(b"\xff\xc0")
    com = b"\xff\xfe" + struct.pack(">H", 65000) + b"c" * 64998
    path = str(tmp_path / "long_header.jpg")
    open(path, "wb").write(data[:sof] + com + com + data[sof:])
    assert images.exif_size(path) == jax_det.exif_size(Image.open(path)) == (40, 64)
    assert images.size(path) == Image.open(path).size
    assert np.array_equal(images.imread(path), cv2.imread(path))


@pytest.mark.parametrize("who", ["cv2", "pil"])
def test_encoder_equals_libjpeg_turbo(who, tmp_path):
    rng = np.random.RandomState(11)
    path = str(tmp_path / "x.jpg")
    for h, w in SIZES + [(17, 31), (64, 64)]:
        for noise in (False, True):
            rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8) if noise else _natural(rng, h, w)
            if who == "cv2":
                want = _cv2_encode(rgb[..., ::-1])
                assert images.imwrite(path, rgb[..., ::-1])
            else:
                want = _pil_encode(rgb)
                jpeg.pil_save(path, rgb)
            got = open(path, "rb").read()
            assert _scan(got) == _scan(want), (h, w, noise)
            assert got == want, (h, w, noise)
            assert np.array_equal(cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_COLOR),
                                  cv2.imdecode(np.frombuffer(want, np.uint8), cv2.IMREAD_COLOR))
            if who == "cv2":        # gray
                assert jpeg.encode(rgb[..., 0], 95) == _cv2_encode(rgb[..., 0]), (h, w)
            else:                   # PIL's other qualities and subsamplings
                for q, (sub, name) in zip((20, 50, 90, 100), ((0, "4:4:4"), (1, "4:2:2"),
                                                              (2, "4:2:0"), (1, "4:2:2"))):
                    assert jpeg.encode(rgb, q, name) == _pil_encode(rgb, quality=q,
                                                                   subsampling=sub), (q, name)


def test_unsupported_and_corrupt_files_raise(tmp_path):
    rng = np.random.RandomState(2)
    img = _natural(rng, 24, 40)
    data = _cv2_encode(img)
    sof = data.index(b"\xff\xc0")
    for marker, what in ((0xC9, "arithmetic"), (0xC3, "lossless"), (0xC5, "hierarchical")):
        bad = data[:sof + 1] + bytes([marker]) + data[sof + 2:]
        with pytest.raises(ValueError, match=what):
            jpeg.decode_rgb(bad, "f.jpg")
    bad = data[:sof + 4] + bytes([12]) + data[sof + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_rgb(bad)
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        jpeg.decode_rgb(buf.getvalue(), "cmyk.jpg")
    for cut in (len(data) // 2, len(data) - 40, data.index(b"\xff\xda") + 14):
        with pytest.raises(ValueError, match="truncated|ends"):
            jpeg.decode_rgb(data[:cut], "cut.jpg")
    scan = data.index(b"\xff\xda") + 14
    garbage = bytes(rng.randint(0, 255, 40).astype(np.uint8))   # 0xFF-free: no markers
    with pytest.raises(ValueError, match="corrupt|ends"):
        jpeg.decode_rgb(data[:scan] + b"\xff\xff" * 8 + garbage + data[scan:], "bad.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_rgb(b"\x00" * 10)
    # a DHT whose short lengths hold more codes than they can (200 of
    # length 1, or 1 + 2 of lengths 1-2), and a second SOI before the frame
    for counts in ([200] + [0] * 15, [1, 2] + [0] * 14):
        dht = bytes([0x00] + counts) + bytes(range(sum(counts)))
        bad = data[:2] + b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht + data[2:]
        for fn in (jpeg.decode_rgb, jpeg.decode_bgr, jpeg.header):
            with pytest.raises(ValueError, match="Huffman table"):
                fn(bad, "dht.jpg")
    bad = data[:sof] + b"\xff\xd8" + data[sof:]
    for fn in (jpeg.decode_rgb, jpeg.header):
        with pytest.raises(ValueError, match="second start-of-image"):
            fn(bad, "soi.jpg")
    (tmp_path / "soi.jpg").write_bytes(bad)
    with pytest.raises(ValueError, match="second start-of-image"):
        images.exif_size(str(tmp_path / "soi.jpg"))
    # buffers sized from another file's header are refused, not overrun
    gray = _cv2_encode(img[..., 0])
    with pytest.raises(ValueError, match="disagrees"):
        jpeg.coefficients(data, "f.jpg", jpeg.header(gray))
    (tmp_path / "b.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG, JPEG, BMP, TIFF or WebP"):
        images.imread(str(tmp_path / "b.gif"))
    with pytest.raises(NotImplementedError, match="b.dng"):
        images.require_readable([str(tmp_path / "a.JPG"), str(tmp_path / "b.dng")], "test")


def _exif_rotated(path, rgb, o):
    Image.fromarray(rgb).save(path, quality=92, **({"exif": _exif(o)} if o else {}))


def test_load_images_equals_jax(tmp_path):
    rng = np.random.RandomState(5)
    for i, o in enumerate((0, 6, 3)):
        _exif_rotated(str(tmp_path / f"f{i}.jpg"), _natural(rng, 60, 100), o)
    png.imwrite(str(tmp_path / "g.png"), _natural(rng, 50, 70))
    got, want = LoadImages(str(tmp_path), 128, 32), JaxLoadImages(str(tmp_path), 128, 32)
    n = 0
    for (pp, ip, i0p, _), (pj, ij, i0j, _) in zip(got, want):
        assert pp == pj
        np.testing.assert_array_equal(i0p, i0j)
        np.testing.assert_array_equal(ip, ij)
        n += 1
    assert n == 4 and i0p.shape == (50, 70, 3)


@pytest.fixture(scope="module")
def jpeg_det_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("jdet")
    rng = np.random.RandomState(8)
    d, lbl = root / "images" / "train", root / "labels" / "train"
    d.mkdir(parents=True)
    lbl.mkdir(parents=True)
    for i, (o, (h, w)) in enumerate(zip((0, 6, 8, 5, 0, 2), ((60, 100), (48, 96), (72, 64),
                                                             (50, 80), (96, 128), (64, 64)))):
        _exif_rotated(str(d / f"j{i}.jpg"), _natural(rng, h, w), o)
        n = rng.randint(1, 4)
        rows = np.concatenate([rng.randint(0, 3, (n, 1)), rng.rand(n, 2) * 0.5 + 0.25,
                               rng.rand(n, 2) * 0.3 + 0.1], 1)
        (lbl / f"j{i}.txt").write_text("".join("%d %.6f %.6f %.6f %.6f\n" % tuple(r)
                                               for r in rows))
    return str(d)


def test_detection_dataset_equals_jax(jpeg_det_tree):
    """Eval mode: the cache's shapes (swapped for EXIF 6 and 8 only) and
    every rect batch; train mode: mosaic items on the same draws."""
    kw = dict(img_size=96, batch_size=2, rect=True, stride=32, pad=0.5)
    jds, pds = jax_det.DetectionDataset(jpeg_det_tree, **kw), \
        port_det.DetectionDataset(jpeg_det_tree, **kw)
    assert pds.img_files == jds.img_files
    np.testing.assert_array_equal(pds.shapes, jds.shapes)
    shapes = {os.path.basename(f): s.tolist() for f, s in zip(pds.img_files, pds.shapes)}
    assert shapes["j1.jpg"] == [48, 96] and shapes["j2.jpg"] == [72, 64]    # (w, h) swapped
    jb = list(jax_det.DetectionLoader(jds, 2, max_targets=4, workers=1, drop_last=False))
    pb = list(port_det.DetectionLoader(pds, 2, max_targets=4, workers=1, drop_last=False))
    assert len(jb) == len(pb) == 3
    for a, b in zip(jb, pb):
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y
    kw = dict(img_size=96, batch_size=2, augment=True, hyp=load_hyp("scratch"))
    jds, pds = jax_det.DetectionDataset(jpeg_det_tree, **kw), \
        port_det.DetectionDataset(jpeg_det_tree, **kw)
    assert pds.mosaic
    for i in range(len(pds)):
        random.seed(50 + i)
        np.random.seed(50 + i)
        want = jds[i]
        got = pds.item(i, random.Random(50 + i), np.random.RandomState(50 + i))
        assert np.array_equal(got[0], want[0]), i
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)


def test_citybdd_modes_equal_jax(tmp_path):
    """A mixed split: Cityscapes .png frames with labelIds, BDD .jpg frames
    with trainIds (255 -> -1 only); train, val and testval items equal
    the JAX CityBddSegmentation's on the same draws."""
    rng = np.random.RandomState(6)
    for split in ("train", "val"):
        idir = tmp_path / "leftImg8bit" / split / "mix"
        mdir = tmp_path / "gtFine" / split / "mix"
        idir.mkdir(parents=True)
        mdir.mkdir(parents=True)
        for i in range(4):
            stem, (h, w) = f"m{i}", ((72, 128) if i % 2 else (64, 96))
            if i % 2:
                Image.fromarray(_natural(rng, h, w)).save(idir / f"{stem}_leftImg8bit.jpg",
                                                          quality=85)
                m = rng.randint(0, 19, (h, w)).astype(np.uint8)
            else:
                png.imwrite(str(idir / f"{stem}_leftImg8bit.png"), _natural(rng, h, w))
                m = rng.randint(0, 34, (h, w)).astype(np.uint8)
            m[rng.rand(h, w) < 0.05] = 255
            png.imwrite(str(mdir / f"{stem}_gtFine_labelIds.png"), m)
    for mode in ("train", "val", "testval"):
        kw = dict(root=str(tmp_path), split="val" if mode == "testval" else mode, mode=mode,
                  base_size=96, crop_size=(96, 64), batch_size=1, workers=1)
        jl, pl = jax_seg.get_citysbdd_loader(**kw), port_seg.get_citysbdd_loader(**kw)
        assert isinstance(pl.ds, port_seg.CityBddSegmentation)
        assert pl.ds.images == jl.ds.images and any(p.endswith(".jpg") for p in pl.ds.images)
        for i in range(len(pl.ds)):
            random.seed(30 + i)
            want = jl.ds[i]
            got = pl.ds.item(i, random.Random(30 + i) if mode == "train" else None)
            assert np.array_equal(got[0], want[0]), (mode, i)
            assert np.array_equal(np.asarray(got[1]), np.asarray(want[1])), (mode, i)
            assert (np.asarray(got[1]) == -1).any()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_digests_equal_libraries():
    """[18] (a) holds the port on the card against these constants; here
    they are held against cv2's and PIL's encodes (at their defaults) of
    the same seeded frames and the RGB decodes of those bytes."""
    cs = _chip_smoke()
    assert sorted(cs.JPEG_DIGESTS) == sorted((who, h, w) for who in ("cv2", "pil")
                                             for h, w in cs.JPEG_HW)
    for (who, h, w), (enc, dec) in cs.JPEG_DIGESTS.items():
        rgb = cs.jpeg_frame(h, w)
        data = _cv2_encode(rgb[..., ::-1]) if who == "cv2" else _pil_encode(rgb)
        assert hashlib.sha256(data).hexdigest() == enc, (who, h, w)
        want_cv2 = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        want_pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        for want in (want_cv2, want_pil):
            assert hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest() == dec
