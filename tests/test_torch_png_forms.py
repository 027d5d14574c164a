"""Every PNG form the standard allows, through the port's codec
(multiyolov5_tpu_torch/data/png.py), against cv2 (OpenCV 5.0) and PIL
(Pillow 12.1), on the CPU.

Files are written by tests/_torch_image_writers.py (neither library writes
Adam7, or 1-, 2- and 4-bit gray): each colour type at each depth it allows
(gray 1/2/4/8/16, RGB 8/16, palette 1/2/4/8, gray + alpha 8/16, RGBA
8/16), plain and Adam7, every row filter in turn, with and without
``tRNS``, at sizes from 1x1 to 37x53.  Each decodes to exactly
``cv2.imread``'s array, ``np.array(Image.open(p))`` (dtype and mode
included: bool for 1-bit gray, uint16 for 16-bit gray, RGBA for 16-bit
gray + alpha) and ``Image.open(p).convert("RGB")``: 0 differing values.

The ``eXIf`` repair: orientations 1-8 in an ``eXIf`` chunk before and
after the image data; ``imread`` turns as cv2 turns (both positions),
``read_rgb`` does not, ``exif_size`` is the JAX ``exif_size`` of the
image after ``verify()``, as the JAX label cache calls it (an ``eXIf``
after IDAT unseen).
"""

import itertools
import tracemalloc

import cv2
import numpy as np
import pytest
from PIL import Image

import _torch_image_writers as W
from multiyolov5_tpu.data.detection import exif_size as jax_exif_size
from multiyolov5_tpu_torch.data import images, png

FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
SIZES = [(1, 1), (2, 9), (9, 2), (13, 9), (37, 53)]


def _held(path):
    """The port's three reads of ``path`` equal cv2's and PIL's."""
    want_cv2 = cv2.imread(path)
    with Image.open(path) as im:
        want_samples = np.array(im)
        want_rgb = np.asarray(im.convert("RGB"))
        assert images.size(path) == im.size
    got = images.imread(path)
    assert got.shape == want_cv2.shape and (got != want_cv2).sum() == 0, path
    got = images.read_samples(path)
    assert got.dtype == want_samples.dtype and got.shape == want_samples.shape, path
    assert (got != want_samples).sum() == 0, path
    got = images.read_rgb(path)
    assert got.shape == want_rgb.shape and (got != want_rgb).sum() == 0, path
    return want_samples.dtype


@pytest.mark.parametrize("ctype,depth", FORMS)
def test_every_form_decodes_as_cv2_and_pil(tmp_path, ctype, depth):
    rng = np.random.RandomState(ctype * 17 + depth)
    ch = png.CHANNELS[ctype]
    n = 0
    for (h, w), interlace in itertools.product(SIZES, (False, True)):
        s = rng.randint(0, 1 << depth, (h, w, ch))
        if depth == 16:                          # values whose low byte would round up
            s[::3] = s[::3] | 0xFF
        kw = {}
        if ctype == 3:
            kw["palette"] = rng.randint(0, 256, (max(1, (1 << depth) - 1), 3))  # one short
        if n % 3 == 1 and ctype in (0, 2, 3):
            kw["trns"] = {0: b"\x00\x01", 2: b"\x00\x01\x00\x02\x00\x03", 3: b"\x80\x00"}[ctype]
        filters = ((n + k) % 5 for k in range(5))
        path = str(tmp_path / f"f{n}.png")
        with open(path, "wb") as fh:
            fh.write(W.png(s, depth, ctype, interlace, tuple(filters), **kw))
        dtype = _held(path)
        n += 1
    assert dtype == (bool if (ctype, depth) == (0, 1) else
                     np.uint16 if (ctype, depth) == (0, 16) else np.uint8)


@pytest.mark.parametrize("filters", [(3,), (4,), (4, 3, 2)])
def test_tall_narrow_average_paeth(tmp_path, filters):
    """A tall, narrow RGB frame of Average and Paeth rows decodes as cv2
    and PIL decode it, and unfiltering it holds O(h * w) memory: each
    skewed diagonal is at most the width long (an (h + w, h) layout would
    take about 200 MB here)."""
    h, w = 4096, 16
    rgb = np.random.RandomState(sum(filters)).randint(0, 256, (h, w, 3)).astype(np.uint8)
    path = str(tmp_path / "tall.png")
    with open(path, "wb") as fh:
        fh.write(W.png(rgb, 8, 2, filters=filters))
    _held(path)
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 0] = filters[0]
    tracemalloc.start()
    png._unfilter(raw, h, 3 * w, 3)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < 8 * h * w * 3 * 2 + (1 << 20), peak


def test_pil_modes_of_the_odd_forms(tmp_path):
    """The forms whose PIL mode is not the obvious one, by name."""
    rng = np.random.RandomState(9)
    for (ctype, depth), mode in (((0, 1), "1"), ((0, 2), "L"), ((0, 4), "L"),
                                 ((0, 16), "I;16"), ((4, 16), "RGBA"), ((3, 2), "P")):
        path = str(tmp_path / f"m{ctype}{depth}.png")
        s = rng.randint(0, 1 << depth, (5, 7, png.CHANNELS[ctype]))
        kw = {"palette": rng.randint(0, 256, (4, 3))} if ctype == 3 else {}
        with open(path, "wb") as fh:
            fh.write(W.png(s, depth, ctype, **kw))
        assert Image.open(path).mode == mode
        _held(path)
    # 16-bit gray: cv2 keeps the high byte, PIL's convert clips, np.array is uint16
    path = str(tmp_path / "g16.png")
    v = np.array([[6500, 7000, 100, 0, 65535, 255, 256, 0x80FF]], np.uint16)
    with open(path, "wb") as fh:
        fh.write(W.png(v, 16, 0))
    assert images.imread(path)[0, :, 0].tolist() == [25, 27, 0, 0, 255, 0, 1, 128]
    assert images.read_rgb(path)[0, :, 0].tolist() == [255, 255, 100, 0, 255, 255, 255, 255]
    assert images.read_samples(path).tolist() == v.tolist()


def _exif_png(path, rgb, o, where):
    chunk = [(b"eXIf", W.exif_tiff(o, "<" if o % 2 else ">"))] if o else []
    with open(path, "wb") as fh:
        fh.write(W.png(rgb, 8, 2, filters=(1, 4),
                       **({"before": chunk} if where == "before" else {"after": chunk})))


@pytest.mark.parametrize("where", ["before", "after"])
def test_exif_orientation_repair(tmp_path, where):
    """A PNG 64 wide and 40 tall with an ``eXIf`` orientation: cv2 turns it
    for 5-8 (the parent's ``imread`` gave (40, 64, 3) and ``exif_size``
    (64, 40) for orientation 6); ``exif_size`` swaps for 6 and 8 as the JAX
    one does after ``verify()`` (an ``eXIf`` before IDAT only), ``read_rgb``
    does not turn."""
    rgb = np.random.RandomState(4).randint(0, 256, (40, 64, 3)).astype(np.uint8)
    for o in range(0, 9):
        path = str(tmp_path / f"o{o}.png")
        _exif_png(path, rgb, o, where)
        want = cv2.imread(path)
        assert (want.shape[:2] == (64, 40)) == (o in (5, 6, 7, 8))
        assert np.array_equal(images.imread(path), want), o
        assert np.array_equal(images.read_rgb(path), rgb), o
        im = Image.open(path)
        im.verify()                                  # the JAX label cache's order
        assert images.exif_size(path) == jax_exif_size(im), o
        if o in (6, 8):
            assert images.exif_size(path) == ((40, 64) if where == "before" else (64, 40))
            assert jax_exif_size(Image.open(path)) == (40, 64)      # unverified: both seen


def test_verified_size_drops_what_verify_rejects(tmp_path):
    """A bad CRC after the image data and a missing IEND fail PIL's
    ``verify``; ``exif_size``, which the label cache calls after it, raises
    on both."""
    rgb = np.random.RandomState(5).randint(0, 256, (12, 16, 3)).astype(np.uint8)
    data = W.png(rgb, 8, 2, after=[(b"tEXt", b"k\x00v")])
    bad = bytearray(data)
    at = data.index(b"tEXt") + 7
    bad[at] ^= 0xFF                                  # the tEXt chunk's body
    for name, body in (("crc.png", bytes(bad)), ("cut.png", data[:-12])):
        path = str(tmp_path / name)
        with open(path, "wb") as fh:
            fh.write(body)
        with pytest.raises(Exception):
            Image.open(path).verify()
        with pytest.raises(ValueError):
            images.exif_size(path)
