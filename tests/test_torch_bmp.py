"""The port's BMP codec (multiyolov5_tpu_torch/data/bmp.py, RLE in
csrc/host/codecs.cpp) against cv2 (OpenCV 5.0) and PIL (Pillow 12.1), on
the CPU.

OpenCV and Pillow read BMP with decoders of their own, which differ, so
each semantics is held to its own library: ``imread`` to ``cv2.imread``,
``read_samples`` / ``read_rgb`` / ``size`` to ``np.array(Image.open(p))``
/ ``convert("RGB")`` / ``.size``, 0 differing values, and where one
library fails on a file the port's read of that semantics raises.

* Headers OS/2 core (12), INFO (40), V4 (108), V5 (124); 1-, 4- and 8-bit
  palettes (grey ones, which PIL opens as ``1`` / ``L``, short ones);
  16-bit 5-5-5 and, by BITFIELDS, 5-6-5 (cv2 shifts, PIL scales; cv2
  cannot read the masks of a V4 header); 24-bit; 32-bit BI_RGB and
  BITFIELDS with and without an alpha mask; rows bottom-up and top-down.
* RLE8 and RLE4: 3000 seeded random streams of runs, literals (odd and
  even), end-of-line, delta and end-of-bitmap escapes, where each library
  has its own rules (cv2 paints skipped pixels with palette entry 0 and
  fails on a run past its row, PIL clips runs, reads a delta's bytes twice
  and fails on a short image), plus the files Pillow writes.
* ``imwrite`` gives cv2.imwrite's bytes for gray and BGR at widths that
  pad their rows.
"""

import itertools

import cv2
import numpy as np
import pytest
from PIL import Image

import _torch_image_writers as W
from multiyolov5_tpu_torch.data import bmp, images


def _outcome(fn):
    try:
        return fn()
    except Exception as e:          # noqa: BLE001 - the library's failure is the outcome
        return e


def _held(path):
    """Each semantics equals its library, raising where it fails; returns
    whether cv2 and PIL read the file."""
    want = cv2.imread(path)
    got = _outcome(lambda: images.imread(path))
    if want is None:
        assert isinstance(got, Exception), path
    else:
        assert not isinstance(got, Exception), (path, got)
        assert got.shape == want.shape and (got != want).sum() == 0, path
    pil = _outcome(lambda: (np.array(Image.open(path)),
                            np.asarray(Image.open(path).convert("RGB")), Image.open(path).size))
    port = _outcome(lambda: (images.read_samples(path), images.read_rgb(path),
                             images.size(path)))
    if isinstance(pil, Exception):
        assert isinstance(port, Exception), path
    else:
        assert not isinstance(port, Exception), (path, port)
        for g, w in zip(port[:2], pil[:2]):
            assert g.dtype == w.dtype and g.shape == w.shape and (g != w).sum() == 0, path
        assert port[2] == pil[2] == images.exif_size(path)
    return want is not None, not isinstance(pil, Exception)


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


@pytest.mark.parametrize("header", [12, 40, 108, 124])
def test_palette_files(tmp_path, header):
    rng = np.random.RandomState(header)
    for bits, (h, w), top_down, kind in itertools.product(
            (1, 4, 8), ((1, 1), (5, 7), (9, 33)), (False, True), ("colour", "grey", "short")):
        if header == 12 and (top_down or kind == "short"):
            continue
        n = 1 << bits
        if kind == "grey":
            pal = [(0, 0, 0), (255, 255, 255)] if bits == 1 else [(i, i, i) for i in range(n)]
        else:
            pal = rng.randint(0, 256, (n if kind == "colour" else max(2, n - 3), 3))
        if kind == "grey" and bits == 4:
            continue                # Pillow reads a 4-bit grey ramp at 8 bits a pixel (below)
        idx = rng.randint(0, n, (h, w))
        path = _write(tmp_path, f"p{bits}{kind}{h}{top_down}.bmp",
                      W.bmp(idx, bits, header, pal, top_down=top_down))
        assert _held(path) == (True, True)


def test_direct_colour_files(tmp_path):
    rng = np.random.RandomState(1)
    seen = set()
    for (h, w), top_down in itertools.product(((1, 1), (6, 5), (17, 31)), (False, True)):
        v = rng.randint(0, 1 << 16, (h, w)).astype(np.uint16)
        bgra = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
        files = {
            "555": W.bmp(v, 16, top_down=top_down),
            "555bf": W.bmp(v, 16, compression=3, masks=(0x7C00, 0x3E0, 0x1F), top_down=top_down),
            "565bf": W.bmp(v, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F), top_down=top_down),
            "565v4": W.bmp(v, 16, 108, compression=3, masks=(0xF800, 0x7E0, 0x1F, 0),
                           top_down=top_down),
            "24": W.bmp(bgra[..., :3], 24, top_down=top_down),
            "24core": W.bmp(bgra[..., :3], 24, 12),
            "32": W.bmp(bgra, 32, top_down=top_down),
            "32bf": W.bmp(bgra, 32, compression=3, masks=(0xFF0000, 0xFF00, 0xFF),
                          top_down=top_down),
            "32v5a": W.bmp(bgra, 32, 124, compression=3,
                           masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), top_down=top_down),
            "32v4rgba": W.bmp(bgra, 32, 108, compression=3,
                              masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), top_down=top_down),
        }
        for name, data in files.items():
            path = _write(tmp_path, f"{name}_{h}_{top_down}.bmp", data)
            seen.add((name, _held(path)))
            if name == "32v5a":
                assert images.read_samples(path).shape == (h, w, 4)
    assert ("565v4", (False, True)) in seen and ("565bf", (True, True)) in seen
    # the 16-bit expansions differ: cv2 shifts, PIL scales
    path = _write(tmp_path, "w.bmp", W.bmp(np.array([[0x7FFF, 0x1234]], np.uint16), 16))
    assert images.imread(path)[0].tolist() == [[248, 248, 248], [160, 136, 32]]
    assert images.read_rgb(path)[0].tolist() == [[255, 255, 255], [32, 139, 164]]


def test_pil_written_files(tmp_path):
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (13, 21, 3)).astype(np.uint8)
    for mode in ("RGB", "RGBA", "L", "1", "P"):
        im = Image.fromarray(img).convert(mode)
        path = str(tmp_path / f"pil_{mode}.bmp")
        im.save(path)
        assert _held(path) == (True, True)


def _random_rle(rng, rle4, w, h):
    toks = []
    for _ in range(rng.randint(1, 12)):
        r = rng.rand()
        if r < 0.4:
            toks += [rng.randint(1, w + 2), rng.randint(0, 256)]
        elif r < 0.6:
            c = rng.randint(3, max(4, w + 2))
            toks += [0, c] + list(rng.randint(0, 256, ((((c + 1) >> 1) + 1) & ~1) if rle4
                                              else (c + 1) & ~1))
        elif r < 0.8:
            toks += [0, 0]
        elif r < 0.9:
            toks += [0, 2, rng.randint(0, 3), rng.randint(0, 2)]
        else:
            toks += [0, 1]
    if rng.rand() < 0.5:
        toks += [0, 0] * h + [0, 1]
    return bytes(toks)


@pytest.mark.parametrize("rle4", [False, True])
def test_rle_streams_as_each_library_reads_them(tmp_path, rle4):
    rng = np.random.RandomState(3 + rle4)
    pal = [(i, (i * 7) % 256, (i * 13 + 5) % 256) for i in range(16 if rle4 else 256)]
    read = [0, 0]
    path = str(tmp_path / "r.bmp")
    for _ in range(1500):
        w, h = rng.randint(1, 9), rng.randint(1, 5)
        with open(path, "wb") as fh:
            fh.write(W.bmp(None, 4 if rle4 else 8, palette=pal, compression=2 if rle4 else 1,
                           rle=_random_rle(rng, rle4, w, h), size=(w, h)))
        ok = _held(path)
        read[0] += ok[0]
        read[1] += ok[1]
    assert read[0] > 200 and read[1] > 200          # both libraries read many of them
    # a whole frame's RLE8, as an encoder writes it
    idx = (np.add.outer(np.arange(37) // 5, np.arange(61) // 9) % 200).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(W.bmp(None, 8, palette=rng.randint(0, 256, (256, 3)), compression=1,
                       rle=W.rle8(idx), size=(61, 37)))
    assert _held(path) == (True, True)


def test_imwrite_is_cv2s_bytes(tmp_path):
    rng = np.random.RandomState(6)
    for shape in ((1, 1), (3, 5), (7, 6, 3), (5, 9, 3), (31, 17), (40, 64, 3), (12, 10, 1)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        got, want = str(tmp_path / "g.bmp"), str(tmp_path / "w.bmp")
        assert images.imwrite(got, img) and cv2.imwrite(want, img)
        assert open(got, "rb").read() == open(want, "rb").read(), shape
        np.testing.assert_array_equal(images.imread(got), cv2.imread(want))
    with pytest.raises(ValueError, match="uint8"):
        bmp.encode(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        bmp.encode(np.zeros((4, 4, 4), np.uint8))


def test_corrupt_and_odd_files_raise(tmp_path):
    rng = np.random.RandomState(7)
    data = W.bmp(rng.randint(0, 256, (8, 8, 3)), 24)
    for name, body in (("cut.bmp", data[:-20]), ("head.bmp", data[:30]),
                       ("hsize.bmp", data[:14] + b"\x20" + data[15:])):
        path = _write(tmp_path, name, body)
        assert cv2.imread(path) is None
        with pytest.raises(ValueError, match=name):
            images.imread(path)
        with pytest.raises(Exception):
            Image.open(path).load()
        with pytest.raises(ValueError, match=name):
            images.read_rgb(path)
    # a 4-bit palette that is the grey ramp 0-15: Pillow takes it for mode L
    # and reads the packed rows at 8 bits a pixel; the port refuses it
    path = _write(tmp_path, "ramp.bmp", W.bmp(rng.randint(0, 16, (4, 8)), 4,
                                              palette=[(i, i, i) for i in range(16)]))
    assert Image.open(path).mode == "L"
    with pytest.raises(NotImplementedError, match="mode L"):
        images.read_rgb(path)
    np.testing.assert_array_equal(images.imread(path), cv2.imread(path))
