"""The port's baseline TIFF codec (multiyolov5_tpu_torch/data/tiff.py, LZW
and PackBits in csrc/host/codecs.cpp) against cv2 (OpenCV 5.0, libtiff's
RGBA interface) and PIL (Pillow 12.1), on the CPU.

Files are written by tests/_torch_image_writers.py: gray (photometric 0
and 1) at 1, 2, 4, 8 and 16 bits and 8-bit with alpha, RGB at 8 and 16
bits with no, unassociated, associated and unspecified alpha, palettes at
4 and 8 bits (16-bit and 8-bit colormaps), in both byte orders, each
compression (none, LZW, Deflate 8 and 32946, PackBits), predictor 1 and
2, one strip, many strips and tiles, orientations 1-8 (square and not).
Each semantics equals its library with 0 differing values, raising where
the library fails: ``imread`` ``cv2.imread`` (which fails on non-square
orientations 5-8 and 2- or 4-bit gray), ``read_samples`` / ``read_rgb``
``np.array(Image.open(p))`` / ``convert("RGB")`` (Pillow turns every
orientation as it loads), ``size`` ``.size``, ``exif_size`` the JAX
``exif_size``.  An oriented tiled file is turned as OpenCV turns it (each
tile's columns flipped in place); partial tiles of 16-bit gray or gray +
alpha, which OpenCV misplaces, raise ``NotImplementedError`` under
``imread`` and are held under PIL's semantics only.

``imwrite`` gives cv2.imwrite's bytes (LZW, predictor 2, its strips and
tags); the LZW coder is held to libtiff's strips and round-trips; the
unsupported forms raise naming their tag.
"""

import io
import itertools
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

import _torch_image_writers as W
from multiyolov5_tpu.data.detection import exif_size as jax_exif_size
from multiyolov5_tpu_torch.data import host_codecs, images, tiff

FORMS = [(0, 1, 1, None), (1, 1, 1, None), (0, 2, 1, None), (1, 4, 1, None), (0, 8, 1, None),
         (1, 8, 1, None), (0, 16, 1, None), (1, 16, 1, None), (1, 8, 2, [2]), (0, 8, 2, [2]),
         (2, 8, 3, None), (2, 16, 3, None), (2, 8, 4, [2]), (2, 8, 4, [1]), (2, 8, 4, [0]),
         (2, 8, 4, None), (2, 16, 4, [2]), (2, 16, 4, [1]), (2, 16, 4, [0]), (3, 4, 1, None),
         (3, 8, 1, None)]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:          # noqa: BLE001 - the library's failure is the outcome
        return e


def _held(path):
    """Each semantics equals its library; returns (cv2 read it, the port's
    imread refused a form OpenCV misreads, PIL read it).  Under PIL's
    semantics the port refuses exactly the files Pillow misreads by path
    (its memory map): those whose read by path differs from its read of
    the same bytes."""
    want = cv2.imread(path)
    got = _outcome(lambda: images.imread(path))
    refused = isinstance(got, NotImplementedError) and "misplaces" in str(got)
    if want is None:
        assert isinstance(got, Exception), path
    elif not refused:
        assert not isinstance(got, Exception), (path, got)
        assert got.shape == want.shape and (got != want).sum() == 0, path
    pil = _outcome(lambda: (np.array(Image.open(path)),
                            np.asarray(Image.open(path).convert("RGB")), Image.open(path).size,
                            jax_exif_size(_verified(path))))
    port = _outcome(lambda: (images.read_samples(path), images.read_rgb(path)))
    if isinstance(pil, Exception):
        assert isinstance(port, Exception), path
        return want is not None, refused, False
    with open(path, "rb") as fh:
        from_bytes = np.array(Image.open(io.BytesIO(fh.read())))
    mapped_wrong = from_bytes.shape != pil[0].shape or (from_bytes != pil[0]).any()
    assert (isinstance(port, NotImplementedError) and "memory-maps" in str(port)) == \
        bool(mapped_wrong), (path, port)
    if not mapped_wrong:
        for g, w in zip(port, pil[:2]):
            assert g.shape == w.shape and g.dtype == w.dtype.newbyteorder("="), path
            assert (g != w).sum() == 0, path
    assert (images.size(path), images.exif_size(path)) == pil[2:], path
    return want is not None, refused, True


def _verified(path):
    """The image as the JAX label cache holds it when it calls exif_size."""
    im = Image.open(path)
    im.verify()
    return im


@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
def test_every_form_as_cv2_and_pil(tmp_path, compression):
    rng = np.random.RandomState(compression % 1000)
    path = str(tmp_path / "t.tif")
    tally = np.zeros(3, int)
    for (ph, b, spp, extra), order, layout in itertools.product(FORMS, "<>",
                                                               ("strip", "strips", "tiles")):
        h, w = rng.randint(1, 40), rng.randint(1, 40)
        s = rng.randint(0, 1 << b, (h, w, spp))
        if extra in ([1], [2]):
            s[..., -1] = rng.choice([0, 1, 128, 254, 255, (1 << b) - 1], (h, w))
        kw = {"extra": extra}
        if ph == 3:
            kw["colormap"] = rng.randint(0, 65536 if rng.rand() < 0.8 else 256, (1 << b, 3))
        if layout == "strips":
            kw["rows_per_strip"] = rng.randint(1, 5)
        elif layout == "tiles":
            kw["tile"] = (16, 16)
        pred = 2 if b in (8, 16) and compression in (5, 8, 32946) and rng.rand() < 0.6 else 1
        o = int(rng.choice([1, 1, 1, 2, 3, 4, 5, 6, 7, 8]))
        with open(path, "wb") as fh:
            fh.write(W.tiff(s, b, ph, order, compression, pred, orientation=o if o > 1 else None,
                            **kw))
        tally += _held(path)
    assert tally[0] >= 60 and tally[1] <= 12 and tally[2] >= 110     # of 126 files


def test_orientations(tmp_path):
    """Pillow turns 2-8 as it loads (its size swapped for 5-8, the JAX
    ``exif_size`` swapping 6 and 8 back); cv2 turns 2-4 and square 5-8,
    and fails on the others.  Pillow's memory map of one raw strip opened
    by path reads it at the swapped width first, so the port refuses that
    form, from bytes too (where Pillow does not map it)."""
    rng = np.random.RandomState(4)
    for (h, w), o, (ph, b, spp), comp in itertools.product(
            ((6, 9), (9, 9)), range(1, 9), ((2, 8, 3), (1, 8, 1), (1, 16, 1), (3, 8, 1)), (1, 5)):
        s = rng.randint(0, 1 << b, (h, w, spp))
        kw = {"colormap": rng.randint(0, 65536, (256, 3))} if ph == 3 else {}
        path = str(tmp_path / "o.tif")
        data = W.tiff(s, b, ph, compression=comp, orientation=o, **kw)
        with open(path, "wb") as fh:
            fh.write(data)
        cv_ok, _, pil_ok = _held(path)
        assert pil_ok and cv_ok == (o < 5 or h == w), (o, h, w)
        mapped = comp == 1 and o >= 5 and h != w and (ph, b) != (2, 8)
        if mapped:
            with pytest.raises(NotImplementedError, match="memory-maps"):
                images.decode_rgb(data)
        else:
            np.testing.assert_array_equal(images.decode_rgb(data), np.asarray(
                Image.open(io.BytesIO(data)).convert("RGB")))
        if o in (6, 8):                          # after verify, as the label cache
            assert images.exif_size(path) == (h, w) == jax_exif_size(_verified(path))
            assert jax_exif_size(Image.open(path)) == (w, h)


def test_imwrite_is_cv2s_bytes(tmp_path):
    rng = np.random.RandomState(5)
    for shape in ((1, 1), (7, 5, 3), (80, 64, 3), (80, 64), (30, 1000, 3), (9, 2100), (3, 6144),
                  (300, 200, 3), (12, 7, 1)):
        if len(shape) == 3 and shape[0] > 100:
            yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
            img = ((xx * 3 + yy * 2)[..., None] + rng.randint(0, 6, shape)).astype(np.uint8)
        else:
            img = rng.randint(0, 256, shape).astype(np.uint8)
        got, want = str(tmp_path / "g.tif"), str(tmp_path / "w.tif")
        assert images.imwrite(got, img) and cv2.imwrite(want, img)
        assert open(got, "rb").read() == open(want, "rb").read(), shape
        np.testing.assert_array_equal(cv2.imread(got, cv2.IMREAD_UNCHANGED),
                                      img.reshape(img.shape[:2]) if img.ndim == 2 or
                                      img.shape[2] == 1 else img)
        pil = np.asarray(Image.open(got))
        np.testing.assert_array_equal(pil, img.reshape(pil.shape)[..., ::-1] if pil.ndim == 3
                                      else img.reshape(pil.shape))
        np.testing.assert_array_equal(images.imread(got), cv2.imread(got))
    assert images.imwrite(str(tmp_path / "g.tiff"), img)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        tiff.encode(np.zeros((4, 4, 4), np.uint8))


def test_lzw_coder():
    """Round trips of the host LZW against the test writer's coder, the
    table-full Clear included; a stream cut short raises."""
    rng = np.random.RandomState(6)
    for n in (1, 2, 300, 5000, 70000):
        for data in (rng.randint(0, 4, n).astype(np.uint8).tobytes(),
                     rng.randint(0, 256, n).astype(np.uint8).tobytes()):
            enc = host_codecs.lzw_encode(np.frombuffer(data, np.uint8))
            assert host_codecs.lzw_decode(enc, n).tobytes() == data
            assert host_codecs.lzw_decode(W.lzw(data), n).tobytes() == data
            assert host_codecs.packbits_decode(W.packbits(data), n).tobytes() == data
    with pytest.raises(ValueError, match="short"):
        host_codecs.lzw_decode(W.lzw(data)[:100], n)
    with pytest.raises(ValueError, match="short|truncated"):
        host_codecs.packbits_decode(W.packbits(data)[:100], n)


def test_unsupported_forms_raise(tmp_path):
    rng = np.random.RandomState(7)
    rgb = rng.randint(0, 256, (8, 8, 3))
    cases = [("jpeg", W.tiff(rgb, compression=1, extra_tags=()), 259, 7),
             ("ccitt", W.tiff(rgb[..., :1] % 2, 1, 0), 259, 3),
             ("planar", W.tiff(rgb), 284, 2), ("float", W.tiff(rgb), 339, 3),
             ("ycbcr", W.tiff(rgb), 262, 6), ("cmyk", W.tiff(rng.randint(0, 256, (8, 8, 4)), 8, 5),
                                               None, None),
             ("fill", W.tiff(rgb[..., :1] % 2, 1, 1), 266, 2),
             ("pred3", W.tiff(rgb, compression=5), 317, 3)]
    for name, data, tag, value in cases:
        if tag is not None:          # patch the tag's value in the IFD (or add it)
            data = _with_tag(data, tag, value)
        path = str(tmp_path / f"{name}.tif")
        with open(path, "wb") as fh:
            fh.write(data)
        with pytest.raises(NotImplementedError, match=str(tag) if tag else "262"):
            images.imread(path)
    big = str(tmp_path / "big.tif")
    with open(big, "wb") as fh:
        fh.write(b"II+\x00" + bytes(12))
    with pytest.raises(NotImplementedError, match="BigTIFF"):
        images.imread(big)
    cut = str(tmp_path / "cut.tif")
    with open(cut, "wb") as fh:
        fh.write(W.tiff(rgb, compression=8)[:40])
    with pytest.raises(ValueError, match="cut.tif"):
        images.imread(cut)
    images.require_readable(["a.tif", "x.webp"], "test")    # WebP is read
    with pytest.raises(NotImplementedError, match="x.dng"):
        images.require_readable(["a.tif", "x.dng"], "test")


def _with_tag(data, tag, value):
    """TIFF bytes (little-endian, from the writer) with one SHORT tag set."""
    (off,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, off)
    entries = [data[off + 2 + 12 * i:off + 14 + 12 * i] for i in range(n)]
    entries = [e for e in entries if struct.unpack_from("<H", e)[0] != tag]
    entries.append(struct.pack("<HHIHH", tag, 3, 1, value, 0))
    entries.sort(key=lambda e: struct.unpack_from("<H", e)[0])
    ifd = struct.pack("<H", len(entries)) + b"".join(entries) + struct.pack("<I", 0)
    return data[:4] + struct.pack("<I", len(data)) + data[8:] + ifd
