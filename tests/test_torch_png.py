"""The port's PNG codec (multiyolov5_tpu_torch/data/png.py) against cv2 and PIL.

Files written by cv2 (gray, BGR, BGRA; each row filter alone, and libpng's
choice) and by PIL (modes L, LA, RGB, RGBA
and P: 256 entries, and 8-bit files of 40 and 100 entries, one with ``tRNS``)
from seeded numpy images (noise over gradients), at sizes including 1 x N and N x 1, each decode to exactly
``cv2.imread``'s array.  Files that ``imwrite`` writes decode to exactly
its input in cv2 and in PIL.  cv2's 16-bit and PIL's 4-bit palette files
decode; a corrupt stream and non-PNG files raise (tests/test_torch_png_forms.py
holds every other form).
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from multiyolov5_tpu_torch.data import png

SIZES = [(1, 37), (29, 1), (1, 1), (37, 53), (120, 333)]
# cv2 each row filter alone, and libpng's choice among all of them
FILTERS = ("IMWRITE_PNG_FILTER_SUB", "IMWRITE_PNG_FILTER_UP", "IMWRITE_PNG_FILTER_AVG",
           "IMWRITE_PNG_FILTER_PAETH", "IMWRITE_PNG_ALL_FILTERS")


def _image(rng, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2)[..., None] + np.arange(c) * 40
    noise = rng.randint(0, 6, (h, w, c)) * (rng.rand(h, w, 1) < 0.7)
    img = ((base + noise) % 256).astype(np.uint8)
    img[: h // 3] = rng.randint(0, 256, img[: h // 3].shape)       # a noisy band
    return img


def _filters(path):
    """The row filter of every row of a PNG file."""
    chunks = png._chunks(open(path, "rb").read(), path)
    w, h, _, ctype, _, _, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    stride = 1 + w * png.CHANNELS[ctype]
    return {raw[i * stride] for i in range(h)}


def _written(tmp_path, rng):
    """(path, writer) of every file of the corpus."""
    files = []
    for h, w in SIZES:
        tag = f"{h}x{w}"
        for c in (1, 3, 4):
            for name in FILTERS:
                p = str(tmp_path / f"cv2_{c}_{name}_{tag}.png")
                img = _image(rng, h, w, c)
                assert cv2.imwrite(p, img[..., 0] if c == 1 else img,
                                   [cv2.IMWRITE_PNG_FILTER, getattr(cv2, name)])
                files.append(p)
        for mode, c in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
            p = str(tmp_path / f"pil_{mode}_{tag}.png")
            img = _image(rng, h, w, c)
            Image.fromarray(img[..., 0] if c == 1 else img, mode).save(p)
            files.append(p)
        for n_colours, trns in ((256, False), (40, False), (100, True)):
            p = str(tmp_path / f"pil_P{n_colours}_{trns}_{tag}.png")
            im = Image.fromarray(rng.randint(0, n_colours, (h, w)).astype(np.uint8), "P")
            im.putpalette(list(rng.randint(0, 256, 3 * n_colours)))
            kw = {"transparency": bytes(rng.randint(0, 256, n_colours).tolist())} if trns else {}
            im.save(p, **kw)
            files.append(p)
    return files


def test_decodes_cv2_and_pil_files_as_cv2_does(tmp_path):
    files = _written(tmp_path, np.random.RandomState(0))
    seen = set()
    for p in files:
        want = cv2.imread(p)
        got = png.imread(p)
        assert got.dtype == np.uint8 and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want, err_msg=p)
        seen |= _filters(p)
    assert seen == {0, 1, 2, 3, 4}        # every row filter was undone somewhere


def test_idat_split_over_many_chunks(tmp_path):
    img = _image(np.random.RandomState(1), 31, 17, 3)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    chunks = png._chunks(buf.getvalue(), "x")
    idat = b"".join(b for k, b in chunks if k == b"IDAT")
    data = png.SIGNATURE + png.chunk(b"IHDR", chunks[0][1]) + b"".join(
        png.chunk(b"IDAT", idat[i:i + 7]) for i in range(0, len(idat), 7)) + png.chunk(
        b"IEND", b"")
    p = str(tmp_path / "split.png")
    open(p, "wb").write(data)
    np.testing.assert_array_equal(png.imread(p), cv2.imread(p))


@pytest.mark.parametrize("shape", [(1, 19), (23, 1), (40, 77), (40, 77, 1), (1, 19, 3),
                                   (23, 1, 3), (40, 77, 3)])
def test_imwrite_decodes_exactly_in_cv2_and_pil(tmp_path, shape):
    img = np.random.RandomState(2).randint(0, 256, shape).astype(np.uint8)
    p = str(tmp_path / "out.png")
    assert png.imwrite(p, img)
    gray = len(shape) == 2 or shape[2] == 1
    want = img.reshape(shape[:2]) if gray else img
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), want)
    np.testing.assert_array_equal(np.asarray(Image.open(p)),
                                  want if gray else want[..., ::-1])
    np.testing.assert_array_equal(png.imread(p), cv2.imread(p))


def test_unsupported_files_raise(tmp_path):
    """cv2's 16-bit file and PIL's 4-bit palette file decode to cv2's
    arrays; an IHDR whose interlace byte is flipped on a plain stream (not
    an Adam7 one: its passes need more bytes), a file that is not PNG and
    the writer's wrong inputs raise."""
    img = np.random.RandomState(3).randint(0, 256, (9, 11, 3)).astype(np.uint8)
    p16 = str(tmp_path / "deep.png")
    cv2.imwrite(p16, img.astype(np.uint16) * 257 + np.uint16(3))
    np.testing.assert_array_equal(png.imread(p16), cv2.imread(p16))
    np.testing.assert_array_equal(png.read_samples(p16), np.array(Image.open(p16)))
    p4 = str(tmp_path / "p4.png")
    im = Image.fromarray(np.arange(99).reshape(9, 11).astype(np.uint8) % 7, "P")
    im.putpalette(list(range(21)))
    im.save(p4)                                   # PIL packs 7 colours in 4 bits
    assert png.decode_samples(open(p4, "rb").read()).depth == 4
    np.testing.assert_array_equal(png.imread(p4), cv2.imread(p4))
    np.testing.assert_array_equal(png.read_samples(p4), np.array(Image.open(p4)))
    data = bytearray(png.encode(img))
    data[28] = 1                                  # IHDR's interlace byte
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    pil = str(tmp_path / "interlaced.png")
    open(pil, "wb").write(bytes(data))
    assert cv2.imread(pil) is None
    with pytest.raises(ValueError, match="interlaced.png: bad PNG row filter"):
        png.imread(pil)
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, img)
    with pytest.raises(ValueError, match="not a PNG"):
        png.imread(jpg)
    with pytest.raises(ValueError, match="only PNG"):
        png.imwrite(str(tmp_path / "a.jpg"), img)
    with pytest.raises(ValueError, match="uint8"):
        png.imwrite(str(tmp_path / "f.png"), img.astype(np.float32))
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        png.imwrite(str(tmp_path / "rgba.png"), np.zeros((4, 4, 4), np.uint8))


def test_pil_reads_match_pil(tmp_path):
    """``read_samples`` equals ``np.array(Image.open(p))`` (a palette
    file's indices, gray as (H, W), gray + alpha as (H, W, 2)),
    ``read_rgb`` equals ``Image.open(p).convert("RGB")`` and ``size``
    equals ``Image.open(p).size``, on the whole corpus: cv2's gray, BGR
    and BGRA files and PIL's L, LA, RGB, RGBA and P files."""
    files = _written(tmp_path, np.random.RandomState(4))
    modes = set()
    for p in files:
        with Image.open(p) as im:
            modes.add(im.mode)
            assert png.size(p) == im.size, p
            want = np.array(im)
            want_rgb = np.asarray(im.convert("RGB"))
        got = png.read_samples(p)
        assert got.dtype == np.uint8 and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want, err_msg=p)
        np.testing.assert_array_equal(png.read_rgb(p), want_rgb, err_msg=p)
    assert {"L", "LA", "RGB", "RGBA", "P"} <= modes
    jpg = str(tmp_path / "b.jpg")
    cv2.imwrite(jpg, np.zeros((9, 9, 3), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        png.size(jpg)
