"""The port's WebP codec (``data/webp.py`` + ``csrc/host/webp.cpp``) against
the libraries the JAX package reads and writes WebP with, on the CPU.

Files are made here, seeded: with ``WebPEncode`` through ctypes on the
libwebp Pillow bundles (``_torch_webp_files``: every ``WebPConfig`` option
that changes the bitstream), and containers assembled around its
bitstreams (``ALPH`` planes with each filter, ``EXIF`` orientations,
``ANMF`` frames at offsets).  Every decode is held at 0 differing values:

* :func:`images.imread` against ``cv2.imread``;
* :func:`images.read_rgb` / :func:`images.read_samples` against Pillow's
  ``convert("RGB")`` / ``np.array(Image.open(...))`` (mode ``RGBA`` where
  the file has alpha);
* :func:`images.size` against PIL's ``.size`` and :func:`images.exif_size`
  against the JAX ``exif_size`` as its label cache calls it, after
  ``verify()``.

The lossy settings reach every header form (1-4 segments with their map,
1-8 partitions, no / simple / normal filter, every sharpness), the
lossless ones all four transforms, the colour cache, the entropy image and
backward references; the writer's files decode under cv2, Pillow and the
port to what cv2's own ``.webp`` decodes to.  Tests that need the bundled
libwebp skip where it is not found.
"""

import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

import _torch_webp_files as wf
from multiyolov5_tpu.data.detection import exif_size as jax_exif_size
from multiyolov5_tpu_torch.data import images, webp

needs_libwebp = pytest.mark.skipif(not wf.available(), reason="Pillow's bundled libwebp not found")


def _held(path):
    """Every decode of ``path`` against cv2's and Pillow's; the parsed file."""
    want_cv = cv2.imread(path)
    assert want_cv is not None, path
    got = images.imread(path)
    assert got.shape == want_cv.shape and (got != want_cv).sum() == 0, path
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    got = images.read_rgb(path)
    assert got.shape == rgb.shape and (got != rgb).sum() == 0, path
    with Image.open(path) as im:
        samples, size = np.array(im), im.size
    got = images.read_samples(path)
    assert got.shape == samples.shape and (got != samples).sum() == 0, path
    assert images.size(path) == size
    with Image.open(path) as im:
        im.verify()
        assert images.exif_size(path) == jax_exif_size(im)
    with open(path, "rb") as fh:
        data = fh.read()
    got = images.decode_rgb(data, path)
    assert (got != rgb).sum() == 0
    return webp.parse(data, path)


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


SIZES = [(1, 1), (1, 7), (6, 1), (3, 5), (16, 16), (17, 31), (40, 33)]


@needs_libwebp
@pytest.mark.parametrize("setting", range(len(wf.lossy_settings())))
def test_lossy_settings_equal_libraries(tmp_path, setting):
    """VP8 key frames at each lossy setting, odd sizes from 1 x 1, four
    kinds of picture."""
    rng = np.random.default_rng(setting)
    s = wf.lossy_settings()[setting]
    for i, (h, w) in enumerate(SIZES):
        data = wf.encode(wf.picture(rng, h, w, i % 4), **s)
        p = _held(_write(tmp_path, f"{i}.webp", data))
        assert p.frames[0].kind == b"VP8 " and not p.has_alpha


@needs_libwebp
def test_lossy_settings_reach_every_header_form():
    """Between them the settings reach segments with and without their
    map, 1, 2, 4 and 8 token partitions, no, simple and normal loop
    filters, every sharpness and the skip probability."""
    rng = np.random.default_rng(0)
    seen = {}
    for s in wf.lossy_settings():
        for kind, (h, w) in ((3, (40, 72)), (2, (96, 80))):
            fr = webp.parse(wf.encode(wf.picture(rng, h, w, kind), **s)).frames[0]
            for k, v in webp.bitstream_info(fr).items():
                seen.setdefault(k, set()).add(v)
    assert seen["use_segment"] == seen["update_map"] == {0, 1}
    assert seen["num_parts"] == {1, 2, 4, 8}
    assert seen["filter_type"] == {0, 1, 2}
    assert seen["sharpness"] == set(range(8))
    assert seen["use_skip"] == {0, 1}
    assert len(seen["level"]) >= 8


@needs_libwebp
@pytest.mark.parametrize("filter_type", [0, 1])
def test_loop_filter_deltas_equal_libraries(tmp_path, filter_type):
    """Frames whose header carries reference and mode loop-filter deltas
    (libwebp writes none: the first partition is re-encoded here with
    them), raising, lowering and clamping the i4x4 and i16 levels of every
    segment, under the simple and the normal filter."""
    rng = np.random.default_rng(20 + filter_type)
    img = wf.picture(rng, 64, 96, 3)
    data = wf.encode(img, quality=60, filter_type=filter_type, filter_strength=40, segments=4,
                     sns_strength=80)
    base = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    changed = 0
    for i, (ref, mode) in enumerate((([0] * 4, [0] * 4), ([10, 0, 0, 0], [-7, 0, 0, 0]),
                                     ([-63, 5, 5, 5], [63, 1, 2, 3]), ([30, 0, 0, 0], [30, 0, 0, 0]),
                                     ([-20, 0, 0, 0], [0, 0, 0, 0]))):
        path = _write(tmp_path, f"{i}.webp", wf.with_lf_deltas(data, ref, mode))
        p = _held(path)
        assert webp.bitstream_info(p.frames[0])["use_lf_delta"] == 1
        changed += int((images.imread(path) != base).any())
    assert changed >= 3                                  # the deltas change the filtering


@needs_libwebp
@pytest.mark.parametrize("setting", range(len(wf.alpha_settings())))
def test_alpha_settings_equal_libraries(tmp_path, setting):
    """VP8 + ALPH at each alpha setting (compression 0 / 1, libwebp's
    filter choice, alpha quality 60 sets the pre-processing flag): cv2
    drops the alpha, Pillow opens ``RGBA``."""
    rng = np.random.default_rng(100 + setting)
    s = dict(wf.alpha_settings()[setting], quality=float(20 + 7 * setting))
    methods = set()
    for i, (h, w) in enumerate(SIZES[1:]):
        data = wf.encode(wf.picture(rng, h, w, i % 4, alpha=True), **s)
        p = _held(_write(tmp_path, f"{i}.webp", data))
        assert p.has_alpha and (p.frames[0].alpha[0] >> 4) & 3 == int(s["alpha_quality"] < 100)
        methods.add(p.frames[0].alpha[0] & 3)
    # libwebp stores a plane raw where its VP8L stream would be larger
    assert max(methods) == s["alpha_compression"]


def _alph_filter(a, f):
    """libwebp's forward alpha filters (1 horizontal, 2 vertical, 3
    gradient), the inverse of what the decoder undoes."""
    a = a.astype(np.int32)
    out = a.copy()
    if f == 0:
        return a.astype(np.uint8)
    out[0, 1:] = a[0, 1:] - a[0, :-1]
    for y in range(1, a.shape[0]):
        out[y, 0] = a[y, 0] - a[y - 1, 0]
        if f == 1:
            out[y, 1:] = a[y, 1:] - a[y, :-1]
        elif f == 2:
            out[y, 1:] = a[y, 1:] - a[y - 1, 1:]
        else:
            pred = np.clip(a[y, :-1] + a[y - 1, 1:] - a[y - 1, :-1], 0, 255)
            out[y, 1:] = a[y, 1:] - pred
    return (out & 0xFF).astype(np.uint8)


@needs_libwebp
@pytest.mark.parametrize("method", [0, 1])
@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_alph_filters_equal_libraries(tmp_path, method, filt):
    """ALPH chunks built here with each filter (none, horizontal, vertical,
    gradient) over each compression (raw; a VP8L stream of libwebp's
    lossless encoder, the plane in green), the pre-processing flag set on
    half of them."""
    rng = np.random.default_rng(10 * method + filt)
    for i, (h, w) in enumerate(((1, 1), (5, 9), (23, 17))):
        rgb = wf.picture(rng, h, w, 3)
        alpha = wf.picture(rng, h, w, 1, alpha=True)[..., 3]
        plane = _alph_filter(alpha, filt)
        if method == 0:
            body = plane.tobytes()
        else:
            green = np.zeros((h, w, 3), np.uint8)
            green[..., 1] = plane
            vp8l = dict(wf.chunks(wf.encode(green, lossless=1, exact=1)))[b"VP8L"]
            body = vp8l[5:]                          # the image stream, no header
        head = bytes([method | (filt << 2) | ((i & 1) << 4)])
        vp8 = dict(wf.chunks(wf.encode(rgb, quality=60)))[b"VP8 "]
        data = wf.vp8x(w, h, wf.chunk(b"ALPH", head + body) + wf.chunk(b"VP8 ", vp8), alpha=True)
        path = _write(tmp_path, f"{i}.webp", data)
        _held(path)
        np.testing.assert_array_equal(images.read_samples(path)[..., 3], alpha)


@needs_libwebp
@pytest.mark.parametrize("setting", range(len(wf.lossless_settings())))
def test_lossless_settings_equal_libraries(tmp_path, setting):
    """VP8L at each lossless setting, with and without alpha: the decode
    is the input where alpha is not 0 (``exact`` keeps the rest too)."""
    rng = np.random.default_rng(200 + setting)
    s = wf.lossless_settings()[setting]
    for i, (h, w) in enumerate(SIZES):
        img = wf.picture(rng, h, w, i % 4, alpha=bool(i % 2))
        p = _held(_write(tmp_path, f"{i}.webp", wf.encode(img, **s)))
        got = images.read_samples(str(tmp_path / f"{i}.webp"))
        keep = img[..., 3] > 0 if img.shape[2] == 4 else np.ones((h, w), bool)
        if s["near_lossless"] == 100:
            np.testing.assert_array_equal(got[keep][:, :3], img[keep][:, :3])
        assert p.frames[0].kind == b"VP8L"


@needs_libwebp
def test_lossless_streams_reach_every_tool():
    """Between them the lossless files use all four transforms (predictor,
    cross-colour, subtract-green, colour indexing), the colour cache, an
    entropy image and backward references."""
    rng = np.random.default_rng(7)
    tools = set()
    for s in wf.lossless_settings():
        for kind, (h, w) in zip(range(4), ((64, 96), (80, 64), (48, 72), (96, 96))):
            fr = webp.parse(wf.encode(wf.picture(rng, h, w, kind), **s)).frames[0]
            info = webp.bitstream_info(fr)
            tools |= {f"t{b}" for b in range(4) if info["transforms"] >> b & 1}
            tools |= {k for k in ("cache", "meta") if info[k]}
            tools |= {"copies"} if info["copies"] else set()
    assert tools == {"t0", "t1", "t2", "t3", "cache", "meta", "copies"}


@needs_libwebp
@pytest.mark.parametrize("lossless", [0, 1])
def test_exif_orientations_equal_libraries(tmp_path, lossless):
    """VP8X with an EXIF chunk: orientations 1-8 (and 0, 9), with an
    ``Exif\\0\\0`` prefix (Pillow reads past it, cv2 does not), big-endian,
    before the image, without the VP8X flag (neither reads it); cv2 turns
    the image, Pillow does not, the JAX cache swaps 6 and 8."""
    rng = np.random.default_rng(30 + lossless)
    base = wf.encode(wf.picture(rng, 30, 42, 3, alpha=bool(lossless)), lossless=lossless)
    w, h = 42, 30
    img = wf.image_chunks(base)
    shapes = {}
    for o in range(10):
        for prefix in (False, True):
            p = _held(_write(tmp_path, f"o{o}{prefix:d}.webp", wf.with_exif(base, o, prefix)))
            shapes[(o, prefix)] = images.imread(str(tmp_path / f"o{o}{prefix:d}.webp")).shape
            assert p.exif is not None
    assert shapes[(6, False)] == shapes[(5, False)] == (42, 30, 3)
    assert shapes[(6, True)] == (30, 42, 3)
    for name, body, flag in (
            ("big", img + wf.chunk(b"EXIF", wf.exif_tiff(8, True)), True),
            ("before", wf.chunk(b"EXIF", wf.exif_tiff(6)) + img, True),
            ("noflag", img + wf.chunk(b"EXIF", wf.exif_tiff(6)), False)):
        path = _write(tmp_path, f"{name}.webp", wf.vp8x(w, h, body, alpha=bool(lossless), exif=flag))
        _held(path)
        assert images.exif_size(path) == ((w, h) if name == "noflag" else (h, w))


@needs_libwebp
def test_extended_files_equal_libraries(tmp_path):
    """VP8X still images with ICCP, XMP and unknown chunks (skipped), and
    animations: the first frame at its offset on transparent black,
    whatever the background colour, blend and dispose bits, as both
    libraries compose it; frames lossy, lossy + ALPH and lossless."""
    rng = np.random.default_rng(40)
    base = wf.encode(wf.picture(rng, 30, 40, 3), quality=70)
    body = wf.chunk(b"ICCP", bytes(20)) + wf.chunk(b"ABCD", b"xyz") + wf.image_chunks(base) + \
        wf.chunk(b"XMP ", b"<x/>") + wf.chunk(b"ZZZZ", b"12345")
    _held(_write(tmp_path, "extended.webp", wf.vp8x(40, 30, body, icc=True, xmp=True)))
    frames = [wf.encode(wf.picture(rng, 10, 12, 1, alpha=True), quality=60),
              wf.encode(wf.picture(rng, 30, 40, 2, alpha=True), lossless=1),
              wf.encode(wf.picture(rng, 9, 7, 0), quality=30)]
    cases = [([(frames[0], 4, 6), (frames[1], 0, 0)], 0xFF336699, True),
             ([(frames[0], 0, 0), (frames[2], 2, 2)], 0xFFFFFFFF, False),
             ([(frames[2], 32, 20), (frames[0], 4, 6)], 0x00000000, True),
             ([(frames[1], 0, 0), (frames[0], 4, 6)], 0xFF000000, True),
             ([(frames[2], 2, 4)], 0xFFFFFFFF, False)]
    for i, (fr, bg, alpha) in enumerate(cases):
        data = wf.animation(fr, (40, 30), background=bg, blend=[i % 2 == 0] * len(fr),
                            dispose=[i % 3 == 0] * len(fr), alpha=alpha)
        path = _write(tmp_path, f"anim{i}.webp", data)
        p = _held(path)
        f0 = p.frames[0]
        rgba = webp.decode_rgba(data)
        outside = np.ones((30, 40), bool)
        outside[f0.y:f0.y + f0.height, f0.x:f0.x + f0.width] = False
        assert (rgba[outside] == 0).all()
    with Image.open(str(tmp_path / "anim0.webp")) as im:
        assert im.n_frames == 2


def _annotated(rng, h, w):
    """A frame like the detect app's output: a smooth photo with noise,
    boxes and label bands drawn over it."""
    img = wf.picture(rng, h, w, 3)[..., ::-1].copy()
    for _ in range(6):
        x0, y0 = rng.integers(0, w - 40), rng.integers(0, h - 30)
        x1, y1 = x0 + rng.integers(20, 40), y0 + rng.integers(15, 30)
        c = rng.integers(0, 256, 3)
        img[y0:y0 + 3, x0:x1] = img[y1 - 3:y1, x0:x1] = c
        img[y0:y1, x0:x0 + 3] = img[y0:y1, x1 - 3:x1] = c
        img[max(0, y0 - 12):y0, x0:x0 + 30] = c
    return img


@needs_libwebp
def test_writer_decodes_as_cv2s_file(tmp_path):
    """``imwrite`` of 1, 3 and 4 channels: cv2, Pillow and the port decode
    the file to what they decode cv2's own default ``.webp`` to (1-channel
    images widen to BGR, an alpha of 255 everywhere opens as RGB); under
    alpha 0 the port stores transparent black, and so does cv2's file
    wherever libwebp's predictor leaves it so.  On annotated frames the
    file is at most twice cv2's."""
    rng = np.random.default_rng(50)
    y, x = np.mgrid[:37, :53]
    alpha = np.where((x + y) % 5 == 0, 0, (x * 4) % 256).astype(np.uint8)
    imgs = {"gray": wf.picture(rng, 37, 53, 3)[..., 0],
            "bgr": wf.picture(rng, 37, 53, 1),
            "bgra_opaque": np.concatenate([wf.picture(rng, 37, 53, 2),
                                           np.full((37, 53, 1), 255, np.uint8)], -1),
            "bgra": np.concatenate([wf.picture(rng, 37, 53, 0), alpha[..., None]], -1)}
    for name, img in imgs.items():
        ours, theirs = str(tmp_path / f"{name}.webp"), str(tmp_path / f"{name}_cv2.webp")
        assert images.imwrite(ours, img) is True
        assert cv2.imwrite(theirs, img)
        for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED):
            a, b = cv2.imread(ours, flag), cv2.imread(theirs, flag)
            assert a.shape == b.shape and (a != b).sum() == 0, (name, flag)
        for read in (images.imread, images.read_rgb, images.read_samples):
            a, b = read(ours), read(theirs)
            assert a.shape == b.shape and (a != b).sum() == 0, (name, read)
        with Image.open(ours) as a, Image.open(theirs) as b:
            assert a.mode == b.mode and (np.array(a) != np.array(b)).sum() == 0, name
    for h, w in ((240, 320), (97, 131)):
        frame = _annotated(rng, h, w)
        ours, theirs = str(tmp_path / "f.webp"), str(tmp_path / "f_cv2.webp")
        images.imwrite(ours, frame)
        cv2.imwrite(theirs, frame)
        assert (cv2.imread(ours) != frame).sum() == 0
        assert os.path.getsize(ours) <= 2 * os.path.getsize(theirs)
    with pytest.raises(ValueError, match="1, 3 or 4 channels"):
        images.imwrite(str(tmp_path / "two.webp"), np.zeros((4, 4, 2), np.uint8))


@needs_libwebp
def test_corrupt_files_raise_naming_them(tmp_path):
    """Where cv2 returns None and Pillow raises, the port raises
    ``ValueError`` naming the file: a truncated file, a cut bitstream, a
    chunk past the end, a VP8X canvas unlike its image, a bad VP8L
    version."""
    rng = np.random.default_rng(60)
    lossy = wf.encode(wf.picture(rng, 40, 48, 3), quality=70)
    lossless = wf.encode(wf.picture(rng, 40, 48, 3), lossless=1)
    vp8 = dict(wf.chunks(lossy))[b"VP8 "]
    cut = wf.riff(wf.chunk(b"VP8 ", vp8[:len(vp8) // 3]))
    vp8l = bytearray(dict(wf.chunks(lossless))[b"VP8L"])
    vp8l[4] |= 0x40                                     # version 2
    bad = {"trunc.webp": lossy[:len(lossy) // 2], "cut.webp": cut,
           "canvas.webp": wf.vp8x(41, 40, wf.image_chunks(lossy)),
           "version.webp": wf.riff(wf.chunk(b"VP8L", bytes(vp8l))),
           "lcut.webp": wf.riff(wf.chunk(b"VP8L", dict(wf.chunks(lossless))[b"VP8L"][:40]))}
    for name, data in bad.items():
        path = _write(tmp_path, name, data)
        assert cv2.imread(path) is None, name
        with pytest.raises(Exception):
            with Image.open(path) as im:
                im.load()
        for read in (images.imread, images.read_rgb):
            with pytest.raises(ValueError, match=name):
                read(path)


def test_sizes_and_parse_without_libwebp(tmp_path):
    """The container parser on hand-made headers: a simple VP8L file's
    size and alpha bit, a VP8X canvas, an animation's frame offsets."""
    head = struct.pack("<I", (48 - 1) | ((31 - 1) << 14) | (1 << 28))
    data = wf.riff(wf.chunk(b"VP8L", b"\x2f" + head + bytes(8)))
    p = webp.parse(data)
    assert (p.width, p.height, p.has_alpha) == (48, 31, True)
    path = _write(tmp_path, "h.webp", data)
    assert images.size(path) == images.exif_size(path) == (48, 31)
    assert images.known_signature(data[:12])
    anim = wf.animation([(data, 4, 2)], (60, 40))
    p = webp.parse(anim)
    assert (p.width, p.height) == (60, 40) and (p.frames[0].x, p.frames[0].y) == (4, 2)
    with pytest.raises(ValueError, match="x.webp"):
        webp.parse(data[:30], "x.webp")
