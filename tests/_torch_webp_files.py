"""Seeded WebP files for the port's WebP tests, made with the libraries the
JAX package reads WebP with.

Pillow and cv2 expose few of libwebp's encoder options, so :func:`encode`
calls ``WebPEncode`` through ctypes on the libwebp that Pillow bundles
(``pillow.libs/libwebp-*.so``) with a full ``WebPConfig``: segments,
partitions, filter type, sharpness and strength, the alpha plane's
compression, filter and quality, pre-processing, near-lossless, exact and
sharp YUV.  :func:`riff` / :func:`vp8x` / :func:`animation` wrap its
bitstreams in the container forms (``ALPH``, ``EXIF``, ``ANMF`` at
offsets) the decoders must read.  :func:`available` is False where that
library is not found; the tests that need it skip there.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_CONFIG_FIELDS = (
    "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
    "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
    "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
    "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
    "low_memory", "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")
_FLOATS = ("quality", "target_PSNR")


class WebPConfig(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float if n in _FLOATS else ctypes.c_int) for n in _CONFIG_FIELDS] + [
        ("_pad", ctypes.c_uint32 * 32)]


class WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


class WebPPicture(ctypes.Structure):
    _fields_ = [
        ("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
        ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
        ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
        ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
        ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
        ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
        ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
        ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p),
        ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
        ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2),
        ("_tail", ctypes.c_uint8 * 256)]


_LIB: Optional[ctypes.CDLL] = None
_ABI = 0x0210   # libwebp checks the major byte only


def library() -> Optional[ctypes.CDLL]:
    """The libwebp Pillow bundles, or None."""
    global _LIB
    if _LIB is None:
        try:
            import PIL
        except ImportError:
            return None
        libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
        found = sorted(glob.glob(os.path.join(libs, "libwebp-*.so*")))
        if not found:
            return None
        for dep in sorted(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))):
            ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
        lib = ctypes.CDLL(found[0])
        lib.WebPConfigInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int]
        lib.WebPPictureInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.WebPPictureImportRGBA.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.WebPPictureImportRGB.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.WebPEncode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.WebPPictureFree.argtypes = [ctypes.c_void_p]
        lib.WebPMemoryWriterClear.argtypes = [ctypes.c_void_p]
        lib.WebPMemoryWriterInit.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def available() -> bool:
    return library() is not None


def encode(img: np.ndarray, **options) -> bytes:
    """A WebP file of (H, W, 3) RGB or (H, W, 4) RGBA uint8 from
    ``WebPEncode`` with the default config at ``quality`` (75) changed by
    ``options`` (``WebPConfig`` field names)."""
    lib = library()
    cfg = WebPConfig()
    quality = float(options.pop("quality", 75.0))
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, quality, _ABI)
    for k, v in options.items():
        assert k in _CONFIG_FIELDS, k
        setattr(cfg, k, v)
    pic = WebPPicture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI)
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    pic.width, pic.height = w, h
    pic.use_argb = int(bool(cfg.lossless))
    imp = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert imp(ctypes.byref(pic), img.ctypes.data, w * c)
    wr = WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.cast(ctypes.byref(wr), ctypes.c_void_p).value
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    data = ctypes.string_at(wr.mem, wr.size) if ok else b""
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(wr))
    assert ok, f"WebPEncode failed ({pic.error_code})"
    return data


# ---------------------------------------------------------------- containers

def chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\x00" * (len(body) & 1)


def chunks(data: bytes) -> List[Tuple[bytes, bytes]]:
    """The top-level chunks of a WebP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, (n,) = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def image_chunks(data: bytes) -> bytes:
    """The ALPH + VP8 / VP8L chunks of a WebP file's image."""
    return b"".join(chunk(t, b) for t, b in chunks(data) if t in (b"ALPH", b"VP8 ", b"VP8L"))


def vp8x(width: int, height: int, body: bytes, alpha: bool = False, exif: bool = False,
         animation: bool = False, icc: bool = False, xmp: bool = False) -> bytes:
    flags = (0x20 * icc) | (0x10 * alpha) | (0x08 * exif) | (0x04 * xmp) | (0x02 * animation)
    head = struct.pack("<I", flags) + (width - 1).to_bytes(3, "little") + \
        (height - 1).to_bytes(3, "little")
    return riff(chunk(b"VP8X", head) + body)


def exif_tiff(orientation: int, big_endian: bool = False) -> bytes:
    """A TIFF structure with IFD0's orientation tag (an EXIF chunk's body)."""
    o = ">" if big_endian else "<"
    return (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(o + "I", 8) + \
        struct.pack(o + "H", 1) + struct.pack(o + "HHIHH", 0x0112, 3, 1, orientation, 0) + \
        struct.pack(o + "I", 0)


def with_exif(data: bytes, orientation: int, prefix: bool = False) -> bytes:
    """A still WebP file as VP8X with an EXIF chunk after its image."""
    w, h = _size(data)
    has_alpha = any(t == b"ALPH" for t, _ in chunks(data)) or _vp8l_alpha(data)
    body = (b"Exif\x00\x00" if prefix else b"") + exif_tiff(orientation)
    return vp8x(w, h, image_chunks(data) + chunk(b"EXIF", body), alpha=has_alpha, exif=True)


def animation(frames: Sequence[Tuple[bytes, int, int]], canvas: Tuple[int, int],
              background: int = 0xFFFFFFFF, blend: Sequence[bool] = (),
              dispose: Sequence[bool] = (), alpha: bool = True) -> bytes:
    """An animated WebP file of (still WebP file, x, y) frames (x and y
    even) on a (width, height) canvas."""
    body = chunk(b"ANIM", struct.pack("<IH", background, 0))
    for i, (data, x, y) in enumerate(frames):
        w, h = _size(data)
        flags = (0 if (blend[i] if i < len(blend) else True) else 2) | \
            (1 if (dispose[i] if i < len(dispose) else False) else 0)
        head = (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + \
            (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little") + \
            (100).to_bytes(3, "little") + bytes([flags])
        body += chunk(b"ANMF", head + image_chunks(data))
    return vp8x(canvas[0], canvas[1], body, alpha=alpha, animation=True)


def _size(data: bytes) -> Tuple[int, int]:
    for t, b in chunks(data):
        if t == b"VP8 ":
            w, h = struct.unpack("<HH", b[6:10])
            return w & 0x3FFF, h & 0x3FFF
        if t == b"VP8L":
            (bits,) = struct.unpack("<I", b[1:5])
            return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
        if t == b"VP8X":
            return 1 + int.from_bytes(b[4:7], "little"), 1 + int.from_bytes(b[7:10], "little")
    raise ValueError("no image")


def _vp8l_alpha(data: bytes) -> bool:
    for t, b in chunks(data):
        if t == b"VP8L":
            return bool((struct.unpack("<I", b[1:5])[0] >> 28) & 1)
    return False


# ---------------------------------------------------------------- VP8 header rewrites

class BoolEncoder:
    """RFC 6386 section 7.3's boolean entropy encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.put(128, (v >> i) & 1)

    def finish(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def with_lf_deltas(data: bytes, ref: Sequence[int], mode: Sequence[int]) -> bytes:
    """A simple lossy WebP file whose VP8 frame header carries loop-filter
    deltas (4 reference-frame, 4 mode deltas; libwebp's encoder writes
    none): the first partition re-encoded from the decoder's trace of it
    with the delta fields in place of the cleared flag."""
    from multiyolov5_tpu_torch.data import webp
    vp8 = dict(chunks(data))[b"VP8 "]
    bits, at = webp.first_partition_bits(vp8)
    assert bits[at] == 256, "the frame already has loop-filter deltas"   # prob 128, bit 0
    enc = BoolEncoder()
    for b in bits[:at]:
        enc.put(int(b) >> 1, int(b) & 1)
    enc.put(128, 1)                      # use_lf_delta
    enc.put(128, 1)                      # update them
    for d in list(ref) + list(mode):
        enc.put(128, 1)
        enc.value(abs(d), 6)
        enc.put(128, int(d < 0))
    for b in bits[at + 1:]:
        enc.put(int(b) >> 1, int(b) & 1)
    part0 = enc.finish()
    tag = vp8[0] | (vp8[1] << 8) | (vp8[2] << 16)
    old = tag >> 5
    tag = (tag & 0x1F) | (len(part0) << 5)
    body = bytes([tag & 0xFF, (tag >> 8) & 0xFF, tag >> 16]) + vp8[3:10] + part0 + vp8[10 + old:]
    return riff(chunk(b"VP8 ", body))


# ---------------------------------------------------------------- images

def picture(rng: np.random.Generator, h: int, w: int, kind: int, alpha: bool = False) -> np.ndarray:
    """A seeded test picture: 0 noise, 1 smooth gradients with noise, 2 flat
    blocks with edges (few colours), 3 a photo-like mix; RGBA with a varied
    alpha (zero areas, ramps) where ``alpha``."""
    y, x = np.mgrid[:h, :w]
    if kind == 0:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif kind == 1:
        img = np.stack([(x * 3 + y) % 256, (y * 2 + x) % 256, (x * y // 7) % 256], -1)
        img = (img + rng.integers(0, 12, img.shape)).astype(np.uint8)
    elif kind == 2:
        pal = rng.integers(0, 256, (int(rng.integers(2, 20)), 3))
        idx = ((x // max(1, w // 5)) + 3 * (y // max(1, h // 4))) % len(pal)
        img = pal[idx].astype(np.uint8)
    else:
        base = np.stack([128 + 100 * np.sin(x / 9.0 + c) * np.cos(y / 13.0 - c) for c in range(3)], -1)
        img = np.clip(base + rng.normal(0, 18, base.shape), 0, 255).astype(np.uint8)
    if not alpha:
        return img
    a = np.clip((x * 255) // max(1, w - 1) + rng.integers(-30, 30, (h, w)), 0, 255)
    a[(x + y) % 7 == 0] = 0
    a[: h // 3, : w // 3] = 255
    return np.concatenate([img, a[..., None].astype(np.uint8)], -1)


def lossy_settings() -> List[Dict]:
    """``WebPConfig`` settings that between them reach every VP8 header
    form: 1-4 segments, 1-8 partitions, simple and normal filters, every
    sharpness, fixed and automatic strengths, and no filter."""
    out = []
    for i in range(16):
        out.append(dict(quality=float([5, 30, 55, 75, 90, 100][i % 6]), segments=1 + i % 4,
                        partitions=i % 4, filter_type=(i // 2) % 2, filter_sharpness=i % 8,
                        filter_strength=[0, 20, 60, 100][(i // 3) % 4], autofilter=int(i % 5 == 1),
                        sns_strength=[0, 50, 100][i % 3], method=i % 7,
                        preprocessing=i % 3, use_sharp_yuv=int(i % 4 == 3)))
    return out


def alpha_settings() -> List[Dict]:
    """The ALPH chunk's forms: compression 0 / 1, filters 0-2 (none, fast,
    best: libwebp picks horizontal, vertical or gradient), alpha quality
    (below 100 sets the pre-processing flag)."""
    return [dict(alpha_compression=c, alpha_filtering=f, alpha_quality=q)
            for c in (0, 1) for f in (0, 1, 2) for q in (100, 60)]


def lossless_settings() -> List[Dict]:
    """Lossless settings: methods 0-6 (the transform and cache searches),
    near-lossless, exact, the delta palette."""
    return [dict(lossless=1, method=m, quality=float(q), exact=e, near_lossless=nl)
            for m, q, e, nl in [(0, 0, 0, 100), (1, 25, 1, 100), (2, 50, 0, 100), (3, 75, 1, 60),
                                (4, 90, 0, 100), (5, 100, 1, 100), (6, 100, 0, 40), (4, 100, 1, 100)]]
