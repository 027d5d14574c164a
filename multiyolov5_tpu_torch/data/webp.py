"""A WebP codec of the port's own, equal to libwebp's output.

The JAX package reads WebP through ``cv2.imread`` and ``Image.open`` and
writes it through ``cv2.imwrite``; both libraries run libwebp.  This module
reads what they read and writes what cv2 writes, with no cv2 or PIL:

* the RIFF container is parsed here: a simple file (one ``VP8 `` or
  ``VP8L`` chunk) or an extended one (``VP8X``, with ``ALPH``, ``ICCP``,
  ``EXIF``, ``XMP ``, ``ANIM`` and ``ANMF`` chunks; chunks it does not know
  are skipped, as libwebp skips them);
* the bitstreams are decoded in host C++, ``csrc/host/webp.cpp``, built with
  g++ into ``build/host/`` at first use (``utils/shared_library.py``) and
  bound through ctypes: VP8L (lossless: prefix codes, the entropy image,
  LZ77 references, the colour cache, the predictor, cross-colour,
  subtract-green and colour-indexing transforms), VP8 (a lossy key frame,
  RFC 6386, with libwebp's loop filters, fancy upsampler and 14-bit
  YUV -> RGB), and the ``ALPH`` plane (raw or VP8L-coded, with its
  horizontal, vertical or gradient filter; alpha dithering is off in cv2
  and PIL alike, so the pre-processing flag changes nothing).

Entry points (named as in ``data/png.py``):

* :func:`imread` is ``cv2.imread(path)``: (H, W, 3) uint8 BGR, alpha
  dropped, turned by the ``EXIF`` chunk's orientation as OpenCV 5.0 turns it;
* :func:`decode_rgb` / :func:`read_rgb` are ``Image.open(...).convert("RGB")``:
  no orientation applied; :func:`read_samples` is ``np.array(Image.open(path))``,
  ``RGBA`` where the file says it has alpha (a ``VP8X`` flag, an ``ALPH``
  chunk, a VP8L header bit), else ``RGB``;
* an animation reads as its first frame, as both libraries compose it: the
  frame at its offset on a canvas of transparent black;
* :func:`size` is PIL's ``.size`` (the canvas), :func:`exif_size` the JAX
  ``exif_size`` after ``Image.verify()`` (w and h swapped for orientations 6
  and 8);
* :func:`imwrite` is ``cv2.imwrite`` of a ``.webp`` at its defaults: a
  lossless VP8L file (1-channel images as BGR, as cv2 widens them).  The
  bytes are not libwebp's (its encoder picks its transforms by cost
  searches), but every pixel decodes to what cv2's file decodes to: where
  alpha is 0 the pixel is stored as transparent black.  libwebp's encoder
  stores there whatever RGB its predictor search left, which no other
  encoder can know, so the RGB under zero alpha is the one place the two
  files may differ.

A corrupt or truncated file raises ``ValueError`` naming the file.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..utils.shared_library import host_library
from .jpeg import exif_orientation, orient

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "webp.cpp"
MAX_SIDE = 16383                # the format's largest width and height
ALPHA_FLAG, EXIF_FLAG, ANIMATION_FLAG = 0x10, 0x08, 0x02


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32, s = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_char_p
    for fn in (lib.mkw_vp8l_decode, lib.mkw_vp8_decode, lib.mkw_alpha_decode):
        fn.argtypes = [p, i64, i32, i32, p, s, i32]
        fn.restype = i32
    lib.mkw_vp8l_encode.argtypes = [p, i32, i32, i32, p, i64, p, s, i32]
    for fn in (lib.mkw_vp8l_encode, lib.mkw_vp8_info, lib.mkw_vp8l_info):
        fn.restype = i32
    for fn in (lib.mkw_vp8_info, lib.mkw_vp8l_info):
        fn.argtypes = [p, i64, p, s, i32]
    lib.mkw_vp8_trace.argtypes = [p, i64, p, i64, p, p, s, i32]
    lib.mkw_vp8_trace.restype = i32


_LIB = host_library(SOURCE, "libmultiyolov5_webp", _bind)


def library() -> ctypes.CDLL:
    """The codec's host library, built from ``csrc/host/webp.cpp`` if this
    process has not loaded it yet."""
    return _LIB.load()


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


# ---------------------------------------------------------------- the container

@dataclass
class Frame:
    """One image of a file: its bitstream chunk and, for VP8, its ALPH."""
    kind: bytes                 # b"VP8 " or b"VP8L"
    payload: bytes
    width: int
    height: int
    x: int = 0
    y: int = 0
    alpha: Optional[bytes] = None


@dataclass
class Parsed:
    width: int                  # the canvas
    height: int
    has_alpha: bool             # as WebPGetFeatures reports it (PIL's RGBA)
    frames: List[Frame] = field(default_factory=list)
    exif: Optional[bytes] = None


def _chunks(data: bytes, start: int, end: int, path: str):
    pos = start
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if pos + 8 + size > end:
            raise ValueError(f"{path}: WebP chunk {tag!r} runs past the end of the file")
        yield tag, data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


def _bitstream_size(kind: bytes, payload: bytes, path: str) -> Tuple[int, int]:
    """(width, height) from a VP8 frame header or a VP8L header."""
    if kind == b"VP8L":
        if len(payload) < 5 or payload[0] != 0x2F:
            raise ValueError(f"{path}: not a VP8L bitstream")
        (bits,) = struct.unpack("<I", payload[1:5])
        if bits >> 29:
            raise ValueError(f"{path}: unsupported VP8L version {bits >> 29}")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{path}: not a VP8 key frame")
    w, h = struct.unpack("<HH", payload[6:10])
    return w & 0x3FFF, h & 0x3FFF


def _image(chunks, path: str, allow_alpha: bool) -> Frame:
    """The image of a chunk sequence: its first VP8 / VP8L chunk and the
    ALPH chunk before it."""
    alpha = None
    for tag, body in chunks:
        if tag == b"ALPH":
            alpha = body
        elif tag in (b"VP8 ", b"VP8L"):
            w, h = _bitstream_size(tag, body, path)
            return Frame(tag, body, w, h, alpha=alpha if allow_alpha and tag == b"VP8 " else None)
    raise ValueError(f"{path}: WebP file without image data")


def parse(data: bytes, path: str = "<bytes>") -> Parsed:
    """The chunks of WebP bytes that a decode needs."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{path}: not a WebP file")
    (riff,) = struct.unpack("<I", data[4:8])
    if riff < 12:
        raise ValueError(f"{path}: RIFF size too small")
    if riff > len(data) - 8:
        raise ValueError(f"{path}: truncated WebP file ({len(data)} of {riff + 8} bytes)")
    chunks = list(_chunks(data, 12, riff + 8, path))
    if not chunks:
        raise ValueError(f"{path}: WebP file without chunks")
    tag, body = chunks[0]
    if tag in (b"VP8 ", b"VP8L"):
        fr = _image(chunks[:1], path, False)
        alpha = tag == b"VP8L" and bool((struct.unpack("<I", body[1:5])[0] >> 28) & 1)
        return Parsed(fr.width, fr.height, alpha, [fr])
    if tag != b"VP8X":
        raise ValueError(f"{path}: WebP file starts with an unknown chunk {tag!r}")
    if len(body) < 10:
        raise ValueError(f"{path}: VP8X chunk too short")
    flags = body[0]
    cw = 1 + int.from_bytes(body[4:7], "little")
    ch = 1 + int.from_bytes(body[7:10], "little")
    # the first EXIF chunk, read only where the VP8X flag says there is one
    exif = next((b for t, b in chunks if t == b"EXIF"), None) if flags & EXIF_FLAG else None
    rest = chunks[1:]
    if flags & ANIMATION_FLAG:
        frames = []
        for t, b in rest:
            if t != b"ANMF":
                continue
            if len(b) < 16:
                raise ValueError(f"{path}: ANMF chunk too short")
            x = 2 * int.from_bytes(b[0:3], "little")
            y = 2 * int.from_bytes(b[3:6], "little")
            fw = 1 + int.from_bytes(b[6:9], "little")
            fh = 1 + int.from_bytes(b[9:12], "little")
            fr = _image(_chunks(b, 16, len(b), path), path, True)
            if (fr.width, fr.height) != (fw, fh):
                raise ValueError(f"{path}: ANMF frame size differs from its bitstream's")
            if x + fw > cw or y + fh > ch:
                raise ValueError(f"{path}: ANMF frame runs past the canvas")
            fr.x, fr.y = x, y
            frames.append(fr)
        if not frames:
            raise ValueError(f"{path}: animated WebP file without frames")
        return Parsed(cw, ch, bool(flags & ALPHA_FLAG), frames, exif)
    fr = _image(rest, path, True)
    if (fr.width, fr.height) != (cw, ch):
        raise ValueError(f"{path}: VP8X canvas {cw}x{ch} differs from the image's "
                         f"{fr.width}x{fr.height}")
    alpha = bool(flags & ALPHA_FLAG) or fr.alpha is not None
    return Parsed(cw, ch, alpha, [fr], exif)


# ---------------------------------------------------------------- decoding

def _call(fn, payload: bytes, w: int, h: int, out: np.ndarray, path: str, what: str) -> None:
    src = np.frombuffer(payload, np.uint8)
    err = ctypes.create_string_buffer(256)
    if fn(_ptr(src), src.size, w, h, _ptr(out), err, len(err)):
        raise ValueError(f"{path}: {what}: {err.value.decode()}")


def decode_frame(fr: Frame, path: str = "<bytes>") -> np.ndarray:
    """(h, w, 4) uint8 RGBA of one frame, not premultiplied."""
    lib = library()
    w, h = fr.width, fr.height
    if fr.kind == b"VP8L":
        argb = np.zeros(w * h, np.uint32)
        _call(lib.mkw_vp8l_decode, fr.payload, w, h, argb, path, "VP8L")
        return argb.view(np.uint8).reshape(h, w, 4)[..., [2, 1, 0, 3]]
    out = np.empty((h, w, 4), np.uint8)
    rgb = np.zeros((h, w, 3), np.uint8)
    _call(lib.mkw_vp8_decode, fr.payload, w, h, rgb, path, "VP8")
    out[..., :3] = rgb
    if fr.alpha is None:
        out[..., 3] = 255
    else:
        a = np.zeros(w * h, np.uint8)
        _call(lib.mkw_alpha_decode, fr.alpha, w, h, a, path, "ALPH")
        out[..., 3] = a.reshape(h, w)
    return out


VP8_INFO = ("use_segment", "update_map", "num_parts", "filter_type", "level", "sharpness",
            "use_lf_delta", "use_skip")
VP8L_INFO = ("transforms", "cache", "meta", "copies")


def bitstream_info(fr: Frame, path: str = "<bytes>") -> dict:
    """What a frame's bitstream chose, for tests of coverage: a VP8 frame's
    header fields (:data:`VP8_INFO`; ``filter_type`` 0 none, 1 simple, 2
    normal) or what a VP8L stream used (:data:`VP8L_INFO`; ``transforms`` a
    bit per transform type: 1 predictor, 2 cross-colour, 4 subtract-green,
    8 colour indexing)."""
    names = VP8L_INFO if fr.kind == b"VP8L" else VP8_INFO
    fn = library().mkw_vp8l_info if fr.kind == b"VP8L" else library().mkw_vp8_info
    out = np.zeros(len(names), np.int32)
    src = np.frombuffer(fr.payload, np.uint8)
    err = ctypes.create_string_buffer(256)
    if fn(_ptr(src), src.size, _ptr(out), err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    return dict(zip(names, out.tolist()))


def first_partition_bits(payload: bytes, path: str = "<bytes>") -> Tuple[np.ndarray, int]:
    """The bits of a VP8 frame's first partition as a decode reads them,
    ``(prob << 1) | bit`` each, and the index of the loop-filter-delta flag
    among them: for tests that re-encode the partition with other header
    fields."""
    src = np.frombuffer(payload, np.uint8)
    err = ctypes.create_string_buffer(256)
    count, at = ctypes.c_int64(0), ctypes.c_int64(0)
    cap = 64 * len(payload) + 4096
    out = np.zeros(cap, np.uint16)
    if library().mkw_vp8_trace(_ptr(src), src.size, _ptr(out), cap, ctypes.byref(count),
                               ctypes.byref(at), err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    if count.value > cap:
        raise ValueError(f"{path}: {count.value} first-partition bits, more than {cap}")
    return out[:count.value], at.value


def decode_rgba(data: bytes, path: str = "<bytes>", parsed: Optional[Parsed] = None) -> np.ndarray:
    """(H, W, 4) RGBA of the canvas: the image, or an animation's first frame
    at its offset on transparent black."""
    p = parsed or parse(data, path)
    fr = p.frames[0]
    img = decode_frame(fr, path)
    if (fr.x, fr.y, fr.width, fr.height) == (0, 0, p.width, p.height):
        return img
    canvas = np.zeros((p.height, p.width, 4), np.uint8)
    canvas[fr.y:fr.y + fr.height, fr.x:fr.x + fr.width] = img
    return canvas


def orientation(p: Parsed, pil: bool) -> Optional[int]:
    """The ``EXIF`` chunk's orientation, or None: its TIFF structure as cv2
    reads it, or (``pil``) also after an ``Exif\\0\\0`` prefix, which PIL's
    ``getexif`` skips and cv2 does not."""
    if not p.exif:
        return None
    tiff = p.exif[6:] if pil and p.exif.startswith(b"Exif\x00\x00") else p.exif
    return exif_orientation(tiff)


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def decode_rgb(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(BytesIO(data)).convert("RGB"))`` of WebP
    bytes: no orientation applied, alpha dropped."""
    return np.ascontiguousarray(decode_rgba(data, path)[..., :3])


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))`` of a WebP file."""
    return decode_rgb(_read(path), path)


def read_samples(path: str) -> np.ndarray:
    """``np.array(Image.open(path))`` of a WebP file: (H, W, 4) RGBA where
    the file has alpha, else (H, W, 3) RGB."""
    data = _read(path)
    p = parse(data, path)
    rgba = decode_rgba(data, path, p)
    return rgba if p.has_alpha else np.ascontiguousarray(rgba[..., :3])


def decode_bgr(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_COLOR)`` of WebP bytes: (H, W, 3) uint8
    BGR, alpha dropped, the EXIF orientation applied."""
    p = parse(data, path)
    rgb = decode_rgba(data, path, p)[..., 2::-1]
    return np.ascontiguousarray(orient(rgb, orientation(p, pil=False)))


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of a WebP file."""
    return decode_bgr(_read(path), path)


def size(path: str) -> Tuple[int, int]:
    """(width, height) of the canvas, as PIL's ``Image.open(path).size``."""
    p = parse(_read(path), path)
    return p.width, p.height


def exif_size(path: str) -> Tuple[int, int]:
    """The JAX ``exif_size(Image.open(path))``: (w, h), swapped for EXIF
    orientations 6 and 8 only."""
    p = parse(_read(path), path)
    if orientation(p, pil=True) in (6, 8):
        return p.height, p.width
    return p.width, p.height


# ---------------------------------------------------------------- encoding

def encode_lossless(rgba: np.ndarray) -> bytes:
    """A lossless WebP file (one VP8L chunk) of (H, W, 4) RGBA, its alpha bit
    set where any alpha is below 255."""
    h, w = rgba.shape[:2]
    if not (1 <= w <= MAX_SIDE and 1 <= h <= MAX_SIDE):
        raise ValueError(f"a WebP image is at most {MAX_SIDE} x {MAX_SIDE} pixels, not {w} x {h}")
    bgra = np.ascontiguousarray(rgba[..., [2, 1, 0, 3]])
    argb = bgra.view(np.uint32).reshape(-1)
    cap = w * h * 8 + 65536            # past 4.5 bytes a pixel, the prefix codes' worst
    out = np.zeros(cap, np.uint8)
    n = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    alpha = int((rgba[..., 3] != 255).any())
    if library().mkw_vp8l_encode(_ptr(argb), w, h, alpha, _ptr(out), cap, ctypes.byref(n),
                                 err, len(err)):
        raise ValueError(f"VP8L encode: {err.value.decode()}")
    body = out[:n.value].tobytes() + b"\x00" * (n.value & 1)
    chunk = b"VP8L" + struct.pack("<I", n.value) + body
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)`` of a ``.webp`` at cv2's defaults (lossless):
    (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8.  Returns True, as cv2
    does."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: the WebP writer takes uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"{path}: the WebP writer takes 1, 3 or 4 channels, not shape {img.shape}")
    rgba = np.empty(img.shape[:2] + (4,), np.uint8)
    rgba[..., :3] = img[..., 2::-1]
    rgba[..., 3] = img[..., 3] if img.shape[2] == 4 else 255
    rgba[rgba[..., 3] == 0] = 0
    data = encode_lossless(rgba)
    with open(path, "wb") as fh:
        fh.write(data)
    return True
