"""A baseline TIFF codec on numpy, ``zlib`` and the host LZW / PackBits
decoders (``data/host_codecs.py``).

It reads the first image (IFD) of a classic TIFF in either byte order
(``II`` or ``MM``), stored in strips or tiles, planar configuration 1,
compressed with none (1), LZW (5), Deflate (8, 32946) or PackBits (32773),
with predictor 1 or, at 8 and 16 bits, 2 (horizontal differencing), in
these forms:

* gray (photometric 0 or 1) at 1, 2, 4, 8 and 16 bits, and at 8 bits with
  one extra sample;
* RGB (photometric 2) at 8 and 16 bits, with or without a fourth, extra
  sample (alpha: ExtraSamples 2 unassociated, 1 associated, 0 or none);
* palette (photometric 3) at 4 and 8 bits with its 16-bit colormap.

Anything else raises ``NotImplementedError`` naming the tag and its value:
JPEG-in-TIFF (compression 6, 7), CCITT (2-4), planar configuration 2,
float or signed samples, YCbCr, CMYK, BigTIFF.  A corrupt or truncated
file raises ``ValueError``.  The two libraries read these forms apart:

* :func:`imread` is ``cv2.imread(path)``, which reads through libtiff's
  RGBA interface: 16-bit gray keeps its high byte, 16-bit colour rounds
  (``(v + 128) // 257``), photometric 0 inverts, unassociated alpha
  premultiplies the colour, a colormap whose entries are all below 256 is
  taken as 8-bit (else its high bytes); the orientation is applied, but
  5-8 on a non-square image and 2- or 4-bit gray raise, as OpenCV 5.0
  returns None there; a tiled file is turned as OpenCV turns it (each
  tile's columns flipped in place for 2, 3, 6 and 7); partial tiles of
  16-bit gray or gray + alpha raise ``NotImplementedError`` (OpenCV
  misplaces their pixels, and the port does not reproduce that).
* :func:`read_rgb` / :func:`read_samples` are ``Image.open(path)
  .convert("RGB")`` / ``np.array(Image.open(path))`` in Pillow's modes
  (``1``, ``L``, ``I;16``, ``LA``, ``RGB``, ``RGBA``, ``P``): 16-bit colour
  its high byte, 16-bit gray never inverted (and big-endian photometric 0
  unreadable, as in Pillow), associated alpha unpremultiplied; Pillow
  applies every orientation (2-8) on load.  Where Pillow memory-maps a
  file opened by path (one raw strip of ``L``, ``P``, ``I;16`` or
  ``RGBA``), at 5-8 on a non-square image it maps the samples at the
  swapped width and misplaces them: that form raises
  ``NotImplementedError``, from bytes too, as the OpenCV fault above does.
* :func:`size` is PIL's ``.size`` (swapped for orientations 5-8), and so
  is :func:`exif_size`, the JAX ``exif_size`` after ``verify()`` (which
  leaves Pillow no EXIF to swap 6 and 8 back by).
* :func:`imwrite` is ``cv2.imwrite(path, img)``: RGB or gray in strips of
  ``8192 // row bytes`` rows, LZW with predictor 2, the tags libtiff
  writes for OpenCV, in its layout; the bytes equal OpenCV's.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from . import host_codecs
from .jpeg import orient

SIGNATURES = (b"II*\x00", b"MM\x00*")
BIG_SIGNATURES = (b"II+\x00", b"MM\x00+")
COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
TAG_NAMES = {258: "BitsPerSample", 259: "Compression", 262: "PhotometricInterpretation",
             266: "FillOrder", 277: "SamplesPerPixel", 284: "PlanarConfiguration",
             317: "Predictor", 338: "ExtraSamples", 339: "SampleFormat"}
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_FORMATS = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i"}


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def unsupported(path: str, tag: int, value) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: TIFF {TAG_NAMES.get(tag, 'tag')} ({tag}) = {value} is not supported "
        "(the port reads baseline TIFF: see data/tiff.py)")


class Ifd:
    """The tags of a TIFF's first IFD (integer values as tuples) and its
    form: size, samples a pixel, bits, photometric, extra samples,
    orientation, and PIL's mode (None where Pillow cannot open it)."""

    def __init__(self, data: bytes, path: str):
        if data[:4] in BIG_SIGNATURES:
            raise NotImplementedError(f"{path}: BigTIFF is not supported")
        if data[:4] not in SIGNATURES:
            raise ValueError(f"{path}: not a TIFF file")
        self.order = "<" if data[:2] == b"II" else ">"
        try:
            (off,) = struct.unpack_from(self.order + "I", data, 4)
            (n,) = struct.unpack_from(self.order + "H", data, off)
            tags: Dict[int, tuple] = {}
            for i in range(n):
                tag, typ, count, value = struct.unpack_from(self.order + "HHI4s", data,
                                                            off + 2 + 12 * i)
                if typ not in _FORMATS:
                    continue
                nbytes = _SIZES[typ] * count
                if nbytes > 4:
                    (at,) = struct.unpack(self.order + "I", value)
                    value = data[at:at + nbytes]
                    if len(value) < nbytes:
                        raise ValueError(f"{path}: TIFF tag {tag} runs past the file")
                tags[tag] = struct.unpack(self.order + _FORMATS[typ] * count, value[:nbytes])
        except struct.error:
            raise ValueError(f"{path}: truncated TIFF directory") from None
        self.tags, self.path = tags, path
        if 256 not in tags or 257 not in tags:
            raise ValueError(f"{path}: TIFF without ImageWidth / ImageLength")
        self.width, self.height = tags[256][0], tags[257][0]
        self.spp = self.get(277, 1)
        bits = tags.get(258, (1,))
        if len(bits) > self.spp:
            bits = bits[:self.spp]
        elif len(bits) < self.spp and len(bits) == 1:
            bits = bits * self.spp
        self.bits_tuple = bits
        self.photometric = self.get(262, 0)
        self.extra = tags.get(338, ())
        self.orientation = self.get(274, 1)
        self.mode = self._pil_mode()

    def get(self, tag: int, default: int) -> int:
        return self.tags[tag][0] if tag in self.tags else default

    def _pil_mode(self):
        """Pillow's mode for this form (its ``OPEN_INFO``), or None."""
        formats = self.tags.get(339, (1,))
        if len(formats) > 1 and min(formats) == max(formats) == 1:
            formats = (1,)
        if formats != (1,) or self.get(266, 1) != 1 or len(self.bits_tuple) != self.spp:
            return None
        ph, bits, extra = self.photometric, self.bits_tuple, self.extra
        if ph in (0, 1) and bits in ((1,), (2,), (4,), (8,)) and not extra:
            return "1" if bits == (1,) else "L"
        if ph in (0, 1) and bits == (16,) and not extra:
            return None if (ph == 0 and self.order == ">") else "I;16"
        if ph == 1 and bits == (8, 8) and extra == (2,):
            return "LA"
        if ph == 2 and bits in ((8,) * 3, (16,) * 3) and not extra:
            return "RGB"
        if ph == 2 and bits in ((8,) * 4, (16,) * 4):
            return {(): "RGBA", (0,): "RGB", (1,): "RGBa", (2,): "RGBA"}.get(
                extra, "RGBA" if extra == (999,) and bits[0] == 8 else None)
        if ph == 3 and bits in ((1,), (2,), (4,), (8,)) and not extra:
            return "P"
        return None

    def check_decodable(self) -> None:
        """Raise ``NotImplementedError`` on what this codec does not decode."""
        path, t = self.path, self.tags
        comp = self.get(259, 1)
        if comp not in COMPRESSIONS:
            raise unsupported(path, 259, comp)
        for tag, ok in ((284, 1), (266, 1)):
            if self.get(tag, ok) != ok:
                raise unsupported(path, tag, self.get(tag, ok))
        if any(f != 1 for f in t.get(339, (1,))):
            raise unsupported(path, 339, t[339])
        ph, bits = self.photometric, self.bits_tuple
        if ph not in (0, 1, 2, 3):
            raise unsupported(path, 262, ph)
        if len(set(bits)) != 1 or len(bits) != self.spp:
            raise unsupported(path, 258, bits)
        b, spp = bits[0], self.spp
        forms = {0: {1: (1, 2, 4, 8, 16), 2: (8,)}, 1: {1: (1, 2, 4, 8, 16), 2: (8,)},
                 2: {3: (8, 16), 4: (8, 16)}, 3: {1: (4, 8)}}[ph]
        if spp not in forms:
            raise unsupported(path, 277, spp)
        if b not in forms[spp]:
            raise unsupported(path, 258, bits)
        if len(self.extra) != (spp - (3 if ph == 2 else 1)) and self.extra:
            raise unsupported(path, 338, self.extra)
        if self.extra and self.extra[0] not in (0, 1, 2):
            raise unsupported(path, 338, self.extra)
        pred = self.get(317, 1)
        if pred not in (1, 2) or (pred == 2 and b not in (8, 16)):
            raise unsupported(path, 317, pred)
        if ph == 3 and len(t.get(320, ())) != 3 << b:
            raise ValueError(f"{path}: TIFF palette without a colormap of {1 << b} entries")


def _chunk(ifd: Ifd, data: bytes, off: int, count: int, rows: int, row_bytes: int) -> np.ndarray:
    """One strip or tile: (rows, row_bytes) uint8, decompressed and with
    the predictor undone."""
    path, need = ifd.path, rows * row_bytes
    raw = data[off:off + count]
    if len(raw) < count:
        raise ValueError(f"{path}: TIFF strip or tile runs past the file")
    comp = ifd.get(259, 1)
    if comp == 1:
        if len(raw) < need:
            raise ValueError(f"{path}: TIFF strip or tile is {need - len(raw)} bytes short")
        out = np.frombuffer(raw, np.uint8, need)
    elif comp == 5:
        out = host_codecs.lzw_decode(raw, need, path)
    elif comp == 32773:
        out = host_codecs.packbits_decode(raw, need, path)
    else:
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(raw, need), np.uint8)
        except zlib.error as e:
            raise ValueError(f"{path}: corrupt Deflate data ({e})") from None
        if out.size < need:
            raise ValueError(f"{path}: Deflate data ends {need - out.size} bytes short")
    out = out.reshape(rows, row_bytes)
    if ifd.get(317, 1) == 2 and comp in (5, 8, 32946):
        b, spp = ifd.bits_tuple[0], ifd.spp
        if b == 8:
            out = np.cumsum(out.reshape(rows, -1, spp), axis=1, dtype=np.uint8).reshape(rows, -1)
        else:
            v = out.view(ifd.order + "u2").reshape(rows, -1, spp)
            v = np.cumsum(v.astype(np.uint16), axis=1, dtype=np.uint16)
            out = v.astype(ifd.order + "u2").view(np.uint8).reshape(rows, -1)
    return out


def _unpack(rows: np.ndarray, w: int, spp: int, bits: int, order: str) -> np.ndarray:
    """(h, row bytes) -> (h, w, spp) samples (uint16 at 16 bits)."""
    h = rows.shape[0]
    if bits == 16:
        return rows[:, :2 * w * spp].view(order + "u2").astype(np.uint16).reshape(h, w, spp)
    if bits == 8:
        return rows[:, :w * spp].reshape(h, w, spp)
    v = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
    return (v @ (1 << np.arange(bits - 1, -1, -1))).astype(np.uint8)[:, :w * spp].reshape(
        h, w, spp)


def decode_samples(data: bytes, path: str = "<bytes>") -> Tuple[np.ndarray, Ifd]:
    """TIFF bytes -> ((H, W, spp) samples as stored, uint8 or uint16, in the
    file's orientation; the IFD)."""
    ifd = Ifd(data, path)
    ifd.check_decodable()
    t, w, h, spp, b = ifd.tags, ifd.width, ifd.height, ifd.spp, ifd.bits_tuple[0]
    px = np.zeros((h, w, spp), np.uint16 if b == 16 else np.uint8)
    if 324 in t:
        tw, th = ifd.get(322, 0), ifd.get(323, 0)
        if tw <= 0 or th <= 0:
            raise ValueError(f"{path}: TIFF tiles without TileWidth / TileLength")
        offsets, counts = t[324], t.get(325, ())
        across, down = -(-w // tw), -(-h // th)
        if len(offsets) < across * down or len(counts) < across * down:
            raise ValueError(f"{path}: TIFF with fewer tiles than its size needs")
        row_bytes = (tw * spp * b + 7) // 8
        for k in range(across * down):
            y, x = (k // across) * th, (k % across) * tw
            tile = _unpack(_chunk(ifd, data, offsets[k], counts[k], th, row_bytes), tw, spp, b,
                           ifd.order)
            px[y:y + th, x:x + tw] = tile[:h - y, :w - x]
    elif 273 in t:
        rps = min(ifd.get(278, h), h) or h
        offsets, counts = t[273], t.get(279, ())
        n = -(-h // rps)
        if len(offsets) < n or len(counts) < n:
            raise ValueError(f"{path}: TIFF with fewer strips than its size needs")
        row_bytes = (w * spp * b + 7) // 8
        for k in range(n):
            rows = min(rps, h - k * rps)
            px[k * rps:k * rps + rows] = _unpack(
                _chunk(ifd, data, offsets[k], counts[k], rows, row_bytes), w, spp, b, ifd.order)
    else:
        raise ValueError(f"{path}: TIFF without strips or tiles")
    return px, ifd


def _gray8(px: np.ndarray, b: int) -> np.ndarray:
    """Gray samples -> 0-255 as libtiff and Pillow scale 1-, 2- and 4-bit
    ones (16-bit ones are each library's own)."""
    return px * np.uint8(255 // ((1 << b) - 1)) if b < 8 else px


# ---------------------------------------------------------------- OpenCV

def _b16to8(v: np.ndarray) -> np.ndarray:
    """libtiff's ``Bitdepth16To8``."""
    return ((v.astype(np.uint32) + 128) // 257).astype(np.uint8)


def decode_bgr(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_COLOR)`` of TIFF bytes: (H, W, 3) uint8."""
    px, ifd = decode_samples(data, path)
    o, ph, b = ifd.orientation, ifd.photometric, ifd.bits_tuple[0]
    if o in (5, 6, 7, 8) and ifd.width != ifd.height:
        raise ValueError(f"{path}: OpenCV 5.0 cannot read a non-square TIFF with orientation {o}")
    if ph in (0, 1) and b in (2, 4):
        raise ValueError(f"{path}: OpenCV 5.0 cannot read {b}-bit gray TIFF")
    tiled = 324 in ifd.tags
    if tiled and (ifd.width % ifd.get(322, 1) or ifd.height % ifd.get(323, 1)) and (
            (b == 16 and ph in (0, 1)) or ifd.spp == 2):
        raise NotImplementedError(
            f"{path}: OpenCV 5.0 misplaces the pixels of partial tiles of {b}-bit gray"
            f"{' + alpha' if ifd.spp == 2 else ''} TIFF; the port does not reproduce that")
    if ph in (0, 1):
        g = (px[..., 0] >> 8).astype(np.uint8) if b == 16 else _gray8(px[..., 0], b)
        rgb = np.repeat((255 - g if ph == 0 else g)[..., None], 3, 2)
    elif ph == 3:
        cmap = np.asarray(ifd.tags[320], np.uint16).reshape(3, -1).T
        cmap = cmap if (cmap >= 256).any() else cmap << 8
        rgb = (cmap >> 8).astype(np.uint8)[px[..., 0]]
    else:
        c = _b16to8(px) if b == 16 else px
        rgb = c[..., :3]
        if ifd.spp == 4 and ifd.extra == (2,):             # unassociated: premultiplied
            rgb = ((rgb.astype(np.uint32) * c[..., 3:] + 127) // 255).astype(np.uint8)
    if tiled and o != 1:
        rgb = _cv2_tiled_orient(rgb, o, ifd.get(322, 1))
    else:
        rgb = orient(rgb, o)
    return np.ascontiguousarray(rgb[..., ::-1])


def _cv2_tiled_orient(rgb: np.ndarray, o: int, tw: int) -> np.ndarray:
    """A tiled image as OpenCV turns it: libtiff's RGBA tile reads flip each
    tile's own columns for orientations 2, 3, 6 and 7 (the tile kept in its
    place) and the rows of the whole image for 3, 4, 7 and 8; OpenCV then
    turns 5-8 as if that were orientation 1-4 done right."""
    base = (o - 1) % 4 + 1
    out = rgb.copy()
    if base in (2, 3):
        for x in range(0, rgb.shape[1], tw):
            out[:, x:x + tw] = rgb[:, x:x + tw][:, ::-1]
    if base in (3, 4):
        out = out[::-1]
    return orient(orient(out, base), o) if o >= 5 else out


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of a TIFF: (H, W, 3) uint8 BGR."""
    return decode_bgr(_read(path), path)


# ---------------------------------------------------------------- Pillow

def _pil(data: bytes, path: str):
    """(``np.array`` of the image Pillow opens and loads, its IFD)."""
    ifd = Ifd(data, path)
    if ifd.mode is None:
        raise ValueError(f"{path}: Pillow cannot open this TIFF (unknown pixel mode)")
    if ifd.orientation in (5, 6, 7, 8) and ifd.width != ifd.height and _pil_maps(ifd):
        raise NotImplementedError(
            f"{path}: Pillow memory-maps one raw {ifd.mode} strip of a TIFF at orientation "
            f"{ifd.orientation} at its swapped width and misplaces its pixels; the port does "
            "not reproduce that")
    px, _ = decode_samples(data, path)
    mode, ph, b = ifd.mode, ifd.photometric, ifd.bits_tuple[0]
    if mode in ("1", "L"):
        g = _gray8(px[..., 0], b)
        out = (255 - g if ph == 0 else g).astype(bool) if mode == "1" else (
            255 - g if ph == 0 else g)
    elif mode == "I;16":
        out = px[..., 0]
    elif mode == "P":
        out = px[..., 0]
    else:
        c = (px >> 8).astype(np.uint8) if b == 16 else px
        out = c[..., :3] if mode == "RGB" else c
        if mode == "RGBa":
            a = c[..., 3:].astype(np.int32)
            un = np.minimum(c[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
            un = np.where(a == 255, c[..., :3], np.where(a == 0, 0, un))
            out = np.concatenate([un.astype(np.uint8), np.where(a == 0, 0, c[..., 3:])], 2)
    return np.ascontiguousarray(orient(out, ifd.orientation)), ifd


def _pil_maps(ifd: Ifd) -> bool:
    """Whether Pillow loads a file of this form, opened by path, by
    memory-mapping it: one
    uncompressed strip (or tile) whose raw mode is its mode (8-bit ``L``
    and ``P``, 16-bit gray, 8-bit ``RGBA``)."""
    t, b, ph = ifd.tags, ifd.bits_tuple[0], ifd.photometric
    if ifd.get(259, 1) != 1 or len(t.get(324, t.get(273, ()))) != 1:
        return False
    return ((ifd.mode in ("L", "P") and b == 8 and ph != 0) or ifd.mode == "I;16"
            or (ifd.mode == "RGBA" and b == 8 and ifd.extra in ((), (2,), (999,))))


def _pil_rgb(px: np.ndarray, ifd: Ifd) -> np.ndarray:
    if ifd.mode == "P":
        cmap = (np.asarray(ifd.tags[320], np.uint16).reshape(3, -1).T >> 8).astype(np.uint8)
        return cmap[px]
    if ifd.mode == "1":
        return np.repeat((px.astype(np.uint8) * 255)[..., None], 3, 2)
    if ifd.mode == "I;16":
        return np.repeat(np.minimum(px, 255).astype(np.uint8)[..., None], 3, 2)
    if px.ndim == 2 or ifd.mode == "LA":
        return np.repeat((px if px.ndim == 2 else px[..., 0])[..., None], 3, 2)
    return np.ascontiguousarray(px[..., :3])


def decode_rgb(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(BytesIO(data)).convert("RGB"))`` of TIFF
    bytes, the orientation applied."""
    return _pil_rgb(*_pil(data, path))


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))`` of a TIFF."""
    return _pil_rgb(*_pil(_read(path), path))


def read_samples(path: str) -> np.ndarray:
    """``np.array(Image.open(path))`` of a TIFF."""
    return _pil(_read(path), path)[0]


def _header(path: str) -> Ifd:
    ifd = Ifd(_read(path), path)
    if ifd.mode is None:
        try:
            ifd.check_decodable()
        except NotImplementedError:
            return ifd                   # a form this codec leaves to its decoder to refuse
        raise ValueError(f"{path}: Pillow cannot open this TIFF (unknown pixel mode)")
    return ifd


def _size(ifd: Ifd) -> Tuple[int, int]:
    return (ifd.height, ifd.width) if ifd.orientation in (5, 6, 7, 8) else (ifd.width, ifd.height)


def size(path: str) -> Tuple[int, int]:
    """PIL's ``Image.open(path).size``: (w, h), (h, w) for orientations 5-8."""
    return _size(_header(path))


def exif_size(path: str) -> Tuple[int, int]:
    """The JAX ``exif_size`` of a TIFF as its label cache calls it, after
    ``Image.verify()``: :func:`size`.  Pillow's ``getexif`` of a verified
    TIFF raises, and the JAX function then keeps ``.size`` (already
    swapped for 5-8), so 6 and 8 are not swapped back."""
    return size(path)


# ---------------------------------------------------------------- writing

def encode(img: np.ndarray) -> bytes:
    """``cv2.imencode(".tif", img)``: (H, W, 3) BGR as 8-bit RGB and (H, W)
    or (H, W, 1) as 8-bit gray (photometric 1), LZW with predictor 2 in
    strips of ``max(1, min(H, 8192 // row bytes))`` rows, little-endian,
    the strips first, then the IFD and its out-of-line values, as libtiff
    lays them out."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"TIFF writing takes uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"TIFF writing takes (H, W) or (H, W, 3) images, not {img.shape}")
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    rows = (img if spp == 1 else img[..., ::-1]).reshape(h, w, spp)
    step = w * spp
    rps = max(1, min(h, 8192 // step))
    body, offsets, counts = bytearray(), [], []
    for y in range(0, h, rps):
        strip = rows[y:y + rps].astype(np.int16)
        strip[:, 1:] -= rows[y:y + rps, :-1]                  # horizontal differencing
        enc = host_codecs.lzw_encode(strip.astype(np.uint8))
        offsets.append(8 + len(body))
        counts.append(len(enc))
        body += enc
    if len(body) % 2:
        body += b"\x00"
    nstrips = len(offsets)
    short, long_ = 3, 4
    count_type = short if nstrips > 1 and rps * step < 65535 // 10 else long_
    dim = lambda v: (short if v < 65536 else long_, [v])          # noqa: E731
    tags = [(256, *dim(w)), (257, *dim(h)), (258, short, [8] * spp), (259, short, [5]),
            (262, short, [2 if spp == 3 else 1]), (273, long_, offsets), (277, short, [spp]),
            (278, short, [rps]), (279, count_type, counts), (284, short, [1]),
            (317, short, [2]), (339, short, [1] * spp)]
    ifd_at = 8 + len(body)
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    entries, extra = [], {}
    for tag in (258, 279, 273, 339):                   # libtiff's order of out-of-line values
        _, typ, vals = next(x for x in tags if x[0] == tag)
        payload = struct.pack("<" + ("H" if typ == short else "I") * len(vals), *vals)
        if len(payload) > 4:
            extra[tag] = (extra_at, payload)
            extra_at += len(payload)
    for tag, typ, vals in tags:
        payload = struct.pack("<" + ("H" if typ == short else "I") * len(vals), *vals)
        value = (struct.pack("<I", extra[tag][0]) if tag in extra
                 else payload + b"\x00" * (4 - len(payload)))
        entries.append(struct.pack("<HHI", tag, typ, len(vals)) + value)
    out = (b"II*\x00" + struct.pack("<I", ifd_at) + bytes(body) + struct.pack("<H", len(tags))
           + b"".join(entries) + struct.pack("<I", 0))
    return out + b"".join(extra[t][1] for t in (258, 279, 273, 339) if t in extra)


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)`` for ``.tif`` / ``.tiff``.  Returns True,
    as cv2 does."""
    with open(path, "wb") as fh:
        fh.write(encode(img))
    return True
