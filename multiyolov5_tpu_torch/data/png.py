"""A PNG codec on the standard library (``zlib``, ``struct``) and numpy.

The app reads and writes its images with it (``cv2.imread`` /
``cv2.imwrite`` in multiyolov5_tpu/data/sources.py:83 and
multiyolov5_tpu/cli/detect.py:132-138), so it needs no cv2 or PIL.

* :func:`imread` reads 8-bit gray, gray + alpha, RGB, RGBA and palette
  files without interlacing, and returns what ``cv2.imread(path)``
  (``IMREAD_COLOR``) returns: (H, W, 3) uint8 BGR, gray replicated, alpha
  dropped without blending, a palette expanded (its ``tRNS`` ignored).
* :func:`imwrite` writes (H, W) or (H, W, 1) uint8 as 8-bit gray and
  (H, W, 3) uint8, taken as BGR, as 8-bit RGB.
* :func:`read_samples` returns the stored samples, as
  ``np.array(Image.open(path))`` does: gray (H, W), gray + alpha (H, W,
  2), RGB (H, W, 3), RGBA (H, W, 4), and a palette file's indices (H, W),
  not its colours.  The seg loaders read their masks with it.
* :func:`read_rgb` returns ``np.asarray(Image.open(path).convert("RGB"))``:
  (H, W, 3) uint8 RGB, gray replicated, a palette expanded, alpha dropped
  (:func:`decode_rgb` the same of PNG bytes).
* :func:`size` reads the IHDR chunk only: ``(width, height)``, as PIL's
  ``Image.open(path).size``.  An ``eXIf`` chunk's rotation, which the JAX
  loader's ``exif_size`` applies through PIL, is not honoured.

Anything else raises ``ValueError`` naming what is not supported:
interlaced files, bit depths other than 8, other colour types, files that
are not PNG.  The decoded pixels are cv2's; the file bytes need not be.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (gray, RGB, palette, gray + alpha, RGBA)
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def chunk(kind: bytes, body: bytes) -> bytes:
    """One chunk: length, type, body, CRC."""
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _chunks(data: bytes, path: str) -> List[Tuple[bytes, bytes]]:
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (only PNG is supported)")
    out, pos = [], 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        out.append((kind, body))
        pos += 12 + n
        if kind == b"IEND":
            break
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five row filters: (h, 1 + stride) filtered bytes -> (h,
    stride) uint8.  Each byte depends on its left neighbour (a), the byte
    above (b) and the one above-left (c).  Without Average and Paeth rows,
    each row is one vector step (Sub a running sum along it, Up a sum with
    the row above, in uint8 arithmetic that wraps as the filters do).  With
    them, the bytes of one anti-diagonal of pixels (row + column constant)
    are independent: the loop runs over the h + w - 1 diagonals, each a
    vector over its pixels."""
    ftype = raw[:, 0].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError(f"bad PNG row filter {int(ftype.max())}")
    if (ftype <= 2).all():
        rec = raw[:, 1:].reshape(h, -1, bpp).copy()
        for r in np.flatnonzero(ftype):
            if ftype[r] == 1:
                rec[r] = np.cumsum(rec[r], axis=0, dtype=np.uint8)
            elif r:
                rec[r] += rec[r - 1]
        return rec.reshape(h, -1)
    filt = raw[:, 1:].reshape(h, -1, bpp).astype(np.int32)
    w = filt.shape[1]
    # one row and one pixel of zeros before the image: a and b of the edges
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    rows = np.arange(h)
    for d in range(h + w - 1):
        r = rows[max(0, d - w + 1):min(h, d + 1)]
        x = d - r
        a, b, c = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[r][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        rec[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return rec[1:, 1:].reshape(h, -1).astype(np.uint8)


def _samples(data: bytes, path: str):
    """PNG bytes -> ((H, W, C) uint8 samples as stored, the (256, 3)
    palette of a palette file or None)."""
    chunks = _chunks(data, path)
    if not chunks or chunks[0][0] != b"IHDR":
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if depth != 8:
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported (only 8)")
    if ctype not in CHANNELS or comp or filt:
        raise ValueError(f"{path}: PNG colour type {ctype} is not supported")
    ch = CHANNELS[ctype]
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size < h * (1 + w * ch):
        raise ValueError(f"{path}: truncated PNG image data")
    px = _unfilter(raw[:h * (1 + w * ch)].reshape(h, 1 + w * ch), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    pal = None
    if ctype == 3:
        plte = [body for kind, body in chunks if kind == b"PLTE"]
        if not plte:
            raise ValueError(f"{path}: palette PNG without PLTE")
        pal = np.zeros((256, 3), np.uint8)       # indices past the palette read black
        entries = np.frombuffer(plte[0], np.uint8).reshape(-1, 3)[:256]
        pal[:len(entries)] = entries
    return px, pal


def decode(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 samples as stored (C = 1 gray, 2 gray
    + alpha, 3 RGB, 4 RGBA; a palette expanded to RGB)."""
    px, pal = _samples(data, path)
    return px if pal is None else pal[px[..., 0]]


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _rgb(px: np.ndarray) -> np.ndarray:
    """Decoded samples -> (H, W, 3) RGB: gray replicated, alpha dropped."""
    if px.shape[2] <= 2:
        return np.repeat(px[..., :1], 3, 2)
    return px[..., :3]


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of a PNG: (H, W, 3) uint8 BGR."""
    return np.ascontiguousarray(_rgb(decode(_read(path), path))[..., ::-1])


def decode_rgb(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(BytesIO(data)).convert("RGB"))`` of PNG
    bytes: (H, W, 3) uint8 RGB."""
    return np.ascontiguousarray(_rgb(decode(data, path)))


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))`` of a PNG: (H, W, 3)
    uint8 RGB."""
    return decode_rgb(_read(path), path)


def read_samples(path: str) -> np.ndarray:
    """``np.array(Image.open(path))`` of a PNG: the stored samples, (H, W)
    for gray and palette files (a palette file's indices), (H, W, C) for
    gray + alpha, RGB and RGBA."""
    px, _ = _samples(_read(path), path)
    return px[..., 0] if px.shape[2] == 1 else px


def size(path: str):
    """(width, height) of a PNG from its IHDR chunk, the rest of the file
    unread."""
    with open(path, "rb") as fh:
        head = fh.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file (only PNG is supported)")
    return struct.unpack(">II", head[16:24])


def encode(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, 1) gray, or (H, W, 3) RGB uint8 -> PNG bytes: every
    row Up-filtered, deflated at level 1 with the run-length strategy
    (cv2's default level and strategy)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writing takes uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"PNG writing takes (H, W) or (H, W, 3) images, not {img.shape}")
    h, w = img.shape[:2]
    px = img.reshape(h, -1)
    rows = np.empty((h, 1 + px.shape[1]), np.uint8)
    rows[:, 0] = 2                                    # Up
    rows[0, 1:] = px[0]
    np.subtract(px[1:], px[:-1], out=rows[1:, 1:])    # wraps mod 256
    z = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    idat = z.compress(rows.tobytes()) + z.flush()
    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)`` for PNG: gray as it is, colour taken as
    BGR.  Returns True, as cv2 does."""
    if not str(path).lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG files can be written")
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3:
        img = img[..., ::-1]
    data = encode(img)
    with open(path, "wb") as fh:
        fh.write(data)
    return True
