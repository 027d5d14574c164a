"""A PNG codec on the standard library (``zlib``, ``struct``) and numpy.

The app reads and writes its images with it (``cv2.imread`` /
``cv2.imwrite`` in multiyolov5_tpu/data/sources.py:83 and
multiyolov5_tpu/cli/detect.py:132-138), so it needs no cv2 or PIL.  It
reads every form of the standard: bit depths 1, 2, 4, 8 and 16 of each
colour type that allows them (gray, RGB, palette, gray + alpha, RGBA),
Adam7 interlacing, and ``tRNS`` (which no entry point applies: cv2's
``IMREAD_COLOR`` and PIL's ``convert("RGB")`` both ignore it).  An
``eXIf`` chunk's orientation is honoured where the libraries honour it.

* :func:`imread` is ``cv2.imread(path)`` (``IMREAD_COLOR``): (H, W, 3)
  uint8 BGR; 16-bit samples keep their high byte, 1-, 2- and 4-bit gray is
  scaled to 0-255, gray replicated, alpha dropped without blending, a
  palette expanded (indices past it black), the ``eXIf`` orientation
  (before or after the image data) applied.
* :func:`read_rgb` is ``np.asarray(Image.open(path).convert("RGB"))``
  (:func:`decode_rgb` the same of PNG bytes): as :func:`imread` in RGB
  order, but 16-bit gray is clipped to 255 (PIL's ``I;16`` -> ``L``), and
  no orientation is applied.
* :func:`read_samples` is ``np.array(Image.open(path))``, the samples in
  PIL's mode: 1-bit gray bool (mode ``1``), 2-, 4- and 8-bit gray uint8
  (``L``, scaled), 16-bit gray uint16 (``I;16``), gray + alpha (H, W, 2)
  (``LA``; at 16 bits PIL's ``RGBA`` of the high bytes, (H, W, 4)), RGB and
  RGBA the high bytes, a palette file's indices (H, W).  The seg loaders
  read their masks with it.
* :func:`size` reads the IHDR chunk only: ``(width, height)``, as PIL's
  ``Image.open(path).size``; :func:`exif_size` is the JAX ``exif_size``
  as its label cache calls it, after PIL's ``verify()``: swapped for an
  ``eXIf`` orientation 6 or 8 before the image data (one after it unseen),
  every chunk's CRC checked to IEND.
* :func:`imwrite` writes (H, W) or (H, W, 1) uint8 as 8-bit gray and
  (H, W, 3) uint8, taken as BGR, as 8-bit RGB.

A corrupt or truncated stream, or a depth a colour type does not allow,
raises ``ValueError`` naming the file; so does a file that is not PNG.
The decoded pixels are cv2's and PIL's; the written bytes need not be.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from .jpeg import exif_orientation, orient

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (gray, RGB, palette, gray + alpha, RGBA)
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> the bit depths the standard allows it
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def chunk(kind: bytes, body: bytes) -> bytes:
    """One chunk: length, type, body, CRC."""
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _chunks(data: bytes, path: str) -> List[Tuple[bytes, bytes]]:
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
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
    are independent: the image is skewed so that each diagonal is a
    contiguous run of at most min(h, w) pixels, and the loop runs over the
    h + w - 1 diagonals, each a vector step over its pixels."""
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
    w = stride // bpp
    n = h + w - 1
    # first row of each diagonal; two zero diagonals before the image
    first = np.maximum(0, np.arange(-2, n) - w + 1)
    rows, cols = np.arange(h)[:, None], np.arange(w)[None, :]
    # skewed[d, r - first[d]] = pixel (r, d - r); a zero at either end of
    # each diagonal gives a, b and c at the image's edges
    at = (rows + cols, rows - first[rows + cols + 2])
    filt = np.zeros((n, min(h, w), bpp), np.int16)
    filt[at] = raw[:, 1:].reshape(h, w, bpp)
    rec = np.zeros((n + 2, min(h, w) + 2, bpp), np.int16)
    # rows of each filter before each row: which filters a diagonal meets
    seen = np.concatenate([np.zeros((1, 5), np.int64),
                           np.cumsum(ftype[:, None] == np.arange(5), 0)])
    for d in range(n):
        lo, hi = first[d + 2], min(h, d + 1)
        # a = (r, x - 1) and b = (r - 1, x) lie on diagonal d - 1, c = (r - 1,
        # x - 1) on d - 2, each indexed from its own first row
        sa, sc = lo - first[d + 1] + 1, lo - first[d]
        a, b = rec[d + 1, sa:sa + hi - lo], rec[d + 1, sa - 1:sa - 1 + hi - lo]
        c = rec[d, sc:sc + hi - lo]
        kinds = np.flatnonzero(seen[hi] - seen[lo])
        pred = None
        for k in kinds:
            if k == 0:
                v = np.zeros_like(a)
            elif k == 1:
                v = a
            elif k == 2:
                v = b
            elif k == 3:
                v = (a + b) >> 1
            else:
                pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
                v = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = v if pred is None else np.where(ftype[lo:hi, None] == k, v, pred)
        rec[d + 2, 1:hi - lo + 1] = (filt[d, :hi - lo] + pred) & 255
    return rec[at[0] + 2, at[1] + 1].astype(np.uint8).reshape(h, -1)


def _header(chunks, path: str):
    """IHDR -> (width, height, depth, colour type, interlaced)."""
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if ctype not in DEPTHS or depth not in DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth {depth} is not a PNG form")
    if comp or filt or interlace > 1 or not w or not h:
        raise ValueError(f"{path}: bad PNG header (compression {comp}, filter {filt}, "
                         f"interlace {interlace}, {w}x{h})")
    return w, h, depth, ctype, bool(interlace)


def _pass(raw: np.ndarray, pos: int, w: int, h: int, depth: int, ch: int, path: str):
    """The w x h image (or Adam7 pass) at ``raw[pos:]``: ((h, w, ch)
    samples, uint8 or uint16, 1-, 2- and 4-bit ones unpacked to their
    values), the position after it."""
    stride = (w * ch * depth + 7) // 8
    n = h * (1 + stride)
    if raw.size < pos + n:
        raise ValueError(f"{path}: truncated PNG image data")
    try:
        rows = _unfilter(raw[pos:pos + n].reshape(h, 1 + stride), h, stride,
                         max(1, ch * depth // 8))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if depth == 16:
        px = rows.reshape(h, w * ch, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]
    elif depth == 8:
        px = rows
    else:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        px = (bits @ (1 << np.arange(depth - 1, -1, -1))).astype(np.uint8)[:, :w]
    return px.reshape(h, w, ch), pos + n


class Decoded:
    """A PNG's samples as stored ((H, W, C) uint8 or uint16), its bit depth,
    colour type, (256, 3) palette (None but for palette files) and the
    orientations of its ``eXIf`` chunks before and after the image data
    (None where there is none)."""

    def __init__(self, px, depth, ctype, pal, orient_before, orient_after):
        self.px, self.depth, self.ctype, self.pal = px, depth, ctype, pal
        self.orient_before, self.orient_after = orient_before, orient_after

    @property
    def orientation(self) -> Optional[int]:
        """What cv2 sees: the first ``eXIf``, before or after the image data."""
        return self.orient_before if self.orient_before is not None else self.orient_after

    def bytes8(self) -> np.ndarray:
        """The samples at 8 bits as libpng's transforms give cv2 (and PIL
        every mode but ``I;16``): 16-bit ones their high byte, 1-, 2- and
        4-bit gray scaled to 0-255 (a palette file's indices kept)."""
        if self.depth == 16:
            return (self.px >> 8).astype(np.uint8)
        if self.depth < 8 and self.ctype == 0:
            return self.px * np.uint8(255 // ((1 << self.depth) - 1))
        return self.px


def _orientations(chunks):
    first_idat = next(i for i, (kind, _) in enumerate(chunks) if kind == b"IDAT")
    found = [None, None]
    for i, (kind, body) in enumerate(chunks):
        if kind == b"eXIf" and found[i > first_idat] is None:
            found[i > first_idat] = exif_orientation(body)
    return found


def decode_samples(data: bytes, path: str = "<bytes>") -> Decoded:
    """PNG bytes -> :class:`Decoded`."""
    chunks = _chunks(data, path)
    w, h, depth, ctype, interlaced = _header(chunks, path)
    ch = CHANNELS[ctype]
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    if not idat:
        raise ValueError(f"{path}: PNG without IDAT")
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    if not interlaced:
        px, _ = _pass(raw, 0, w, h, depth, ch, path)
    else:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw > 0 and ph > 0:
                px[y0::dy, x0::dx], pos = _pass(raw, pos, pw, ph, depth, ch, path)
    pal = None
    if ctype == 3:
        plte = [body for kind, body in chunks if kind == b"PLTE"]
        if not plte:
            raise ValueError(f"{path}: palette PNG without PLTE")
        pal = np.zeros((256, 3), np.uint8)       # indices past the palette read black
        entries = np.frombuffer(plte[0], np.uint8)[:768]
        entries = entries[:entries.size // 3 * 3].reshape(-1, 3)
        pal[:len(entries)] = entries
    return Decoded(px, depth, ctype, pal, *_orientations(chunks))


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _rgb(px: np.ndarray) -> np.ndarray:
    """Decoded samples -> (H, W, 3) RGB: gray replicated, alpha dropped."""
    if px.shape[2] <= 2:
        return np.repeat(px[..., :1], 3, 2)
    return px[..., :3]


def decode_bgr(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_COLOR)`` of PNG bytes."""
    d = decode_samples(data, path)
    rgb = d.pal[d.px[..., 0]] if d.pal is not None else _rgb(d.bytes8())
    return np.ascontiguousarray(orient(rgb, d.orientation)[..., ::-1])


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of a PNG: (H, W, 3) uint8 BGR, the ``eXIf``
    orientation applied."""
    return decode_bgr(_read(path), path)


def _pil_rgb(d: Decoded) -> np.ndarray:
    if d.ctype == 0 and d.depth == 16:                  # I;16 -> L clips
        return np.repeat(np.minimum(d.px, 255).astype(np.uint8), 3, 2)
    return np.ascontiguousarray(d.pal[d.px[..., 0]] if d.pal is not None else _rgb(d.bytes8()))


def decode_rgb(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(BytesIO(data)).convert("RGB"))`` of PNG
    bytes: (H, W, 3) uint8 RGB."""
    return _pil_rgb(decode_samples(data, path))


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))`` of a PNG: (H, W, 3)
    uint8 RGB."""
    return decode_rgb(_read(path), path)


def _pil_samples(d: Decoded) -> np.ndarray:
    """``np.array`` of the image PIL opens (see the module docstring)."""
    if d.ctype == 3:
        return d.px[..., 0]
    if d.ctype == 0:
        if d.depth == 1:
            return d.px[..., 0].astype(bool)
        return d.px[..., 0] if d.depth == 16 else d.bytes8()[..., 0]
    px = d.bytes8()
    if d.ctype == 4 and d.depth == 16:                  # LA;16B opens as RGBA
        return np.concatenate([np.repeat(px[..., :1], 3, 2), px[..., 1:]], 2)
    return px


def read_samples(path: str) -> np.ndarray:
    """``np.array(Image.open(path))`` of a PNG."""
    return _pil_samples(decode_samples(_read(path), path))


def size(path: str):
    """(width, height) of a PNG from its IHDR chunk, the rest of the file
    unread."""
    with open(path, "rb") as fh:
        head = fh.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def exif_size(path: str) -> Tuple[int, int]:
    """The JAX ``exif_size`` of a PNG, as its label cache calls it, after
    PIL's ``verify()``: (w, h), swapped for an ``eXIf`` orientation 6 or 8
    before the image data (PIL has read no further when it is asked);
    every chunk's CRC is checked up to an IEND that must be there."""
    chunks = _chunks(_read(path), path)
    w, h, _, _, _ = _header(chunks, path)
    if not any(kind == b"IDAT" for kind, _ in chunks):
        raise ValueError(f"{path}: PNG without IDAT")
    if chunks[-1][0] != b"IEND":
        raise ValueError(f"{path}: truncated PNG file (no IEND)")
    return (h, w) if _orientations(chunks)[0] in (6, 8) else (w, h)


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
