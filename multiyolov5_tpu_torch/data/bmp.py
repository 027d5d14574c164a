"""A BMP codec on numpy, with RLE decoding in host C++.

OpenCV and Pillow each have a BMP decoder of their own, and they differ, so
the two semantics of ``data/images.py`` are two readers here, each its
library's rules:

* :func:`imread` is ``cv2.imread(path)`` (OpenCV's ``BmpDecoder``): an
  OS/2 core (12-byte) or a Windows (40-byte or longer) header; 1-, 4- and
  8-bit palettes (indices past it black), RLE8 and RLE4, 16-bit 5-5-5 and
  (by BITFIELDS after a 40-byte header) 5-6-5 with each field shifted up
  (``v << 3``, green ``v << 2`` at 6 bits), 24-bit, and 32-bit (bytes B,
  G, R, A, or where a V4 or V5 header gives byte masks, where they say),
  alpha dropped; rows
  bottom-up, or top-down for a negative height.  Where OpenCV fails
  (BITFIELDS masks it cannot read after a V4 or V5 header, an RLE run past
  its row, data that ends early) this raises.
* :func:`read_rgb` / :func:`read_samples` are ``Image.open(path)
  .convert("RGB")`` / ``np.array(Image.open(path))`` (Pillow's
  ``BmpImagePlugin``): header sizes 12, 40, 52, 56, 64, 108 and 124; a
  palette of grey entries (``(i, i, i)`` at index i, or black and white
  for two colours) opens as mode ``L`` (``1``: bool), any other as ``P``
  (indices); 16-bit fields scaled (``v * 255 // 31``, ``// 63``); 32-bit
  by the masks Pillow knows (an alpha mask opens ``RGBA``); RLE as
  Pillow's decoder reads it (runs clipped to their row, a delta's bytes
  read twice over; an image the stream does not fill raises).
* :func:`size` / :func:`exif_size` are PIL's ``.size`` (a BMP has no EXIF).
* :func:`imwrite` is ``cv2.imwrite(path, img)``, byte for byte: 24-bit
  bottom-up rows for (H, W, 3) BGR, 8-bit with a grey palette for gray.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from . import host_codecs

SIGNATURE = b"BM"
RGB, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
PIL_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# Pillow's BITFIELDS layouts: (bits, masks) -> raw mode (bytes in memory order)
PIL_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
PIL_RAW = {16: "BGR;15", 24: "BGR", 32: "BGRX"}


def _u32(data: bytes, off: int) -> int:
    return struct.unpack_from("<I", data, off)[0] if off + 4 <= len(data) else 0


def _stride(w: int, bits: int) -> int:
    return ((w * bits + 31) // 32) * 4


def _rows(data: bytes, off: int, w: int, h: int, bits: int, path: str) -> np.ndarray:
    """The h rows of w pixels at ``data[off:]`` (file order), (h, row
    bytes) uint8; data that ends early raises."""
    stride = _stride(w, bits)
    if off < 0 or off + h * stride > len(data):
        raise ValueError(f"{path}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, h * stride, off).reshape(h, stride)
    return rows[:, :(w * bits + 7) // 8]


def _unpack(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """(h, bytes) rows of 1-, 4- or 8-bit indices -> (h, w) uint8."""
    if bits == 8:
        return rows[:, :w]
    v = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, bits)
    return (v @ (1 << np.arange(bits - 1, -1, -1))).astype(np.uint8)[:, :w]


def _u16(rows: np.ndarray, w: int) -> np.ndarray:
    return rows[:, :2 * w].reshape(rows.shape[0], w, 2).astype(np.uint16) @ np.array([1, 256],
                                                                                      np.uint16)


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _check(data: bytes, path: str) -> None:
    if data[:2] != SIGNATURE or len(data) < 26:
        raise ValueError(f"{path}: not a BMP file")


# ---------------------------------------------------------------- OpenCV

def decode_bgr(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_COLOR)`` of BMP bytes: (H, W, 3) uint8."""
    _check(data, path)
    offset, hsize = _u32(data, 10), _u32(data, 14)
    pos = 14 + hsize

    def fail(why):
        return ValueError(f"{path}: OpenCV cannot read this BMP ({why})")

    if hsize >= 36:
        w, h = struct.unpack_from("<ii", data, 18)
        bits = struct.unpack_from("<H", data, 28)[0]
        comp, clrused = _u32(data, 30), _u32(data, 46)
        if comp > BITFIELDS:
            raise fail(f"compression {comp}")
        ok = w > 0 and h != 0 and ((bits in (1, 4, 8, 24, 32) and comp == RGB)
                                   or (bits in (16, 32) and comp in (RGB, BITFIELDS))
                                   or (bits == 4 and comp == RLE4) or (bits == 8 and comp == RLE8))
        entry = 4
    elif hsize == 12:
        w, h = struct.unpack_from("<HH", data, 18)
        bits, comp, clrused = struct.unpack_from("<H", data, 24)[0], RGB, 0
        ok = w > 0 and h != 0 and bits in (1, 4, 8, 24, 32)
        entry = 3
    else:
        raise fail(f"header size {hsize}")
    if not ok:
        raise fail(f"{bits}-bit, compression {comp}, {w}x{h}")
    pal = np.zeros((256, 3), np.uint8)                  # BGR
    if bits <= 8:
        if clrused > 256:
            raise fail(f"{clrused} palette entries")
        n = clrused or 1 << bits
        raw = np.frombuffer(data[pos:pos + n * entry], np.uint8)
        if raw.size < n * entry:
            raise fail("the palette ends early")
        pal[:n] = raw.reshape(n, entry)[:, :3]
    elif bits == 16:
        if comp == BITFIELDS:
            masks = struct.unpack_from("<III", data, pos) if pos + 12 <= len(data) else ()
            if masks not in ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F)):
                raise fail(f"16-bit masks {masks}")
            bits = 15 if masks[0] == 0x7C00 else 16
        else:
            bits = 15
    top_down, h = h < 0, abs(h)
    if comp in (RLE8, RLE4):
        px = pal[host_codecs.bmp_rle(data, offset, w, h, comp == RLE4, False, path)]
    else:
        rows = _rows(data, offset, w, h, 16 if bits == 15 else bits, path)
        if bits <= 8:
            px = pal[_unpack(rows, w, bits)]
        elif bits in (15, 16):
            v = _u16(rows, w)
            if bits == 15:
                px = np.stack([v << 3, (v >> 2) & 0xF8, (v >> 7) & 0xF8], -1)
            else:
                px = np.stack([v << 3, (v >> 3) & 0xFC, (v >> 8) & 0xF8], -1)
            px = px.astype(np.uint8)
        else:
            px = rows.reshape(h, w, bits // 8)
            order = [0, 1, 2]                           # B, G, R as stored
            if bits == 32 and comp == BITFIELDS and hsize >= 108:
                masks = struct.unpack_from("<III", data, 54)[::-1]     # B, G, R
                if any(masks):
                    byte = {0xFF << 8 * k: k for k in range(4)}
                    if any(m not in byte for m in masks):
                        raise fail(f"32-bit masks {masks[::-1]}")
                    order = [byte[m] for m in masks]
            px = px[..., order]
    return np.ascontiguousarray(px if top_down else px[::-1])


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of a BMP: (H, W, 3) uint8 BGR."""
    return decode_bgr(_read(path), path)


# ---------------------------------------------------------------- Pillow

class PilHeader:
    """What ``BmpImagePlugin`` reads at ``Image.open``: size, mode, raw
    mode, palette ((n, 3) RGB for mode ``P``), compression, pixel offset
    and row direction; raises ``ValueError`` where it raises."""

    def __init__(self, data: bytes, path: str):
        _check(data, path)
        offset, hsize = _u32(data, 10), _u32(data, 14)
        head = data[18:14 + hsize]
        if len(head) < hsize - 4:
            raise ValueError(f"{path}: truncated BMP header")
        if hsize == 12:
            w, h, _, bits = struct.unpack_from("<HHHH", head)
            comp, colors, entry, flip = RGB, 0, 3, False
        elif hsize in PIL_HEADERS:
            flip = head[7] == 0xFF
            w, h = struct.unpack_from("<II", head)
            h = 2 ** 32 - h if flip else h
            bits, comp = struct.unpack_from("<HI", head, 10)
            colors, entry = struct.unpack_from("<I", head, 28)[0], 4
        else:
            raise ValueError(f"{path}: Unsupported BMP header type ({hsize})")
        self.size = (w, h)
        colors = colors or 1 << bits
        if offset == 14 + hsize and bits <= 8:
            offset += 4 * colors
        mode, raw = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P")}.get(
            bits, ("RGB", PIL_RAW.get(bits)))
        if raw is None:
            raise ValueError(f"{path}: Unsupported BMP pixel depth ({bits})")
        if comp == BITFIELDS:
            if hsize >= 52:
                masks = struct.unpack_from("<IIII" if hsize >= 56 else "<III", head, 36)
                masks += (0,) * (4 - len(masks))
            else:
                masks = struct.unpack_from("<III", data, 14 + hsize) + (0,)
            key = (bits, masks) if bits == 32 else (bits, masks[:3])
            if key not in PIL_MASKS:
                raise ValueError(f"{path}: Unsupported BMP bitfields layout")
            raw = PIL_MASKS[key]
            mode = "RGBA" if "A" in raw else mode
        elif comp not in (RGB, RLE8, RLE4):
            raise ValueError(f"{path}: Unsupported BMP compression ({comp})")
        self.palette = None
        if mode == "P":
            if not 0 < colors <= 65536:
                raise ValueError(f"{path}: Unsupported BMP Palette size ({colors})")
            start = 14 + hsize
            pal = np.frombuffer(data[start:start + entry * colors], np.uint8)
            pal = pal[:pal.size // entry * entry].reshape(-1, entry)[:, 2::-1]
            grey = (0, 255) if colors == 2 else range(colors)
            if len(pal) == colors and all((pal[i] == v).all() for i, v in enumerate(grey)):
                mode = raw = "1" if colors == 2 else "L"
            else:
                self.palette = pal
        self.mode, self.raw, self.bits, self.comp = mode, raw, bits, comp
        self.offset, self.bottom_up = offset, not flip


def _pil(data: bytes, path: str):
    """(``np.array`` of the image Pillow opens, its header)."""
    hd = PilHeader(data, path)
    (w, h), bits = hd.size, hd.bits
    if hd.comp in (RLE8, RLE4):
        if hd.mode == "1":
            raise ValueError(f"{path}: Pillow cannot decode an RLE BMP in mode 1")
        px = host_codecs.bmp_rle(data, hd.offset, w, h, hd.comp == RLE4, True, path)
    elif hd.mode in ("1", "L") and bits != (1 if hd.mode == "1" else 8):
        raise NotImplementedError(
            f"{path}: a {bits}-bit BMP whose palette Pillow takes for mode {hd.mode} "
            f"(it then reads the rows at {1 if hd.mode == '1' else 8} bits a pixel)")
    else:
        rows = _rows(data, hd.offset, w, h, bits, path)
        if bits <= 8:
            px = _unpack(rows, w, bits)
        elif bits == 16:
            v = _u16(rows, w).astype(np.int32)
            if hd.raw == "BGR;15":
                f = [((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31]
            else:
                f = [((v >> 11) & 31) * 255 // 31, ((v >> 5) & 63) * 255 // 63]
            px = np.stack(f + [(v & 31) * 255 // 31], -1).astype(np.uint8)
        else:
            b = rows.reshape(h, w, bits // 8)
            px = b[..., [hd.raw.index(c) for c in ("RGBA" if hd.mode == "RGBA" else "RGB")]]
    if hd.mode == "1":
        px = px.astype(bool)
    return np.ascontiguousarray(px[::-1] if hd.bottom_up else px), hd


def _pil_rgb(px: np.ndarray, hd: PilHeader) -> np.ndarray:
    if hd.mode == "P":
        pal = np.zeros((max(256, len(hd.palette)), 3), np.uint8)
        pal[:len(hd.palette)] = hd.palette
        return pal[px]
    if hd.mode in ("1", "L"):
        return np.repeat((px.astype(np.uint8) * (255 if hd.mode == "1" else 1))[..., None], 3, 2)
    return np.ascontiguousarray(px[..., :3])


def decode_rgb(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(BytesIO(data)).convert("RGB"))`` of BMP bytes."""
    return _pil_rgb(*_pil(data, path))


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))`` of a BMP."""
    return decode_rgb(_read(path), path)


def read_samples(path: str) -> np.ndarray:
    """``np.array(Image.open(path))`` of a BMP."""
    return _pil(_read(path), path)[0]


def size(path: str) -> Tuple[int, int]:
    """PIL's ``Image.open(path).size`` of a BMP (its header only)."""
    with open(path, "rb") as fh:               # the headers, masks and largest palette
        hd = PilHeader(fh.read(14 + 124 + 12 + 4 * 65536), path)
    return hd.size


def exif_size(path: str) -> Tuple[int, int]:
    """The JAX ``exif_size(Image.open(path))`` of a BMP: its size (a BMP
    holds no EXIF, and PIL's ``verify`` reads nothing more)."""
    return size(path)


# ---------------------------------------------------------------- writing

def encode(img: np.ndarray) -> bytes:
    """``cv2.imencode(".bmp", img)``: (H, W, 3) BGR as 24-bit and (H, W) or
    (H, W, 1) gray as 8-bit with a grey palette, rows bottom-up, a 40-byte
    header with zero resolution and image size."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"BMP writing takes uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"BMP writing takes (H, W) or (H, W, 3) images, not {img.shape}")
    h, w = img.shape[:2]
    bits = 8 if img.ndim == 2 else 24
    stride = _stride(w, bits)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = img[::-1].reshape(h, -1)
    pal = b"" if bits == 24 else np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    if bits == 8:
        pal[:, 3] = 0
        pal = pal.tobytes()
    offset = 14 + 40 + len(pal)
    head = (SIGNATURE + struct.pack("<IHHI", offset + rows.size, 0, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, RGB, 0, 0, 0, 0, 0))
    return head + pal + rows.tobytes()


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)`` for BMP.  Returns True, as cv2 does."""
    with open(path, "wb") as fh:
        fh.write(encode(img))
    return True
