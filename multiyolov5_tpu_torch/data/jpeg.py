"""A JPEG codec of the port's own, equal to libjpeg-turbo's output.

The JAX package reads JPEG through ``cv2.imread`` and ``Image.open``, and
writes it through ``cv2.imwrite`` and PIL's ``save``; both libraries run
libjpeg-turbo, whose default paths are integer arithmetic that its sources
specify.  This module reproduces them step for step, so the port needs no
cv2 or PIL:

* the bit-serial part (the one parser of a file's markers, Huffman
  decoding of sequential and progressive scans into quantised
  coefficients, Huffman encoding of a baseline scan) is host C++,
  ``csrc/host/jpeg.cpp``, built with g++ into ``build/host/`` at first use
  (``utils/shared_library.py``) and bound through ctypes;
* the arithmetic is numpy here, vectorised over blocks: dequantisation,
  ``jidctint.c``'s ISLOW IDCT, ``jdsample.c``'s fancy upsampling (h2v1,
  h2v2, h1v2; replication for the other ratios), ``jdcolor.c``'s
  fixed-point YCbCr -> RGB; and for the encoder ``jccolor.c``,
  ``jcsample.c`` (edge expansion, alternating bias), ``jfdctint.c``,
  ``jcdctmgr.c``'s reciprocal quantisation and ``jcparam.c``'s quality
  scaling with ``force_baseline``.

Entry points (named as in ``data/png.py``):

* :func:`imread` is ``cv2.imread(path)``: (H, W, 3) uint8 BGR, with the
  EXIF orientation (2-8) applied as cv2 applies it;
* :func:`decode_rgb` / :func:`read_rgb` are ``Image.open(...).convert("RGB")``:
  (H, W, 3) uint8 RGB, no orientation applied; gray files replicated;
* :func:`size` is ``(w, h)`` from the frame header, :func:`exif_size` the
  JAX ``exif_size`` (w and h swapped for orientations 6 and 8 only);
* :func:`encode` writes a baseline file at a quality and a subsampling;
  :func:`imwrite` is ``cv2.imwrite`` at its defaults (q95, 4:2:0, BGR in)
  and :func:`pil_save` PIL's ``save`` of a ``.jpg`` at its defaults (q75,
  4:2:0, RGB in).  The scan bytes equal theirs.

Arithmetic coding, lossless, hierarchical and 12-bit files, 4-component
(CMYK / YCCK) files, and progressive files whose scans leave coefficients
unrefined (which libjpeg-turbo smooths) raise ``ValueError`` naming the
file and what it holds; so does a corrupt or truncated stream.  Where the
IDCT's output leaves [-128, 127] it is saturated, as libjpeg-turbo's SIMD
paths do (its C path wraps past +-512, which encoded images never reach).
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils.shared_library import host_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "jpeg.cpp"

# zigzag position -> natural index (ISO/IEC 10918-1 Figure A.6)
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ---------------------------------------------------------------- tables

# JPEG Annex K.1 (jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl),
# natural order
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_Q = np.full((8, 8), 99)
STD_CHROMA_Q[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]
STD_CHROMA_Q = STD_CHROMA_Q.reshape(64)

# JPEG Annex K.3 (jcparam.c std_huff_tables): (counts of lengths 1-16, symbols)
_AC_LUMA_SYMBOLS = bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])
_AC_CHROMA_SYMBOLS = bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])
HUFF_DC = [(bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
           (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))]
HUFF_AC = [(bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _AC_LUMA_SYMBOLS),
           (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_CHROMA_SYMBOLS)]

# (h, v) of the luma component; chroma is 1 x 1 (jcparam.c, PIL's subsampling)
SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}

# ---------------------------------------------------------------- the C++ part

def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.mkj_header.argtypes = [p, i64, i32, p, ctypes.c_char_p, i32]
    lib.mkj_decode.argtypes = [p, i64, i32, p, i64, p, ctypes.c_char_p, i32]
    lib.mkj_encode.argtypes = [i32, p, p, i64, i32, i32, p, p, i64, p, ctypes.c_char_p, i32]
    for fn in (lib.mkj_header, lib.mkj_decode, lib.mkj_encode):
        fn.restype = i32


_LIB = host_library(SOURCE, "libmultiyolov5_jpeg", _bind)


def library() -> ctypes.CDLL:
    """The codec's host library, built from ``csrc/host/jpeg.cpp`` if this
    process has not loaded it yet."""
    return _LIB.load()


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


# ---------------------------------------------------------------- headers

_INFO_LEN = 9 + 8 * 3           # jpeg.cpp kInfoLen
_HEAD_BYTES = 1 << 16           # a file's first read for its header


class Header:
    """What the markers up to the first scan say, as ``mkj_header`` parses
    them: the frame's size, its components ((id, h, v, table) each) and
    their grids ((plane blocks down, across, samples down, across) each),
    the largest sampling factors, the EXIF orientation (None without an
    Exif segment) and the colour-space hints (JFIF, Adobe).  With
    ``frame_only`` only the size is filled."""

    def __init__(self, info: np.ndarray, data: bytes):
        info = info.tolist()
        self.width, self.height = info[0], info[1]
        self.hmax, self.vmax = info[3], info[4]
        rows = [info[9 + 8 * i:17 + 8 * i] for i in range(info[2])]
        self.comps = [tuple(r[:4]) for r in rows]
        self.grid = [tuple(r[4:]) for r in rows]
        self.jfif = bool(info[5])
        self.adobe_transform = None if info[6] < 0 else info[6]
        self.orientation: Optional[int] = None
        if info[7] >= 0:
            self.orientation = exif_orientation(data[info[7] + 6:info[7] + info[8]]) or 0


def exif_orientation(tiff: bytes) -> Optional[int]:
    """Tag 0x0112 of the IFD0 of an EXIF block's TIFF structure (an APP1
    Exif segment's body past ``Exif\\0\\0``, a PNG's ``eXIf`` chunk), or
    None."""
    order = {b"II*\x00": "<", b"MM\x00*": ">"}.get(tiff[:4])
    if order is None:
        return None
    try:
        (off,) = struct.unpack(order + "I", tiff[4:8])
        (count,) = struct.unpack(order + "H", tiff[off:off + 2])
        for i in range(count):
            e = tiff[off + 2 + 12 * i:off + 14 + 12 * i]
            tag, kind = struct.unpack(order + "HH", e[:4])
            if tag == 0x0112 and kind == 3:
                return struct.unpack(order + "H", e[8:10])[0]
    except struct.error:
        return None
    return None


def _parse(data: bytes, frame_only: bool):
    """``mkj_header`` of ``data``: (return code, info, message)."""
    info = np.zeros(_INFO_LEN, np.int32)
    err = ctypes.create_string_buffer(256)
    buf = np.frombuffer(data, np.uint8)
    rc = library().mkj_header(_ptr(buf), len(data), int(frame_only), _ptr(info), err, len(err))
    return rc, info, err.value.decode()


def header(data: bytes, path: str = "<bytes>", frame_only: bool = False) -> Header:
    """The :class:`Header` of JPEG bytes, raising ``ValueError`` on what the
    decoder does not support (with ``frame_only``, only the size is read,
    of any frame type)."""
    rc, info, msg = _parse(data, frame_only)
    if rc:
        raise ValueError(f"{path}: {msg}")
    return Header(info, data)


def _file_header(path: str, frame_only: bool = False) -> Header:
    """:func:`header` of a file, reading only its first 64 KiB unless the
    markers before the first scan run past them."""
    with open(path, "rb") as fh:
        data = fh.read(_HEAD_BYTES)
        rc, info, msg = _parse(data, frame_only)
        if rc == 2 and len(data) == _HEAD_BYTES:
            data += fh.read()
            rc, info, msg = _parse(data, frame_only)
    if rc:
        raise ValueError(f"{path}: {msg}")
    return Header(info, data)


def size(path: str) -> Tuple[int, int]:
    """(width, height) of a JPEG from its frame header (of any frame type),
    as PIL's ``Image.open(path).size``."""
    hdr = _file_header(path, frame_only=True)
    return hdr.width, hdr.height


def exif_size(path: str) -> Tuple[int, int]:
    """The JAX ``exif_size(Image.open(path))``: (w, h), swapped for EXIF
    orientations 6 and 8 only."""
    hdr = _file_header(path)
    if hdr.orientation in (6, 8):
        return hdr.height, hdr.width
    return hdr.width, hdr.height


# ---------------------------------------------------------------- decoding

def coefficients(data: bytes, path: str = "<bytes>", hdr: Optional[Header] = None):
    """(header, per component its (bh, bw, 64) int16 quantised coefficients
    in natural order, per component its (64,) quantisation table); the
    header parsed here unless given."""
    hdr = hdr or header(data, path)
    sizes = [bh * bw * 64 for bh, bw, _, _ in hdr.grid]
    flat = np.zeros(sum(sizes), np.int16)
    qt = np.zeros((len(sizes), 64), np.uint16)
    err = ctypes.create_string_buffer(256)
    buf = np.frombuffer(data, np.uint8)
    if library().mkj_decode(_ptr(buf), len(data), len(sizes), _ptr(flat), flat.size, _ptr(qt),
                            err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    planes, off = [], 0
    for (bh, bw, _, _), n in zip(hdr.grid, sizes):
        planes.append(flat[off:off + n].reshape(bh, bw, 64))
        off += n
    return hdr, planes, qt


# jidctint.c / jfdctint.c constants (CONST_BITS 13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


_EVEN = [0, 4]          # the FDCT outputs scaled, not descaled, in its first pass


def _idct_sums(x):
    """One 1-D pass of ``jpeg_idct_islow`` over 8 inputs (frequency order):
    the 8 sums (sample order) before their descale."""
    z1 = (x[2] + x[6]) * _F0541
    tmp2 = z1 - x[6] * _F1847
    tmp3 = z1 + x[2] * _F0765
    tmp0 = (x[0] + x[4]) * (1 << 13)
    tmp1 = (x[0] - x[4]) * (1 << 13)
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    t0 = t0 * _F0298 + z1 + z3
    t1 = t1 * _F2053 + z2 + z4
    t2 = t2 * _F3072 + z2 + z3
    t3 = t3 * _F1501 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1,
            tmp11 - t2, tmp10 - t3]


def _fdct_sums(x):
    """One 1-D pass of ``jpeg_fdct_islow`` over 8 inputs (sample order): the
    8 sums (frequency order) before their descale (outputs 0 and 4 are
    scaled by 4 in the first pass and descaled by 2 bits in the second,
    the others descaled by 11 and 15 bits)."""
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1 = (tmp12 + tmp13) * _F0541
    z5 = (tmp4 + tmp6 + tmp5 + tmp7) * _F1175
    zz1 = (tmp4 + tmp7) * -_F0899
    zz2 = (tmp5 + tmp6) * -_F2562
    zz3 = (tmp4 + tmp6) * -_F1961 + z5
    zz4 = (tmp5 + tmp7) * -_F0390 + z5
    return [tmp10 + tmp11, tmp7 * _F1501 + zz1 + zz4, z1 + tmp13 * _F0765,
            tmp6 * _F3072 + zz2 + zz3, tmp10 - tmp11, tmp5 * _F2053 + zz2 + zz4,
            z1 - tmp12 * _F1847, tmp4 * _F0298 + zz1 + zz3]


def _shifted(sums, bits: int):
    """libjpeg's DESCALE of each sum: round half up by an arithmetic shift."""
    r = 1 << (bits - 1)
    return np.stack([(v + r) >> bits for v in sums])


def idct(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(..., 64) quantised coefficients (natural order) and their (64,)
    table -> (..., 8, 8) uint8 samples: dequantise, ``jpeg_idct_islow``
    (columns with PASS1_BITS 2, then rows), level shift and saturate.  In
    int32, as libjpeg-turbo's SIMD IDCT computes (16-bit products, 32-bit
    sums), each pass over 8 arrays of one coefficient across the blocks."""
    lead = coefs.shape[:-1]
    c = (coefs.reshape(-1, 64).T.astype(np.int32)
         * qt.astype(np.int32)[:, None]).reshape(8, 8, -1)          # [v][u][n]
    ws = _shifted(_idct_sums(list(c)), 11)                          # [y][u][n]
    px = _shifted(_idct_sums(list(ws.transpose(1, 0, 2))), 18)      # [x][y][n]
    px += 128
    out = np.clip(px, 0, 255, out=px).astype(np.uint8).transpose(2, 1, 0)
    return out.reshape(*lead, 8, 8)


def _plane(coefs: np.ndarray, qt: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """A component's (dh, dw) samples from its coefficient plane."""
    bh, bw = -(-dh // 8), -(-dw // 8)
    px = idct(coefs[:bh, :bw], qt)                    # (bh, bw, 8, 8)
    return px.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)[:dh, :dw]


def _upsample(p: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """``jdsample.c`` at its defaults: triangle (fancy) filters for h2v1 and
    h2v2 where the plane is wider than 2 samples, and for h1v2; box
    replication for any other integral ratio.  Edges replicate the last real
    sample (``jdmainct.c``'s context rows)."""
    p = p.astype(np.int32)
    if (hr, vr) == (1, 1):
        return p
    w = p.shape[1]
    if (hr, vr) == (2, 1) and w > 2:
        e = np.pad(p, ((0, 0), (1, 1)), mode="edge")
        out = np.empty((p.shape[0], 2 * w), np.int32)
        out[:, 0::2] = (3 * p + e[:, :-2] + 1) >> 2
        out[:, 1::2] = (3 * p + e[:, 2:] + 2) >> 2
        return out
    if (hr, vr) == (1, 2):
        e = np.pad(p, ((1, 1), (0, 0)), mode="edge")
        out = np.empty((2 * p.shape[0], w), np.int32)
        out[0::2] = (3 * p + e[:-2] + 1) >> 2
        out[1::2] = (3 * p + e[2:] + 2) >> 2
        return out
    if (hr, vr) == (2, 2) and w > 2:
        e = np.pad(p, ((1, 1), (0, 0)), mode="edge")
        out = np.empty((2 * p.shape[0], 2 * w), np.int32)
        for r, far in ((0, e[:-2]), (1, e[2:])):
            cs = 3 * p + far                          # column sums, this row and its neighbour
            ce = np.pad(cs, ((0, 0), (1, 1)), mode="edge")
            out[r::2, 0::2] = (3 * cs + ce[:, :-2] + 8) >> 4
            out[r::2, 1::2] = (3 * cs + ce[:, 2:] + 7) >> 4
        return out
    return np.repeat(np.repeat(p, vr, 0), hr, 1)


def _fix(v: float) -> int:
    """libjpeg's FIX(v) at SCALEBITS 16."""
    return int(v * 65536 + 0.5)


def _color(hdr: Header, samples) -> np.ndarray:
    """Full-size component samples -> (H, W, 3) uint8 RGB (``jdcolor.c``)."""
    if len(samples) == 1:
        return np.repeat(samples[0].astype(np.uint8)[..., None], 3, 2)
    ids = tuple(c[0] for c in hdr.comps)
    rgb = (not hdr.jfif and (hdr.adobe_transform == 0
                             if hdr.adobe_transform is not None else ids == (82, 71, 66)))
    if rgb:
        return np.stack([s.astype(np.uint8) for s in samples], -1)
    # ycc_rgb_convert's tables, computed in place of looked up
    y, cb, cr = samples
    cb = cb - 128
    cr = cr - 128
    half = 1 << 15
    out = np.empty(y.shape + (3,), np.uint8)
    for ch, v in enumerate((y + ((_fix(1.40200) * cr + half) >> 16),
                            y + ((-_fix(0.34414) * cb - _fix(0.71414) * cr + half) >> 16),
                            y + ((_fix(1.77200) * cb + half) >> 16))):
        out[..., ch] = np.clip(v, 0, 255, out=v)
    return out


def decode_rgb(data: bytes, path: str = "<bytes>", hdr: Optional[Header] = None) -> np.ndarray:
    """``np.asarray(Image.open(BytesIO(data)).convert("RGB"))`` of JPEG
    bytes: (H, W, 3) uint8 RGB, no EXIF orientation applied."""
    hdr, planes, qt = coefficients(data, path, hdr)
    full = []
    for coefs, q, (_, h, v, _), (_, _, dh, dw) in zip(planes, qt, hdr.comps, hdr.grid):
        up = _upsample(_plane(coefs, q, dh, dw), hdr.hmax // h, hdr.vmax // v)
        full.append(up[:hdr.height, :hdr.width])
    return _color(hdr, full)


def orient(img: np.ndarray, o: Optional[int]) -> np.ndarray:
    """An image as cv2's ``imread`` turns it for EXIF orientation ``o``
    (2-8; anything else leaves it as it is)."""
    if o == 2:
        return img[:, ::-1]
    if o == 3:
        return img[::-1, ::-1]
    if o == 4:
        return img[::-1]
    if o in (5, 6, 7, 8):
        t = img.swapaxes(0, 1)
        return {5: t, 6: t[:, ::-1], 7: t[::-1, ::-1], 8: t[::-1]}[o]
    return img


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))`` of a JPEG."""
    return decode_rgb(_read(path), path)


def read_samples(path: str) -> np.ndarray:
    """``np.array(Image.open(path))`` of a JPEG: (H, W, 3) RGB, or (H, W)
    for a gray (one-component) file, no orientation applied."""
    data = _read(path)
    hdr = header(data, path)
    rgb = decode_rgb(data, path, hdr)
    return np.ascontiguousarray(rgb[..., 0]) if len(hdr.comps) == 1 else rgb


def decode_bgr(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_COLOR)`` of JPEG bytes: (H, W, 3) uint8
    BGR with the EXIF orientation applied."""
    hdr = header(data, path)
    return np.ascontiguousarray(orient(decode_rgb(data, path, hdr), hdr.orientation)[..., ::-1])


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of a JPEG: (H, W, 3) uint8 BGR, EXIF orientation
    applied."""
    return decode_bgr(_read(path), path)


# ---------------------------------------------------------------- encoding

def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_set_quality(cinfo, quality, force_baseline=TRUE)``'s scaling of
    a standard table."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _divisors(q: np.ndarray):
    """``jcdctmgr.c`` ``compute_reciprocal`` of each divisor q * 8 (16-bit
    DCTELEM, as libjpeg-turbo's SIMD builds use): (reciprocal, correction,
    shift) with quantised = sign(x) * (((|x| + correction) * reciprocal) >> shift)."""
    rec, corr, shift = [], [], []
    for d in (q.astype(np.int64) * 8).tolist():
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        rec.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(rec, np.int32), np.array(corr, np.int32), np.array(shift, np.int32)


def fdct_quantize(samples: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(bh * 8, bw * 8) uint8 samples -> (bh, bw, 64) int16 quantised
    coefficients (natural order): ``jpeg_fdct_islow`` (rows with PASS1_BITS
    2, then columns; int32) then ``jcdctmgr.c``'s ``quantize``."""
    bh, bw = samples.shape[0] // 8, samples.shape[1] // 8
    blk = samples.reshape(bh, 8, bw, 8).astype(np.int32) - 128
    x = blk.transpose(3, 1, 0, 2).reshape(8, 8, -1)   # [x][y][n]
    sums = _fdct_sums(list(x))
    rows = _shifted(sums, 11)                         # [u][y][n]
    rows[_EVEN] = np.stack([sums[k] * 4 for k in _EVEN])
    sums = _fdct_sums(list(rows.transpose(1, 0, 2)))
    cols = _shifted(sums, 15)                         # [v][u][n]
    cols[_EVEN] = _shifted([sums[k] for k in _EVEN], 2)
    coef = cols.reshape(64, -1)                       # (64 natural order, n)
    rec, corr, shift = _divisors(q)
    mag = ((np.abs(coef) + corr[:, None]) * rec[:, None]) >> shift[:, None]
    return np.where(coef < 0, -mag, mag).astype(np.int16).T.reshape(bh, bw, 64)


def _rgb_to_ycc(rgb: np.ndarray):
    """``jccolor.c`` ``rgb_ycc_convert``: three (H, W) int32 planes."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    half = 1 << 15
    off = (128 << 16) + half - 1
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b + off) >> 16
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b + off) >> 16
    return y, cb, cr


def _edge(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pad a plane to (h, w) by replicating its last row and column."""
    return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), mode="edge")


def _downsample(p: np.ndarray, hr: int, vr: int, rows: int, cols: int) -> np.ndarray:
    """``jcsample.c``: a full-size plane -> the component's (rows, cols)
    samples (its blocks' extent), for h2v1 and h2v2 with the alternating
    bias; the edges expanded as ``jcprepct.c`` and ``expand_right_edge`` do."""
    if (hr, vr) == (1, 1):
        return _edge(p, rows, cols)
    h = p.shape[0]
    e = _edge(p, h + (h % vr), cols * hr)             # rows to a whole group, columns out
    if (hr, vr) == (2, 1):
        bias = np.tile([0, 1], cols)[:cols]
        d = (e[:, 0::2] + e[:, 1::2] + bias) >> 1
    else:
        bias = np.tile([1, 2], cols)[:cols]
        d = (e[0::2, 0::2] + e[0::2, 1::2] + e[1::2, 0::2] + e[1::2, 1::2] + bias) >> 2
    return _edge(d, rows, cols)


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def encode(img: np.ndarray, quality: int = 95, subsampling: str = "4:2:0") -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> baseline JPEG bytes as
    libjpeg-turbo writes them with ``jpeg_set_defaults``, ``jpeg_set_quality
    (quality, TRUE)`` and the luma sampling of ``subsampling`` (``"4:4:4"``,
    ``"4:2:2"`` or ``"4:2:0"``): JFIF 1.01, one table a marker, the standard
    Huffman tables, no restart markers."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"JPEG writing takes uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG writing takes (H, W) or (H, W, 3) images, not {img.shape}")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"subsampling {subsampling!r}: one of {sorted(SUBSAMPLING)}")
    H, W = img.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"JPEG sizes are 1-65535, not {W}x{H}")
    tables = [quality_table(STD_LUMA_Q, quality), quality_table(STD_CHROMA_Q, quality)]
    if img.ndim == 2:
        planes, samp, tsel = [img.astype(np.int32)], [(1, 1)], [0]
    else:
        planes = list(_rgb_to_ycc(img))
        hs, vs = SUBSAMPLING[subsampling]
        samp, tsel = [(hs, vs), (1, 1), (1, 1)], [0, 1, 1]
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    coefs, geom = [], []
    for p, (h, v), t in zip(planes, samp, tsel):
        rb, cb = -(-H * v // (8 * vmax)), -(-W * h // (8 * hmax))   # blocks with samples
        q = fdct_quantize(_downsample(p, hmax // h, vmax // v, rb * 8, cb * 8).astype(np.uint8),
                          tables[t])
        full = np.zeros((mcuy * v, mcux * h, 64), np.int16)
        full[:rb, :cb] = q
        # jccoefct.c's dummy blocks: zero AC, the DC of the block before
        full[:rb, cb:, 0] = q[:, cb - 1:cb, 0]
        if rb < mcuy * v:
            last = full[rb - 1, h - 1::h, 0]          # each MCU's last block above
            full[rb:, :, 0] = np.repeat(last, h)[None]
        coefs.append(full.reshape(-1))
        geom += [h, v, mcuy * v, mcux * h, t]
    flat = np.concatenate(coefs)
    tbl = np.frombuffer(b"".join(HUFF_DC[t][0] + HUFF_DC[t][1] + HUFF_AC[t][0] + HUFF_AC[t][1]
                                 for t in (0, 1)), np.uint8)
    cap = flat.size * 8 + 1024
    out = np.empty(cap, np.uint8)
    n = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    g = np.array(geom, np.int32)
    if library().mkj_encode(len(planes), _ptr(g), _ptr(flat), flat.size, mcux, mcuy, _ptr(tbl),
                            _ptr(out), cap, ctypes.byref(n), err, len(err)):
        raise ValueError(f"JPEG encoding failed: {err.value.decode()}")
    head = [b"\xff\xd8", _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in sorted(set(tsel)):
        head.append(_marker(0xDB, bytes([t]) + bytes(tables[t][NATURAL].tolist())))
    head.append(_marker(0xC0, struct.pack(">BHHB", 8, H, W, len(planes)) + b"".join(
        bytes([i + 1, (h << 4) | v, t]) for i, ((h, v), t) in enumerate(zip(samp, tsel)))))
    for t in sorted(set(tsel)):
        head.append(_marker(0xC4, bytes([t]) + HUFF_DC[t][0] + HUFF_DC[t][1]))
        head.append(_marker(0xC4, bytes([0x10 | t]) + HUFF_AC[t][0] + HUFF_AC[t][1]))
    head.append(_marker(0xDA, bytes([len(planes)]) + b"".join(
        bytes([i + 1, (t << 4) | t]) for i, t in enumerate(tsel)) + b"\x00\x3f\x00"))
    return b"".join(head) + out[:n.value].tobytes() + b"\xff\xd9"


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)`` for JPEG at cv2's defaults (quality 95,
    4:2:0): gray as it is, colour taken as BGR.  Returns True, as cv2 does."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3:
        img = img[..., ::-1]
    data = encode(img, 95, "4:2:0")
    with open(path, "wb") as fh:
        fh.write(data)
    return True


def pil_save(path: str, img: np.ndarray) -> None:
    """``Image.fromarray(img).save(path)`` of a ``.jpg`` at PIL's defaults
    (quality 75, 4:2:0): (H, W, 3) RGB or (H, W) gray."""
    data = encode(img, 75, "4:2:0")
    with open(path, "wb") as fh:
        fh.write(data)
