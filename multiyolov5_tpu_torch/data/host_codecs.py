"""The sequential decoders of the BMP and TIFF codecs, in host C++.

``csrc/host/codecs.cpp`` holds what runs a byte at a time: TIFF's LZW
(libtiff's decoder, and its encoder byte for byte) and PackBits, and BMP's
RLE8 / RLE4 as OpenCV and Pillow each read them.  g++ builds it into
``build/host/`` at first use (``utils/shared_library.py``); it is bound
through ctypes here.  Each function takes and returns numpy arrays and
raises ``ValueError`` naming ``path`` where the data is corrupt.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..utils.shared_library import host_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "codecs.cpp"


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for fn in (lib.mkc_lzw_decode, lib.mkc_lzw_encode, lib.mkc_packbits_decode):
        fn.argtypes = [p, i64, p, i64, p, ctypes.c_char_p, i32]
        fn.restype = i32
    lib.mkc_bmp_rle.argtypes = [p, i64, i64, i32, i32, i32, i32, p, p, ctypes.c_char_p, i32]
    lib.mkc_bmp_rle.restype = i32


_LIB = host_library(SOURCE, "libmultiyolov5_codecs", _bind)


def library() -> ctypes.CDLL:
    """The host library, built from ``csrc/host/codecs.cpp`` if this process
    has not loaded it yet."""
    return _LIB.load()


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _stream(fn, data: bytes, cap: int, path: str, what: str) -> np.ndarray:
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(cap, np.uint8)
    n = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    if fn(_ptr(src), src.size, _ptr(out), cap, ctypes.byref(n), err, len(err)):
        raise ValueError(f"{path}: {what}: {err.value.decode()}")
    return out[:n.value]


def lzw_decode(data: bytes, size: int, path: str = "<bytes>") -> np.ndarray:
    """A TIFF LZW chunk -> its ``size`` bytes; fewer raises."""
    out = _stream(library().mkc_lzw_decode, data, size, path, "LZW")
    if out.size < size:
        raise ValueError(f"{path}: LZW data ends {size - out.size} bytes short of its chunk")
    return out


def lzw_encode(data: np.ndarray) -> bytes:
    """Bytes -> one TIFF LZW strip, as libtiff encodes it."""
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    cap = data.size * 2 + 64            # 12 bits a byte at worst, plus Clear/EOI codes
    return _stream(library().mkc_lzw_encode, data.tobytes(), cap, "<bytes>", "LZW").tobytes()


def packbits_decode(data: bytes, size: int, path: str = "<bytes>") -> np.ndarray:
    """A TIFF PackBits chunk -> its ``size`` bytes; fewer raises."""
    out = _stream(library().mkc_packbits_decode, data, size, path, "PackBits")
    if out.size < size:
        raise ValueError(f"{path}: PackBits data ends {size - out.size} bytes short of its chunk")
    return out


def bmp_rle(data: bytes, offset: int, w: int, h: int, rle4: bool, pil: bool,
            path: str = "<bytes>") -> np.ndarray:
    """BMP RLE8 / RLE4 data from ``offset`` of the file ``data`` -> (h, w)
    uint8 palette indices in the file's row order, as OpenCV (``pil``
    False) or Pillow decodes them.  Pillow's short output raises as Pillow
    does ("not enough image data")."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(w * h, np.uint8)
    n = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    if library().mkc_bmp_rle(_ptr(src), src.size, offset, w, h, int(rle4), int(pil), _ptr(out),
                             ctypes.byref(n), err, len(err)):
        raise ValueError(f"{path}: BMP RLE{4 if rle4 else 8}: {err.value.decode()}")
    if n.value < w * h:
        raise ValueError(f"{path}: BMP RLE{4 if rle4 else 8}: not enough image data")
    return out.reshape(h, w)
