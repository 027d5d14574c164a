"""One reader and one writer for the port's still-image formats: PNG,
JPEG (and MPO, a JPEG whose first frame is read), BMP, baseline TIFF and
WebP (lossy, lossless, with alpha, an animation's first frame).

A file is read by its signature (PNG's, JPEG's ``FF D8 FF``, ``BM``,
``II*\\0`` / ``MM\\0*``, ``RIFF....WEBP``), as cv2 reads it, whatever its
suffix; a file is written by its suffix.  The JAX package's semantics stay
apart, each the library the caller there uses:

* :func:`imread` is ``cv2.imread(path)``: (H, W, 3) uint8 BGR, the
  orientation applied where OpenCV 5.0 applies it (a JPEG's or MPO's EXIF,
  a PNG's ``eXIf``, a TIFF's tag, a WebP's ``EXIF`` chunk);
* :func:`read_rgb` / :func:`decode_rgb` are ``Image.open(...).convert("RGB")``:
  (H, W, 3) uint8 RGB, no orientation applied but a TIFF's (Pillow turns a
  TIFF as it loads it);
* :func:`read_samples` is ``np.array(Image.open(path))``, the samples in
  PIL's mode (the seg loaders read their masks with it: uint16 for 16-bit
  gray, bool for 1-bit, a palette's indices);
* :func:`size` is PIL's ``Image.open(path).size`` and :func:`exif_size`
  the JAX ``exif_size`` as the JAX label cache calls it, after
  ``Image.verify()``: (w, h), swapped for EXIF orientations 6 and 8.

Each codec module (``png``, ``jpeg``, ``bmp``, ``tiff``, ``webp``)
documents its forms, and where OpenCV and Pillow read one differently.
Where cv2 returns None or PIL raises on a file, the port raises, naming the
file.  :func:`require_readable` raises ``NotImplementedError`` naming the
first path of a list whose suffix is an image format the port does not
decode (``dng``): the loaders, hub and tools check their inputs with it
before they read any.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from . import bmp, jpeg, png, tiff, webp

READABLE = ("png", "jpg", "jpeg", "mpo", "bmp", "tif", "tiff", "webp")
WRITABLE = {"png": png, "jpg": jpeg, "jpeg": jpeg, "jpe": jpeg, "bmp": bmp, "dib": bmp,
            "tif": tiff, "tiff": tiff, "webp": webp}
JPEG_SIGNATURE = b"\xff\xd8\xff"
# formats of the JAX package's IMG_FORMATS that the port does not decode, and why
UNREADABLE = {
    "dng": "DNG is raw sensor data whose development (demosaicing, colour matrices) cv2 "
           "and PIL leave to libraw / libtiff in ways the port does not reproduce",
}


def _codec(head: bytes, path: str):
    if head[:8] == png.SIGNATURE:
        return png
    if head[:3] == JPEG_SIGNATURE:
        return jpeg
    if head[:2] == bmp.SIGNATURE:
        return bmp
    if head[:4] in tiff.SIGNATURES + tiff.BIG_SIGNATURES:
        return tiff
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return webp
    raise ValueError(f"{path}: not a PNG, JPEG, BMP, TIFF or WebP file")


def known_signature(head: bytes) -> bool:
    """Whether bytes start as a file the port reads."""
    try:
        _codec(head, "")
        return True
    except ValueError:
        return False


def _codec_of(path: str):
    with open(path, "rb") as fh:
        return _codec(fh.read(12), path)


def _suffix(path) -> str:
    return str(path).rsplit(".", 1)[-1].lower()


def require_readable(paths: Sequence, what: str) -> None:
    """Raise ``NotImplementedError`` naming the first image whose suffix is
    not one the port reads (PNG, JPEG, MPO, BMP, TIFF, WebP)."""
    for p in paths:
        s = _suffix(p)
        if s not in READABLE:
            why = UNREADABLE.get(s, f"{s.upper()} needs a decoder the port does not have")
            raise NotImplementedError(
                f"{p}: the port reads PNG, JPEG, MPO, BMP, TIFF and WebP images only ({what}); "
                f"{why}")


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)``: (H, W, 3) uint8 BGR."""
    return _codec_of(path).imread(path)


def decode_rgb(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(BytesIO(data)).convert("RGB"))``."""
    return _codec(data[:12], path).decode_rgb(data, path)


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))``."""
    return _codec_of(path).read_rgb(path)


def read_samples(path: str) -> np.ndarray:
    """``np.array(Image.open(path))``."""
    return _codec_of(path).read_samples(path)


def size(path: str) -> Tuple[int, int]:
    """(width, height) as PIL's ``Image.open(path).size``."""
    return _codec_of(path).size(path)


def exif_size(path: str) -> Tuple[int, int]:
    """The JAX ``exif_size`` as its label cache calls it, after
    ``Image.verify()`` (which for PNG checks every chunk and leaves an
    ``eXIf`` after the image data unread)."""
    return _codec_of(path).exif_size(path)


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)`` by suffix: PNG, JPEG at cv2's defaults,
    BMP and TIFF (LZW) as cv2 writes them, WebP lossless as cv2's default
    decodes; gray as it is, colour taken as BGR.  Any other suffix raises ``ValueError`` with cv2's message, as
    ``cv2.imwrite`` raises for ``.mpo`` (it has no MPO writer) and for a
    name without one."""
    s = _suffix(path) if "." in os.path.basename(str(path)) else ""
    if s not in WRITABLE:
        raise ValueError(f"{path}: could not find a writer for the specified extension (the "
                         f"port writes .{', .'.join(WRITABLE)})")
    return WRITABLE[s].imwrite(path, img)
