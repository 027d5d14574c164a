"""One reader and one writer for the port's image formats, PNG and JPEG.

A file is read by its signature (PNG's, or JPEG's ``FF D8 FF``), as cv2
reads it, whatever its suffix; a file is written by its suffix.  The two
semantics of the JAX package stay apart:

* :func:`imread` is ``cv2.imread(path)``: (H, W, 3) uint8 BGR, a JPEG's
  EXIF orientation applied;
* :func:`read_rgb` / :func:`decode_rgb` are ``Image.open(...).convert("RGB")``:
  (H, W, 3) uint8 RGB, no orientation applied;
* :func:`exif_size` is the JAX ``exif_size(Image.open(path))``: (w, h)
  from the header, swapped for EXIF orientations 6 and 8 (a PNG's size as
  ``data/png.py`` reads it).

:func:`require_readable` raises ``NotImplementedError`` naming the first
path of a list whose suffix is an image format the port does not decode
(bmp, tif, tiff, dng, webp, mpo): the loaders, hub and tools check their
inputs with it before they read any.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from . import jpeg, png

READABLE = ("png", "jpg", "jpeg")
JPEG_SIGNATURE = b"\xff\xd8\xff"


def _codec(head: bytes, path: str):
    if head[:8] == png.SIGNATURE:
        return png
    if head[:3] == JPEG_SIGNATURE:
        return jpeg
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def _codec_of(path: str):
    with open(path, "rb") as fh:
        return _codec(fh.read(8), path)


def _suffix(path) -> str:
    return str(path).rsplit(".", 1)[-1].lower()


def require_readable(paths: Sequence, what: str) -> None:
    """Raise ``NotImplementedError`` naming the first image that is neither
    PNG nor JPEG by its suffix."""
    for p in paths:
        if _suffix(p) not in READABLE:
            raise NotImplementedError(
                f"{p}: the port reads PNG and JPEG images only ({what}); "
                f"{_suffix(p).upper()} needs a decoder the port does not have")


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)``: (H, W, 3) uint8 BGR."""
    return _codec_of(path).imread(path)


def decode_rgb(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(BytesIO(data)).convert("RGB"))``."""
    return _codec(data[:8], path).decode_rgb(data, path)


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))``."""
    return _codec_of(path).read_rgb(path)


def size(path: str) -> Tuple[int, int]:
    """(width, height) as PIL's ``Image.open(path).size``."""
    return _codec_of(path).size(path)


def exif_size(path: str) -> Tuple[int, int]:
    """The JAX ``exif_size(Image.open(path))``."""
    codec = _codec_of(path)
    return jpeg.exif_size(path) if codec is jpeg else png.size(path)


def imwrite(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)`` for ``.png``, ``.jpg`` and ``.jpeg``
    (JPEG at cv2's defaults); gray as it is, colour taken as BGR."""
    s = _suffix(path)
    if s == "png":
        return png.imwrite(path, img)
    if s in ("jpg", "jpeg"):
        return jpeg.imwrite(path, img)
    raise NotImplementedError(f"{path}: the port writes PNG and JPEG images only")
