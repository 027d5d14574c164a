"""The seg loaders' Pillow operations without PIL (counterparts of the PIL
calls in ``multiyolov5_tpu/data/segmentation.py``; Pillow ``src/libImaging``).

On uint8 numpy images, equal to Pillow 12 value for value:

* :func:`blend`: ``Image.blend`` (``Blend.c``): ``in1 + alpha * (in2 -
  in1)`` in float32 with alpha a float32, truncated (clipped to [0, 255]
  first when alpha is outside [0, 1]).
* :func:`to_l`: RGB -> L (``Convert.c``): ``(19595 R + 38470 G + 7471 B +
  0x8000) >> 16``.
* :func:`brightness`, :func:`contrast`, :func:`color`: ``ImageEnhance``
  blends toward black, toward the L image's rounded mean, toward the L
  image as RGB.
* :func:`rgb2hsv`, :func:`hsv2rgb`: ``convert("HSV")`` and back
  (``Convert.c`` ``rgb2hsv_row`` / ``hsv2rgb``, float32 arithmetic with
  double constants, as C promotes them).
* :func:`resize_nearest`: ``resize(NEAREST)`` (``Geometry.c``
  ``ImagingScaleAffine``): the source coordinate of output pixel k is
  ``scale / 2`` plus ``scale`` added k times in double, truncated.

tests/test_torch_train_data.py holds each against Pillow: the colour
conversions and the blend on every input, with no bound.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(im1, im2, alpha)`` on uint8 arrays of one shape."""
    a = np.float32(alpha)
    x1 = im1.astype(np.float32)
    v = x1 + a * (im2.astype(np.float32) - x1)
    if not 0.0 <= alpha <= 1.0:
        v = np.clip(v, 0, 255)
    return v.astype(np.uint8)


def to_l(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 L."""
    x = rgb.astype(np.int64)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _gray_rgb(lum: np.ndarray) -> np.ndarray:
    return np.repeat(lum[..., None], 3, -1)


def brightness(img: np.ndarray, f: float) -> np.ndarray:
    """``ImageEnhance.Brightness(img).enhance(f)``."""
    return blend(np.zeros_like(img), img, f)


def contrast(img: np.ndarray, f: float) -> np.ndarray:
    """``ImageEnhance.Contrast(img).enhance(f)``: toward the L image's
    mean, ``int(mean + 0.5)``."""
    lum = to_l(img)
    mean = int(int(lum.sum(dtype=np.int64)) / lum.size + 0.5)
    return blend(np.full_like(img, mean), img, f)


def color(img: np.ndarray, f: float) -> np.ndarray:
    """``ImageEnhance.Color(img).enhance(f)``."""
    return blend(_gray_rgb(to_l(img)), img, f)


def rgb2hsv(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> HSV, ``convert("HSV")`` (``rgb2hsv_row``)."""
    x = rgb.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    gray = maxc == minc
    cr = np.where(gray, 1, maxc - minc).astype(np.float32)
    s = cr / np.where(gray, 1, maxc).astype(np.float32)
    rc = (maxc - r).astype(np.float32) / cr
    gc = (maxc - g).astype(np.float32) / cr
    bc = (maxc - b).astype(np.float32) / cr
    # 2.0 + rc - bc etc. in double, stored in the float h
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc, 2.0 + rc.astype(np.float64) - bc,
                          4.0 + gc.astype(np.float64) - rc)).astype(np.float32)
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    out = np.stack([np.where(gray, 0, uh), np.where(gray, 0, us), maxc], -1)
    return out.astype(np.uint8)


def hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 HSV -> RGB, ``Image.fromarray(hsv, "HSV").convert("RGB")``
    (``hsv2rgb``)."""
    x = hsv.astype(np.int64)
    hf = x[..., 0].astype(np.float32).astype(np.float64)
    v = x[..., 2]
    vf = v.astype(np.float32).astype(np.float64)
    i = np.floor(hf * 6.0 / 255.0).astype(np.int64)              # 0 to 6
    f = (hf * 6.0 / 255.0 - i).astype(np.float32).astype(np.float64)
    fs = (x[..., 1].astype(np.float32) / 255.0).astype(np.float32).astype(np.float64)

    def rnd(y):           # C round(): half away from zero, then CLIP8
        return np.clip(np.sign(y) * np.floor(np.abs(y) + 0.5), 0, 255).astype(np.int64)

    p = rnd(vf * (1.0 - fs))
    q = rnd(vf * (1.0 - (fs * f).astype(np.float32)))      # float * float
    t = rnd(vf * (1.0 - fs * (1.0 - f)))
    sector = i % 6
    r = np.choose(sector, [v, q, p, p, t, v])
    g = np.choose(sector, [t, v, v, q, p, p])
    b = np.choose(sector, [p, p, t, v, v, q])
    out = np.stack([r, g, b], -1)
    gray = (x[..., 1] == 0)[..., None]
    return np.where(gray, v[..., None], out).astype(np.uint8)


def hue_shift(img: np.ndarray, h: float) -> np.ndarray:
    """The JAX ``color_jitter``'s hue op: HSV, hue + int(h * 255) mod 256, RGB."""
    hsv = rgb2hsv(img)
    hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(h * 255)) % 256
    return hsv2rgb(hsv)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    scale = in_size / out_size
    out = np.empty(out_size, np.int64)
    xo = scale * 0.5
    for k in range(out_size):
        out[k] = -1 if xo < 0 else int(xo)
        xo += scale
    return np.clip(out, 0, in_size - 1)


def resize_nearest(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(wh, NEAREST)`` on an (H, W[, C]) uint8 array."""
    w, h = int(wh[0]), int(wh[1])
    h0, w0 = img.shape[:2]
    return img[_nearest_index(h0, h)][:, _nearest_index(w0, w)]
