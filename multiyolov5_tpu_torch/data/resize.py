"""The two host resamplers of the eval loaders, on uint8 numpy images, equal
to the libraries the JAX loaders call.

* :func:`resize_area`: ``cv2.resize(img, (w, h), interpolation=INTER_AREA)``
  for a shrink (OpenCV ``imgproc/src/resize.cpp``), as the detection loader
  calls it (multiyolov5_tpu/data/detection.py:218-224).  An integer factor
  on both axes takes cv2's ``resizeAreaFast_``: at 2x2 the rounded mean
  ``(a + b + c + d + 2) >> 2`` of each block, at other factors the block
  sum times ``1 / area`` in float32, rounded half to even.  Any other
  factor takes ``ResizeArea_Invoker``: the fractional-coverage weights of
  ``computeResizeAreaTab`` (double, stored as float32), a horizontal pass
  per source row and a vertical pass per destination row, both summed in
  float32 in cv2's order, rounded half to even.
* :func:`resize_bilinear_pil`: PIL's ``Image.resize(size, BILINEAR)``
  (Pillow ``src/libImaging/Resample.c``), as the seg loaders' testval
  transform calls it (multiyolov5_tpu/data/segmentation.py:95-105).  The
  triangle filter's support widens by the scale when it shrinks; each
  output's coefficients are normalised in double, then turned into fixed
  point with 22 fractional bits; the horizontal pass runs first, rounded
  and clipped to uint8, then the vertical pass.  All of it is integer
  arithmetic after the coefficients.

A grow goes through cv2's ``INTER_LINEAR``, which ``data/letterbox.py``
``_resize`` already reproduces.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

# Resample.c: 32 bits less 8 for the sample and 2 for the sign and headroom
PRECISION_BITS = 22


def _hwc(img: np.ndarray) -> Tuple[np.ndarray, bool]:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"the resamplers take uint8 images, not {img.dtype}")
    if img.ndim == 2:
        return img[..., None], True
    return img, False


def _area_tab(ssize: int, dsize: int, scale: float):
    """``computeResizeAreaTab`` as (dst index, src index, weight) rows in
    cv2's order: per destination index its sources left to right."""
    di, si, alpha = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1), alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx), alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2), alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return np.array(di), np.array(si), np.array(alpha, np.float32)


def _slots(di: np.ndarray, si: np.ndarray, alpha: np.ndarray, dsize: int):
    """The table as (dsize, k) source indices and weights, a destination's
    terms in order along k, zero weights past its last term."""
    starts = np.searchsorted(di, np.arange(dsize))
    pos = np.arange(len(di)) - starts[di]
    k = int(pos.max()) + 1
    idx = np.zeros((dsize, k), np.int64)
    w = np.zeros((dsize, k), np.float32)
    idx[di, pos], w[di, pos] = si, alpha
    return idx, w


def _area_fractional(img: np.ndarray, wh: Tuple[int, int], sx: float, sy: float) -> np.ndarray:
    """``ResizeArea_Invoker``<uchar, float>: buf += S * alpha along x in the
    table's order, then sum = beta * buf, sum += beta * buf along y, all
    float32 (no fused multiply-add), rounded half to even."""
    h0, w0, _ = img.shape
    xi, xw = _slots(*_area_tab(w0, wh[0], sx), wh[0])
    yi, yw = _slots(*_area_tab(h0, wh[1], sy), wh[1])
    src = img.astype(np.float32)
    buf = src[:, xi[:, 0]] * xw[:, 0, None]
    for k in range(1, xi.shape[1]):
        buf = buf + src[:, xi[:, k]] * xw[:, k, None]
    acc = yw[:, 0, None, None] * buf[yi[:, 0]]
    for k in range(1, yi.shape[1]):
        acc = acc + yw[:, k, None, None] * buf[yi[:, k]]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 -> (h, w[, C]) uint8, equal to
    ``cv2.resize(img, wh, interpolation=cv2.INTER_AREA)`` for ``wh`` no
    larger than the image on either axis."""
    x, gray = _hwc(img)
    h0, w0, c = x.shape
    w, h = int(wh[0]), int(wh[1])
    if w > w0 or h > h0 or w < 1 or h < 1:
        raise ValueError(f"resize_area shrinks: {w0}x{h0} -> {w}x{h}")
    # cv2::resize: scale = 1 / (dst / src) in double; integer within DBL_EPSILON
    sx, sy = 1.0 / (w / w0), 1.0 / (h / h0)
    ix, iy = int(round(sx)), int(round(sy))
    eps = np.finfo(np.float64).eps
    if abs(sx - ix) < eps and abs(sy - iy) < eps:
        if (ix, iy) == (1, 1):
            out = x.copy()
        else:
            blocks = x[:h * iy, :w * ix].reshape(h, iy, w, ix, c).astype(np.int32).sum((1, 3))
            if (ix, iy) == (2, 2) and c != 2:   # ResizeAreaFastVec: the rounded mean
                out = ((blocks + 2) >> 2).astype(np.uint8)
            else:                           # sum * (1.f / area), cvRound
                q = blocks.astype(np.float32) * np.float32(1.0 / (ix * iy))
                out = np.clip(np.rint(q), 0, 255).astype(np.uint8)
    else:
        out = _area_fractional(x, (w, h), sx, sy)
    return out[..., 0] if gray else out


def _pil_coeffs(in_size: int, out_size: int):
    """``precompute_coeffs`` with the BILINEAR filter, then
    ``normalize_coeffs_8bpc``: (out_size, k) source indices (past a
    window's end their weight is 0) and int32 fixed-point weights, k the
    widest window."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = sum(ws)
        for x, wv in enumerate(ws):
            wv = wv / ww if ww != 0.0 else wv
            kk[xx, x] = int(0.5 + wv * (1 << PRECISION_BITS))
        idx[xx, :xmax] = np.arange(xmin, xmin + xmax)
        idx[xx, xmax:] = xmin
    widest = max(int(((kk != 0) * np.arange(1, ksize + 1)).max()), 1)
    return idx[:, :widest], kk[:, :widest].astype(np.int32)


def _pil_pass(x: np.ndarray, idx: np.ndarray, kk: np.ndarray, axis: int) -> np.ndarray:
    """One pass along ``axis`` (1: x, 0: y): the 1 << 21 rounding term plus
    the taps, shifted by 22 and clipped to uint8 (``clip8``).  The sum fits
    in int32, as in Resample.c: 255 times the weights' sum (2^22 and a few
    units of rounding) plus 2^21."""
    acc = np.full(x.shape[:axis] + (idx.shape[0],) + x.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    shape = (-1, 1, 1) if axis == 0 else (1, -1, 1)
    for k in range(idx.shape[1]):
        acc += np.take(x, idx[:, k], axis=axis) * kk[:, k].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_pil(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 -> (h, w[, C]) uint8, equal to PIL's
    ``Image.fromarray(img).resize(wh, Image.BILINEAR)``."""
    x, gray = _hwc(img)
    h0, w0, _ = x.shape
    w, h = int(wh[0]), int(wh[1])
    if (w, h) != (w0, h0):
        if w != w0:
            x = _pil_pass(x, *_pil_coeffs(w0, w), axis=1)
        if h != h0:
            x = _pil_pass(x, *_pil_coeffs(h0, h), axis=0)
    else:
        x = x.copy()
    return x[..., 0] if gray else x
