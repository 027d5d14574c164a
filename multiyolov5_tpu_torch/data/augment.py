"""The detection loader's image augmentations without cv2 (counterparts of
``multiyolov5_tpu/data/detection.py`` ``random_perspective``,
``box_candidates`` and ``augment_hsv``; reference utils/datasets.py).

The JAX package calls OpenCV (5.0) for these.  This module reproduces what
that OpenCV computes on uint8 images:

* :func:`warp_affine` / :func:`warp_perspective`: ``cv2.warpAffine`` /
  ``cv2.warpPerspective`` with ``INTER_LINEAR`` and a constant border.
  The map is inverted in double (``invertAffineTransform``'s formula, or
  ``cv::invert``'s 3x3 cofactor formula), rounded to float32; each output
  pixel's source coordinate is computed in float32 as OpenCV's vector
  loop computes it, ``fma(m0, x, m1 * y + m2)``, except in a row's last
  ``width % 16`` columns (and the whole row when it is narrower than 16),
  where its scalar tail computes ``fma(x, m0, y * m1) + m2``; a
  perspective map divides the three such sums.  The sample is
  ``lerp(lerp(p00, p01, a), lerp(p10, p11, a), b)``, each lerp one fused
  multiply-add in float32, rounded half to even; a tap outside the image
  takes the border value.  The fused multiply-adds run in float64, where
  each is exact, and round once to float32.
* :func:`bgr2hsv` / :func:`hsv2bgr`: ``cvtColor`` ``COLOR_BGR2HSV`` (the
  8-bit path: 12-bit fixed-point division tables, hue range 180) and
  ``COLOR_HSV2BGR`` (through float32, as OpenCV's 8-bit path does; its
  vector loop truncates where its scalar tail rounds, so a pixel's result
  depends on its column).
* :func:`rgb2yuv` / :func:`yuv2rgb`: ``COLOR_RGB2YUV`` / ``COLOR_YUV2RGB``
  in OpenCV's 14-bit fixed point (Y from 0.299/0.587/0.114, U = 0.492 (B -
  Y), V = 0.877 (R - Y), offset 128; back with 2.032, -0.395, -0.581,
  1.140), rounded by adding half and shifting, saturated.
* :func:`equalize_hist`: ``equalizeHist``: the cumulative histogram past
  the first occupied level, times 255 / (pixels - that level's count) in
  float32, rounded half to even.
* :func:`clahe`: ``createCLAHE(clipLimit, tileGridSize).apply``: an image
  whose sides are not multiples of the grid is padded (reflect-101) by
  ``grid - side % grid`` on both axes, even one that divides; each tile's
  histogram is clipped at ``max(int(clip * tile pixels / 256), 1)``, the
  clipped count spread evenly and its residual one a bin every ``256 //
  residual`` bins from bin 0; the cumulative count times 255 / (tile
  pixels) in float32 is the tile's table, and each pixel blends the four
  nearest tiles' tables bilinearly in float32, rounded half to even.

tests/test_torch_train_data.py holds the warps and the HSV conversions
against cv2 (the colour conversions on every 8-bit colour), and
tests/test_torch_augment_extra.py the YUV conversions (on every colour),
the histogram equalizations and CLAHE, with no bound: they are equal.  The
warps and HSV arithmetic run in torch CPU ops on whole images, the rest
in numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .letterbox import _resize

# OpenCV's vector loop takes 16 output columns a step (two float32
# vectors of 8); the rest of a row goes through its scalar tail
SIMD_COLS = 16
HSV_SHIFT = 12


def rotation_matrix_2d(angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center=(0, 0), angle, scale)`` (2, 3) float64."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, 0.0], [-beta, alpha, 0.0]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """OpenCV's in-place inversion in ``warpAffine`` (no WARP_INVERSE_MAP)."""
    m = np.asarray(m, np.float64).reshape(-1).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _invert_3x3(m: np.ndarray) -> np.ndarray:
    """``cv::invert`` of a 3x3 double matrix (DECOMP_LU's small-matrix
    cofactor formula), flat (9,)."""
    s = np.asarray(m, np.float64).reshape(3, 3)
    d = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
         - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
         + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    if d == 0:
        return np.zeros(9)
    d = 1.0 / d
    return np.array([
        (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d,
        (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
        (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d,
        (s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
        (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
        (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d,
        (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d,
        (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
        (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d])


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Round a float64 tensor to float32 and back (one rounding)."""
    return x.float().double()


def _row_sums(m: np.ndarray, width: int, height: int) -> torch.Tensor:
    """(H, W) float64 tensors holding float32 values: ``m[0] * x + m[1] * y
    + m[2]`` for each output pixel, as OpenCV's vector loop and scalar tail
    compute them (module docstring)."""
    m0, m1, m2 = (float(np.float32(v)) for v in m)
    x = torch.arange(width, dtype=torch.float64)[None, :]
    y = torch.arange(height, dtype=torch.float64)[:, None]
    vec = _f32(m0 * x + (_f32(m1 * y) + m2).float().double())
    tail = _f32(_f32(x * m0 + _f32(y * m1)) + m2)
    n_vec = (width // SIMD_COLS) * SIMD_COLS
    out = vec.expand(height, width).clone()
    out[:, n_vec:] = tail.expand(height, width)[:, n_vec:]
    return out


def _sample(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, border) -> torch.Tensor:
    """Bilinear taps at float32 coordinates (float64 tensors), a constant
    border, OpenCV's lerp order and rounding.  img (h, w, C) uint8."""
    h0, w0, c = img.shape
    ix, iy = torch.floor(sx), torch.floor(sy)
    a = _f32(sx - ix)[..., None]
    b = _f32(sy - iy)[..., None]
    ix, iy = ix.long(), iy.long()
    flat = img.reshape(-1, c)
    fill = torch.as_tensor(np.asarray(border, np.float64).reshape(-1)[:c], dtype=torch.float64)

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < h0) & (xx >= 0) & (xx < w0)
        idx = (yy.clamp(0, h0 - 1) * w0 + xx.clamp(0, w0 - 1)).reshape(-1)
        v = flat.index_select(0, idx).reshape(*yy.shape, c).double()
        return torch.where(inside[..., None], v, fill)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = _f32(a * (p01 - p00) + p00)
    v1 = _f32(a * (p11 - p10) + p10)
    v = _f32(b * _f32(v1 - v0) + v0)
    return torch.round(v).clamp_(0, 255).to(torch.uint8)


def _as_tensor(img) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(img)) if isinstance(img, np.ndarray) else img


def warp_affine(img, m, dsize, border=(114, 114, 114)) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, borderValue=border)``: img (h, w, C)
    uint8, m (2, 3) forward map, dsize (W, H)."""
    inv = _invert_affine(m)
    w, h = int(dsize[0]), int(dsize[1])
    sx = _row_sums(inv[0:3], w, h)
    sy = _row_sums(inv[3:6], w, h)
    return _sample(_as_tensor(img), sx, sy, border).numpy()


def warp_perspective(img, m, dsize, border=(114, 114, 114)) -> np.ndarray:
    """``cv2.warpPerspective(img, m, dsize, borderValue=border)``: m (3, 3)
    forward map; the source point is the float32 quotient of the row sums."""
    inv = _invert_3x3(m)
    w, h = int(dsize[0]), int(dsize[1])
    sx, sy, sw = (_row_sums(inv[k:k + 3], w, h) for k in (0, 3, 6))
    sx = (sx.float() / sw.float()).double()
    sy = (sy.float() / sw.float()).double()
    return _sample(_as_tensor(img), sx, sy, border).numpy()


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1, eps=1e-16):
    """reference utils/datasets.py box_candidates: boxes (4, n) before and
    after the augmentation; keep those still wide, tall and large enough,
    and not too elongated."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & \
        (ar < ar_thr)


def random_perspective(img, targets, rnd, degrees=10, translate=0.1, scale=0.1,
                       shear=10, perspective=0.0, border=(0, 0)):
    """reference utils/datasets.py:851-937 (multiyolov5_tpu/data/detection.py:367-412).

    img (h, w, 3) uint8 BGR; targets (n, 5) [cls, x1, y1, x2, y2] pixels;
    ``rnd`` a ``random.Random`` giving the eight ``uniform`` draws in the
    JAX package's order (perspective x2, angle, scale, shear x2, translate
    x2).  Returns (the warped image, the surviving targets)."""
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2
    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rnd.uniform(-perspective, perspective)
    P[2, 1] = rnd.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rnd.uniform(-degrees, degrees)
    s = rnd.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix_2d(a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rnd.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rnd.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rnd.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rnd.uniform(0.5 - translate, 0.5 + translate) * height
    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = warp_perspective(img, M, (width, height))
        else:
            img = warp_affine(img, M[:2], (width, height))
    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        i = box_candidates(targets[:, 1:5].T * s, new.T)
        targets = targets[i]
        targets[:, 1:5] = new[i]
    return img, targets


def _tables():
    """OpenCV's 8-bit RGB -> HSV division tables (``sdiv_table``,
    ``hdiv_table180``)."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << HSV_SHIFT) / i), 0)
        hdiv = np.where(i > 0, np.rint((180 << HSV_SHIFT) / (6.0 * i)), 0)
    return torch.from_numpy(sdiv.astype(np.int64)), torch.from_numpy(hdiv.astype(np.int64))


_SDIV, _HDIV = _tables()


def bgr2hsv(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 BGR -> HSV, ``cvtColor(COLOR_BGR2HSV)``: H in [0, 180)."""
    x = img.long()
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> HSV_SHIFT
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).clamp_(0, 255).to(torch.uint8)


# HSV2RGB: (b, g, r) as indices into (v, p, q, t) per sector
_SECTOR = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
# OpenCV's vector loop converts 32 pixels a step (four float32 vectors of
# 8) and truncates; the scalar tail rounds
HSV_SIMD_PIXELS = 32


def hsv2bgr(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 HSV (H in [0, 180)) -> BGR, ``cvtColor(COLOR_HSV2BGR)``.

    s and v scaled by 1/255 and the hue by 6/180 in float32, the sector
    table with ``1 - s * h`` fused, then x 255: OpenCV's vector loop (a
    row's first ``W // 32 * 32`` pixels) truncates it, its scalar tail
    rounds half to even."""
    f = img.float()
    h = f[..., 0] * np.float32(6.0 / 180.0)
    s = f[..., 1] * np.float32(1.0 / 255.0)
    v = f[..., 2] * np.float32(1.0 / 255.0)
    sector = torch.floor(h)
    h = h - sector
    sector = sector.long().clamp_(0, 5)
    sd, hd = s.double(), h.double()
    q = (1.0 - sd * hd).float()                    # fma(-s, h, 1)
    t = (1.0 - sd * (1.0 - h).double()).float()    # fma(-s, 1 - h, 1)
    tab = torch.stack([v, v * (1.0 - s), v * q, v * t], -1)
    x = tab.gather(-1, _SECTOR[sector]) * 255.0
    n_vec = (img.shape[-2] // HSV_SIMD_PIXELS) * HSV_SIMD_PIXELS
    out = torch.round(x)
    out[..., :n_vec, :] = torch.trunc(x[..., :n_vec, :])
    return out.clamp_(0, 255).to(torch.uint8)


def augment_hsv(img: np.ndarray, nrs, hgain=0.5, sgain=0.5, vgain=0.5) -> None:
    """In place, reference utils/datasets.py:646-657
    (multiyolov5_tpu/data/detection.py:423-433): gains ``nrs.uniform(-1, 1,
    3)`` (an ``np.random.RandomState``) scale hue (mod 180), saturation and
    value through 256-entry tables, between :func:`bgr2hsv` and
    :func:`hsv2bgr`."""
    r = nrs.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    x = np.arange(0, 256, dtype=np.int16)
    lut = np.stack([((x * r[0]) % 180).astype(np.uint8),
                    np.clip(x * r[1], 0, 255).astype(np.uint8),
                    np.clip(x * r[2], 0, 255).astype(np.uint8)], 1)
    t = torch.from_numpy(img)
    hsv = bgr2hsv(t).long()
    lut_t = torch.from_numpy(lut).long()
    hsv = torch.stack([lut_t[hsv[..., k], k] for k in range(3)], -1).to(torch.uint8)
    img[...] = hsv2bgr(hsv).numpy()


def resize_linear(img: np.ndarray, wh) -> np.ndarray:
    """``cv2.resize(img, wh, interpolation=INTER_LINEAR)`` on uint8 (a grow
    or a shrink; ``data/letterbox._resize``)."""
    return _resize(torch.from_numpy(np.ascontiguousarray(img)), tuple(wh)).numpy()


YUV_SHIFT = 14


def _descale(x: np.ndarray) -> np.ndarray:
    return (x + (1 << (YUV_SHIFT - 1))) >> YUV_SHIFT


def rgb2yuv(img: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> YUV, ``cvtColor(COLOR_RGB2YUV)`` (BGR input
    reversed first is ``COLOR_BGR2YUV``)."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    y = _descale(r * 4899 + g * 9617 + b * 1868)
    u = _descale((b - y) * 8061 + (128 << YUV_SHIFT))
    v = _descale((r - y) * 14369 + (128 << YUV_SHIFT))
    return np.clip(np.stack([y, u, v], -1), 0, 255).astype(np.uint8)


def yuv2rgb(img: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 YUV -> RGB, ``cvtColor(COLOR_YUV2RGB)``."""
    y = img[..., 0].astype(np.int64)
    u, v = img[..., 1].astype(np.int64) - 128, img[..., 2].astype(np.int64) - 128
    r = y + _descale(v * 18678)
    g = y + _descale(u * -6472 + v * -9519)
    b = y + _descale(u * 33292)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def equalize_hist(img: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> ``cv2.equalizeHist(img)``."""
    hist = np.bincount(img.ravel(), minlength=256)
    lo = int(np.argmax(hist > 0))
    if hist[lo] == img.size:
        return np.full_like(img, lo)
    scale = np.float32(255.0) / np.float32(img.size - hist[lo])
    lut = np.zeros(256, np.uint8)
    lut[lo + 1:] = np.clip(np.rint(np.cumsum(hist[lo + 1:]).astype(np.float32) * scale), 0, 255)
    return lut[img]


def clahe(img: np.ndarray, clip_limit: float = 2.0, grid=(8, 8)) -> np.ndarray:
    """(H, W) uint8 -> ``cv2.createCLAHE(clip_limit, grid).apply(img)``
    (``grid`` as (tiles across, tiles down))."""
    h, w = img.shape
    gx, gy = grid
    src = img
    if h % gy or w % gx:
        src = np.pad(img, ((0, gy - h % gy), (0, gx - w % gx)), mode="reflect")
    th, tw = src.shape[0] // gy, src.shape[1] // gx
    area = th * tw
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    tiles = src.reshape(gy, th, gx, tw).transpose(0, 2, 1, 3).reshape(gy, gx, area)
    hist = np.stack([[np.bincount(t, minlength=256) for t in row] for row in tiles])
    if limit:
        clipped = np.maximum(hist - limit, 0).sum(-1)
        hist = np.minimum(hist, limit) + (clipped // 256)[..., None]
        for (j, i), resid in np.ndenumerate(clipped % 256):
            if resid:
                hist[j, i, ::max(256 // resid, 1)][:resid] += 1
    scale = np.float32(255) / np.float32(area)
    luts = np.clip(np.rint(np.cumsum(hist, -1).astype(np.float32) * scale), 0, 255)

    def axis(n, tile, tiles):
        f = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(tile)) - np.float32(0.5)
        lo = np.floor(f).astype(np.int64)
        a = f - lo.astype(np.float32)
        return np.maximum(lo, 0), np.minimum(lo + 1, tiles - 1), np.float32(1) - a, a

    x1, x2, xa1, xa = axis(w, tw, gx)
    y1, y2, ya1, ya = axis(h, th, gy)
    v = img.astype(np.int64)

    def lut(ty, tx):
        return luts[ty[:, None], tx[None, :], v].astype(np.float32)

    res = ((lut(y1, x1) * xa1 + lut(y1, x2) * xa) * ya1[:, None]
           + (lut(y2, x1) * xa1 + lut(y2, x2) * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
