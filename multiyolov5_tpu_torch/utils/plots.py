"""Box drawing (counterpart of ``plot_one_box``, multiyolov5_tpu/utils/plots.py:24-36),
in numpy.

The app draws each detection as cv2 would at its one setting: a box
outline of thickness 3, a filled label rectangle and the label in Hershey
font 0 at ``fontScale`` 1, thickness 2, all anti-aliased.  What cv2 draws
for these comes from ``glyphs.npz`` (made by ``tools/make_glyphs.py`` with
cv2): the coverage of the outline and of the label rectangle at every size
up to a base size (a larger one repeats the base's middle row and column),
and each printable ASCII character's coverage and advance.  A stamp is
blended into the image as ``round(p + (color - p) * coverage / 255)``:
fully covered pixels take the colour exactly; at the anti-aliased edges,
where cv2 blends each stroke in turn with its own integer rounding, the
result can differ from cv2's by a few levels, and more where a shape is
clipped at the image's edge.  ``add_weighted`` is ``cv2.addWeighted`` on
uint8 images.  ``color_list`` is the JAX package's ten base colours (the
hub draws with them).  Nothing else of the JAX ``plots.py`` is ported: the
rest needs matplotlib.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import numpy as np

TEXT_COLOR = (225, 255, 255)


def color_list():
    """matplotlib's tab10 base colours as RGB tuples
    (multiyolov5_tpu/utils/plots.py:17)."""
    hexs = ("1f77b4", "ff7f0e", "2ca02c", "d62728", "9467bd", "8c564b",
            "e377c2", "7f7f7f", "bcbd22", "17becf")
    return [tuple(int(h[i:i + 2], 16) for i in (0, 2, 4)) for h in hexs]


@functools.lru_cache(maxsize=1)
def _table() -> dict:
    with np.load(os.path.join(os.path.dirname(__file__), "glyphs.npz")) as z:
        t = {k: z[k] for k in z.files}
    t["chars"] = bytes(t["chars"]).decode()
    return t


def _stretch(stamps: np.ndarray, w: int, h: int) -> np.ndarray:
    """The coverage stamp of a w x h shape, ``margin`` pixels around it."""
    t = _table()
    base, m = int(t["base"]), int(t["margin"])
    s = stamps[min(w, base), min(h, base)]
    s = s[:min(h, base) + 2 * m + 1, :min(w, base) + 2 * m + 1]
    mid = m + base // 2 + 1
    if w > base:
        s = np.concatenate([s[:, :mid], np.repeat(s[:, mid:mid + 1], w - base + 1, 1),
                            s[:, mid + 1:]], 1)
    if h > base:
        s = np.concatenate([s[:mid], np.repeat(s[mid:mid + 1], h - base + 1, 0),
                            s[mid + 1:]], 0)
    return s


def _blend(img: np.ndarray, cover: np.ndarray, x0: int, y0: int, color) -> None:
    """Blend ``color`` into ``img`` (H, W, 3) uint8 by ``cover`` (0-255)
    placed with its top-left pixel at (x0, y0), clipped to the image."""
    h, w = img.shape[:2]
    ya, xa = max(0, y0), max(0, x0)
    yb, xb = min(h, y0 + cover.shape[0]), min(w, x0 + cover.shape[1])
    if ya >= yb or xa >= xb:
        return
    a = cover[ya - y0:yb - y0, xa - x0:xb - x0, None].astype(np.float32) / 255
    p = img[ya:yb, xa:xb].astype(np.float32)
    img[ya:yb, xa:xb] = np.rint(p + (np.asarray(color, np.float32) - p) * a)


def _glyph_index(c: str) -> int:
    """A character's row of the glyph table (printable ASCII); '?' for any other."""
    chars = _table()["chars"]
    return chars.find(c if c in chars else "?")


def text_size(label: str):
    """``cv2.getTextSize(label, 0, 1, 2)[0]``: (width, height)."""
    t = _table()
    idx = [_glyph_index(c) for c in label]
    return int(t["advance"][idx].sum() + t["text_pad"]), int(t["text_height"])


def _put_text(img: np.ndarray, label: str, org) -> None:
    """``cv2.putText(img, label, org, 0, 1, TEXT_COLOR, 2, LINE_AA)``."""
    t = _table()
    oy, ox = (int(v) for v in t["glyph_origin"])
    x = int(org[0])
    for c in label:
        i = _glyph_index(c)
        _blend(img, t["glyphs"][i], x - ox, int(org[1]) - oy, TEXT_COLOR)
        x += int(t["advance"][i])


def plot_one_box(x: Sequence[float], img: np.ndarray, color=None, label: Optional[str] = None,
                 line_thickness: int = 3) -> None:
    """Draw one xyxy box on a BGR (H, W, 3) uint8 image, in place, as
    multiyolov5_tpu/utils/plots.py:24-36 does with cv2."""
    t = _table()
    tl = line_thickness or round(0.002 * (img.shape[0] + img.shape[1]) / 2) + 1
    if tl != int(t["thickness"]):
        raise ValueError(f"boxes are drawn at line_thickness {int(t['thickness'])} only, not {tl}")
    color = color or [np.random.randint(0, 255) for _ in range(3)]
    m = int(t["margin"])
    x0, y0, x1, y1 = (int(v) for v in x[:4])
    x0, x1, y0, y1 = min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1)
    s = _stretch(t["outline"], x1 - x0, y1 - y0)
    k = 2 * m + 1                 # the outline's band; inside it cv2 draws nothing
    if min(s.shape) <= 2 * k:
        _blend(img, s, x0 - m, y0 - m, color)
    else:
        _blend(img, s[:k], x0 - m, y0 - m, color)
        _blend(img, s[-k:], x0 - m, y0 - m + s.shape[0] - k, color)
        _blend(img, s[k:-k, :k], x0 - m, y0 - m + k, color)
        _blend(img, s[k:-k, -k:], x0 - m + s.shape[1] - k, y0 - m + k, color)
    if label:
        tw, th = text_size(label)
        _blend(img, _stretch(t["filled"], tw, th + 3), x0 - m, y0 - th - 3 - m, color)
        _put_text(img, label, (x0, y0 - 2))


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted`` on uint8 images: the float32 sum rounded half to
    even, then saturated (the app's 0.4 / 0.6 overlay,
    multiyolov5_tpu/cli/detect.py:120), read from a table of every pair of
    levels."""
    f32 = np.float32
    lv = np.arange(256, dtype=f32)
    lut = np.clip(np.rint(lv[:, None] * f32(alpha) + lv[None, :] * f32(beta) + f32(gamma)),
                  0, 255).astype(np.uint8)
    return lut.ravel()[(src1.astype(np.uint16) << 8) | src2]
