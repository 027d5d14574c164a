"""Writes ``multiyolov5_tpu_torch/utils/glyphs.npz``: what cv2 draws for the
detect app's boxes and labels, as coverage stamps, so the port draws them
without cv2.

    python tools/make_glyphs.py

Needs cv2 (the port does not).  ``plot_one_box``
(multiyolov5_tpu/utils/plots.py:24-36) is drawn at two settings: the
detect app's and hub's ``line_thickness`` 3 (multiyolov5_tpu/cli/detect.py:113)
and ``plot_images``' 1 (the training-batch mosaics, utils/plots.py:71).  At
thickness ``tl`` it draws a box outline of thickness ``tl`` and a filled
label rectangle, both ``LINE_AA``, and the label in Hershey font 0 at
``fontScale`` tl / 3, thickness max(tl - 1, 1), ``LINE_AA``.  At integer
coordinates cv2 draws the same pixels at any position at both settings
(``translation_invariant`` checks it on random strings and boxes before
anything is written), so each shape is rendered once in white on black,
per setting (keys suffixed ``_t3`` and ``_t1``):

* ``outline`` / ``filled``: the box outline of every width and height w, h
  in 0..BASE, and the label rectangle (drawn from its bottom-left corner
  to its top-right one, as the app does) likewise, each with MARGIN pixels
  around.  From w or h = BASE on, the columns (rows) between a corner's
  neighbourhood and the next are all the same, so a larger shape is the
  BASE one with its middle column (row) repeated; this script checks that
  against cv2 at random sizes and positions before it writes the file.
* ``glyphs``: each printable ASCII character drawn alone at the origin
  (``GLYPH_ORIGIN`` within a ``GLYPH_HW`` window); ``advance``: how far
  each moves the pen; ``cv2.getTextSize`` of a string is the sum of its
  advances plus ``text_pad`` wide and ``text_height`` high (checked on
  random strings).
"""

from __future__ import annotations

import os
import sys

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "multiyolov5_tpu_torch", "utils", "glyphs.npz")
SETTINGS = {3: (1.0, 2), 1: (1 / 3, 1)}       # line thickness: (fontScale, text thickness)
BASE, MARGIN = 13, 4
GLYPH_HW, GLYPH_ORIGIN = (48, 40), (36, 6)        # window; origin (row, column) in it
CHARS = "".join(chr(c) for c in range(32, 127))


def outliner(thickness: int):
    def outline(w: int, h: int, at=(MARGIN, MARGIN), hw=None) -> np.ndarray:
        x0, y0 = at
        img = np.zeros(hw or (h + 2 * MARGIN + 1, w + 2 * MARGIN + 1), np.uint8)
        cv2.rectangle(img, (x0, y0), (x0 + w, y0 + h), 255, thickness=thickness,
                      lineType=cv2.LINE_AA)
        return img
    return outline


def filled(w: int, h: int, at=(MARGIN, MARGIN), hw=None) -> np.ndarray:
    x0, y0 = at
    img = np.zeros(hw or (h + 2 * MARGIN + 1, w + 2 * MARGIN + 1), np.uint8)
    cv2.rectangle(img, (x0, y0 + h), (x0 + w, y0), 255, -1, cv2.LINE_AA)
    return img


def stretch(stamps: np.ndarray, w: int, h: int) -> np.ndarray:
    """The (h + 2 MARGIN + 1, w + 2 MARGIN + 1) stamp of a w x h shape
    (the port's ``utils/plots.py`` builds it the same way)."""
    s = stamps[min(w, BASE), min(h, BASE)]
    s = s[:min(h, BASE) + 2 * MARGIN + 1, :min(w, BASE) + 2 * MARGIN + 1]
    mid = MARGIN + BASE // 2 + 1
    if w > BASE:
        s = np.concatenate([s[:, :mid], np.repeat(s[:, mid:mid + 1], w - BASE + 1, 1),
                            s[:, mid + 1:]], 1)
    if h > BASE:
        s = np.concatenate([s[:mid], np.repeat(s[mid:mid + 1], h - BASE + 1, 0),
                            s[mid + 1:]], 0)
    return s


def table(draw) -> np.ndarray:
    size = BASE + 2 * MARGIN + 1
    out = np.zeros((BASE + 1, BASE + 1, size, size), np.uint8)
    for w in range(BASE + 1):
        for h in range(BASE + 1):
            s = draw(w, h)
            out[w, h, :s.shape[0], :s.shape[1]] = s
    return out


def check(draw, stamps, rng, outline: bool) -> None:
    sizes = [(w, h) for w in range(40) for h in (0, 5, 13, 14, 15, 40)]
    sizes += [tuple(rng.randint(0, 300, 2)) for _ in range(40)]
    for w, h in sizes:
        x0, y0 = rng.randint(MARGIN, 30, 2)
        hw = (h + y0 + MARGIN + 1 + rng.randint(0, 9), w + x0 + MARGIN + 1 + rng.randint(0, 9))
        want = draw(w, h, (x0, y0), hw)[y0 - MARGIN:, x0 - MARGIN:]
        got = np.zeros_like(want)
        s = stretch(stamps, w, h)
        got[:s.shape[0], :s.shape[1]] = s
        k = 2 * MARGIN + 1        # utils/plots.py blends only the outline's band
        if outline and s[k:-k, k:-k].any():
            raise AssertionError(f"outline {w}x{h} draws inside its band")
        if not np.array_equal(got, want):
            raise AssertionError(f"{draw.__name__} {w}x{h}: the stretched stamp is not cv2's")


def glyph(ch: str, scale: float, thickness: int) -> np.ndarray:
    img = np.zeros(GLYPH_HW, np.uint8)
    cv2.putText(img, ch, GLYPH_ORIGIN[::-1], 0, scale, 255, thickness=thickness,
                lineType=cv2.LINE_AA)
    if img[0].any() or img[-1].any() or img[:, 0].any() or img[:, -1].any():
        raise AssertionError(f"glyph {ch!r} touches its window's edge")
    return img


def translation_invariant(tl: int, rng) -> None:
    """cv2 draws a string, and a box, the same at any integer position."""
    scale, tf = SETTINGS[tl]
    for _ in range(300):
        text = "".join(rng.choice(list(CHARS), rng.randint(1, 12)))
        dx, dy = rng.randint(0, 30, 2)
        a, b = np.zeros((60, 400), np.uint8), np.zeros((60 + dy, 400 + dx), np.uint8)
        cv2.putText(a, text, (5, 40), 0, scale, 255, thickness=tf, lineType=cv2.LINE_AA)
        cv2.putText(b, text, (5 + dx, 40 + dy), 0, scale, 255, thickness=tf,
                    lineType=cv2.LINE_AA)
        if not np.array_equal(b[dy:, dx:], a):
            raise AssertionError(f"cv2 draws {text!r} at fontScale {scale:.3g} otherwise "
                                 f"when moved by ({dx}, {dy})")
        w, h = rng.randint(0, 60, 2)
        a, b = outliner(tl)(w, h, hw=(80, 80)), outliner(tl)(w, h, (MARGIN + dx, MARGIN + dy),
                                                             (80 + dy, 80 + dx))
        if not np.array_equal(b[dy:, dx:], a):
            raise AssertionError(f"cv2 draws a {w}x{h} box of thickness {tl} otherwise when "
                                 f"moved by ({dx}, {dy})")


def setting(tl: int, rng) -> dict:
    """The stamps, glyphs and text metrics of line thickness ``tl``."""
    scale, tf = SETTINGS[tl]
    translation_invariant(tl, rng)
    outline = outliner(tl)
    stamps = {"outline": table(outline), "filled": table(filled)}
    check(outline, stamps["outline"], rng, True)
    check(filled, stamps["filled"], rng, False)
    glyphs = np.stack([glyph(c, scale, tf) for c in CHARS])

    def size(text):
        return cv2.getTextSize(text, 0, scale, tf)[0]

    # a string's width is its characters' advances plus a constant
    advance = np.array([size(c * 2)[0] - size(c)[0] for c in CHARS], np.int32)
    pad = {size(c)[0] - a for c, a in zip(CHARS, advance)}
    if len(pad) != 1:
        raise AssertionError(f"text width is not the advances plus a constant: {pad}")
    pad, height = pad.pop(), size(CHARS)[1]
    for text in ["0 0.53", "person 0.91"] + ["".join(rng.choice(list(CHARS), rng.randint(1, 20)))
                                             for _ in range(200)]:
        if size(text) != (advance[[CHARS.index(c) for c in text]].sum() + pad, height):
            raise AssertionError(f"text size of {text!r}")
    return {f"{k}_t{tl}": v for k, v in (
        ("outline", stamps["outline"]), ("filled", stamps["filled"]), ("glyphs", glyphs),
        ("advance", advance), ("text_height", np.int32(height)), ("text_pad", np.int32(pad)))}


def main() -> int:
    rng = np.random.RandomState(0)
    out = {}
    for tl in SETTINGS:
        out.update(setting(tl, rng))
    np.savez_compressed(OUT, chars=np.frombuffer(CHARS.encode(), np.uint8),
                        glyph_origin=np.array(GLYPH_ORIGIN, np.int32),
                        base=np.int32(BASE), margin=np.int32(MARGIN),
                        thicknesses=np.array(sorted(SETTINGS), np.int32), **out)
    print(f"wrote {os.path.relpath(OUT, ROOT)} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
