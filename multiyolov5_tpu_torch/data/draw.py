"""Pillow's filled shapes in numpy (``PIL.ImageDraw``'s ``polygon``,
``rectangle`` and ``ellipse`` with ``fill``, as the JAX package's
``tools/labelme_convert.py:51-65`` draws labelme shapes into masks).

Each function returns the (H, W) bool mask of the pixels Pillow (12.1)
sets, with Pillow's arithmetic:

* coordinates are truncated to int (C's cast, toward zero);
* :func:`polygon`: the scanline fill of Pillow's ``polygon_generic``.  Its
  edges run from vertex to vertex and back to the first, leaving out those
  of no length (a vertex repeated at once); a horizontal edge is drawn as
  its run; every other edge active on row ``y`` gives the float32 crossing
  ``(y - y0) * dx + x0`` (``dx`` the float32 slope), an edge ending on
  ``y`` (not the last row) gives it twice, and the sorted crossings pair
  into runs from ``ROUND_UP`` of the first to ``ROUND_DOWN`` of the second
  (half away from zero / half towards zero).  Where a slanted edge meets
  an earlier slanted edge on a row that ends both, at crossings that round
  alike, Pillow moves the later crossing to connect the corner to the next
  row (the previous one on the edge's last row): one past the rounded
  larger next crossing where it lies right of both, one before the
  rounded smaller where it lies left of both (``roundf``, half away from
  zero).  The first such earlier edge that the neighbouring row crosses
  ends the search, whichever way it slopes.  The outline pass that
  ``polygon(xy, outline=1, fill=1)`` would draw is skipped by Pillow when
  the outline and the fill are one ink;
* :func:`rectangle`: rows ``y0..y1`` and columns ``x0..x1``, inclusive;
* :func:`ellipse`: Pillow's quarter walk on the doubled grid, from
  ``(a, b % 2)`` to ``(a % 2, b)`` for the box's sides ``a`` and ``b``,
  each step the one of up, up-left and left (left and up-left only while
  x > 1) that least changes ``|a^2 y^2 + b^2 x^2 - a^2 b^2|``, ties to the
  earlier; each of its rows is filled to its largest x, mirrored.  A box
  of one point draws nothing.

Pixels outside the image are clipped.  tests/test_torch_host_tools.py holds
each against Pillow over seeded shapes, polygons that pass through a vertex
twice among them.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

F32 = np.float32


def _roundf(x) -> F32:
    """C's ``roundf``: half away from zero."""
    return F32(math.copysign(math.floor(abs(float(x)) + 0.5), float(x)))


def _round_up(x) -> int:
    """Pillow's ``ROUND_UP``: floor(x + 0.5) for x >= 0, mirrored below."""
    x = F32(x)
    return (math.floor(x + F32(0.5)) if x >= 0 else -math.floor(abs(x) + F32(0.5)))


def _round_down(x) -> int:
    """Pillow's ``ROUND_DOWN``: ceil(x - 0.5) for x >= 0, mirrored below."""
    x = F32(x)
    return (math.ceil(x - F32(0.5)) if x >= 0 else -math.ceil(abs(x) - F32(0.5)))


def _hline(m: np.ndarray, x0: int, y: int, x1: int) -> None:
    h, w = m.shape
    if 0 <= y < h and x0 < w and x1 >= 0:
        x0, x1 = max(x0, 0), min(x1, w - 1)
        if x0 <= x1:
            m[y, x0:x1 + 1] = True


class _Edge:
    __slots__ = ("x0", "y0", "xmin", "xmax", "ymin", "ymax", "dx")

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.x0, self.y0 = x0, y0
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = F32(0) if y0 == y1 else F32(F32(x1 - x0) / F32(y1 - y0))

    def x(self, y: int) -> F32:
        return F32(F32(F32(y - self.y0) * self.dx) + F32(self.x0))


def polygon(hw: Tuple[int, int], points: Sequence[Sequence[float]]) -> np.ndarray:
    """``ImageDraw.polygon(points, fill=1)`` on an (H, W) "L" image of 0."""
    if len(points) < 2:
        raise TypeError("coordinate list must contain at least 2 coordinates")
    m = np.zeros(hw, bool)
    xy = [(int(x), int(y)) for x, y in points]
    pairs = [(a, b) for a, b in zip(xy[:-1], xy[1:]) if a != b]
    if xy[-1] != xy[0]:
        pairs.append((xy[-1], xy[0]))
    edges = [_Edge(*a, *b) for a, b in pairs]
    ymin = min([hw[0] - 1] + [e.ymin for e in edges])
    ymax = max([0] + [e.ymax for e in edges])
    table = []
    for e in edges:
        if e.ymin == e.ymax:
            _hline(m, e.xmin, e.ymin, e.xmax)
        else:
            table.append(e)
    ymax = min(ymax, hw[0])
    for y in range(max(ymin, 0), ymax + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            xx.append(cur.x(y))
            if y == cur.ymax and y < ymax:
                xx.append(xx[-1])
            elif cur.dx != 0 and y in (cur.ymin, cur.ymax):
                for other in table[:i]:      # a corner of two slanted edges
                    if other.dx == 0:
                        continue
                    if y not in (other.ymin, other.ymax) or _roundf(xx[-1]) != _roundf(other.x(y)):
                        continue
                    nxt = y - 1 if y == cur.ymax else y + 1
                    if other.ymin <= nxt <= other.ymax:
                        a, b = cur.x(nxt), other.x(nxt)
                        if xx[-1] > a + 1 and xx[-1] > b + 1:
                            xx[-1] = F32(_roundf(max(a, b)) + 1)
                        elif xx[-1] < a - 1 and xx[-1] < b - 1:
                            xx[-1] = F32(_roundf(min(a, b)) - 1)
                        break
        xx.sort()
        for a, b in zip(xx[0::2], xx[1::2]):
            lo, hi = _round_up(a), _round_down(b)
            if hi >= lo:
                _hline(m, lo, y, hi)
    return m


def rectangle(hw: Tuple[int, int], box: Sequence[float]) -> np.ndarray:
    """``ImageDraw.rectangle([x0, y0, x1, y1], fill=1)`` (x0 <= x1, y0 <= y1)."""
    m = np.zeros(hw, bool)
    x0, y0, x1, y1 = (int(v) for v in box)
    ya, yb, xa, xb = max(y0, 0), min(y1, hw[0] - 1), max(x0, 0), min(x1, hw[1] - 1)
    if ya <= yb and xa <= xb:
        m[ya:yb + 1, xa:xb + 1] = True
    return m


def _quarter(a: int, b: int):
    """The points of the ellipse's quarter on the doubled grid."""
    a2, b2 = a * a, b * b

    def dev(x, y):
        return abs(a2 * y * y + b2 * x * x - a2 * b2)

    cx, cy = a, b % 2
    while True:
        yield cx, cy
        if (cx, cy) == (a % 2, b):
            return
        nx, ny = cx, cy + 2
        nd = dev(nx, ny)
        if nx > 1:
            for px, py in ((cx - 2, cy + 2), (cx - 2, cy)):
                d = dev(px, py)
                if nd > d:
                    nx, ny, nd = px, py, d
        cx, cy = nx, ny


def ellipse(hw: Tuple[int, int], box: Sequence[float]) -> np.ndarray:
    """``ImageDraw.ellipse([x0, y0, x1, y1], fill=1)`` (x0 <= x1, y0 <= y1)."""
    m = np.zeros(hw, bool)
    x0, y0, x1, y1 = (int(v) for v in box)
    a, b = x1 - x0, y1 - y0
    if a < 0 or b < 0 or (a == 0 and b == 0):
        return m
    reach = {}
    for x, y in _quarter(a, b):
        reach[y] = max(reach.get(y, x), x)
    for y, x in reach.items():
        for row in {y0 + (b - y) // 2, y0 + (b + y) // 2}:
            _hline(m, x0 + (a - x) // 2, row, x0 + (a + x) // 2)
    return m
