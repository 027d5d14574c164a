"""Charts without matplotlib: what a chart plots, and a raster that draws it.

``Figure`` and ``Axes`` take the calls that the JAX package's plotting
functions (multiyolov5_tpu/utils/plots.py:76-227) make of matplotlib:
``plot`` with or without a format string (one line a column of a 2-D
``y``; colours from the tab10 cycle where none is given), ``scatter``,
``hist``, ``hist2d``, titles, axis labels, limits, ``grid``,
``tick_params`` and ``legend``; and of seaborn, ``Figure.heatmap``.  Each
records what it plots as plain data (``Figure.record``): the figure size,
tight layout or not, the dpi and the path it is saved at; each axes' place
in its grid (``place``: rows, columns, 1-based index), title, labels, limits and
legend; each series' kind, data (x, y, values, bins, a heatmap's array),
colour, width, marker and label.

``Figure.savefig`` draws that record into a white uint8 RGB image of
matplotlib's pixel size, ``int(figsize * dpi)``, and writes it by suffix
(``data/images.imwrite``: PNG, or JPEG at cv2's defaults).  The raster
lays the axes out as matplotlib's default subplot parameters or, under
tight layout, around their tick labels, axis labels, titles, legends and
colorbars; draws frames, outward ticks with numeric labels (nice steps of
1, 2, 2.5 or 5), grids, polylines of the line width, '.' and '+'
markers, scatters (colours through the colormap, alpha), histogram bars,
2-D histogram and heatmap cells through the 256-entry ``viridis`` and
``Blues`` tables of ``colormaps.npz`` (read from matplotlib by
``tools/make_colormaps.py``), heatmap annotations and legends.  Text is
the Hershey stamps of ``glyphs.npz`` scaled to the font's size.  Pixels
are not Agg's: each series lies where the axes' data-to-pixel transform
(``Axes.to_pixels``, set by the last draw) puts it, in its colour.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, List, Optional

import numpy as np

from .plots import blend, glyph_index, glyph_table

TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b",
         "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")
NAMED = {"k": "#000000", "blue": "#0000ff", "grey": "#808080"}     # the names the charts use
MARKERS = ".+"
BLACK, GRID, LEGEND_EDGE = (0, 0, 0), (176, 176, 176), (204, 204, 204)
FONT_PT, TITLE_PT = 10.0, 12.0
# matplotlib's defaults: subplot parameters, tick length and pads, line
# width, marker size, axes margins, legend geometry (in font sizes)
SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2, hspace=0.2)
TICK_PT, TICK_PAD_PT, LABEL_PAD_PT, TITLE_PAD_PT, SPINE_PT = 3.5, 3.5, 4.0, 6.0, 0.8
LINE_PT, MARKER_PT, MARGIN = 1.5, 6.0, 0.05
HANDLE_EM, HANDLE_PAD_EM, BORDER_EM, SPACING_EM = 2.0, 0.8, 0.4, 0.5
# a Hershey stamp at fontScale 1 spans about REF_EM pixels of em; its rows
# from REF_ASCENT above the baseline to REF_DESCENT below it
REF_EM, REF_ASCENT, REF_DESCENT = 30.0, 26, 10


def to_rgb(c) -> tuple:
    """A matplotlib colour (name, 'C0'-'C9', '#rrggbb', float RGB) as uint8 RGB."""
    if isinstance(c, str):
        if len(c) == 2 and c[0] == "C" and c[1].isdigit():
            c = TAB10[int(c[1])]
        c = NAMED.get(c, c)
        return tuple(int(c[i:i + 2], 16) for i in (1, 3, 5))
    return tuple(int(round(float(v) * 255)) for v in c[:3])


@functools.lru_cache(maxsize=1)
def colormaps() -> Dict[str, np.ndarray]:
    with np.load(os.path.join(os.path.dirname(__file__), "colormaps.npz")) as z:
        return {k: z[k] for k in z.files}


def cmap(name: str, values, lo=None, hi=None) -> np.ndarray:
    """(N, 3) uint8 colours of ``values`` normalised over [lo, hi] (their
    min and max by default), as matplotlib's ``Normalize`` and colormap
    lookup: index ``int(x * N)``, clipped to the table."""
    table = colormaps()[name]
    v = np.asarray(values, np.float64)
    if not v.size:
        return table[:0]
    lo = np.nanmin(v) if lo is None else lo
    hi = np.nanmax(v) if hi is None else hi
    x = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    idx = np.clip(np.nan_to_num(x * len(table)).astype(np.int64), 0, len(table) - 1)
    return table[idx]


def parse_fmt(fmt: str) -> dict:
    """A format string's colour, marker and line style ('.-', 'k+': a
    solid line, or none where a marker comes without it)."""
    out, rest = {}, fmt
    if "-" in rest:
        out["linestyle"] = "-"
        rest = rest.replace("-", "", 1)
    for ch in rest:
        if ch in MARKERS:
            out["marker"] = ch
        elif ch in NAMED:
            out["color"] = ch
        else:
            raise ValueError(f"format string {fmt!r}: {ch!r} is not a colour or marker")
    if "marker" in out and "linestyle" not in out:
        out["linestyle"] = ""
    return out


class Axes:
    """One subplot: its place ``(rows, cols, index)``, its series and its
    decorations, as recorded from matplotlib-style calls."""

    def __init__(self, place):
        self.place = tuple(int(v) for v in place)
        self.series: List[dict] = []
        self.title, self.title_size = "", TITLE_PT
        self.xlabel = self.ylabel = ""
        self.xlim = self.ylim = None
        self.grid_lines = False
        self.labelsize = FONT_PT
        self.legend_kw: Optional[dict] = None
        self.facecolor = (1.0, 1.0, 1.0)
        self._cycle = 0
        self.box = self.view = None       # set by the last draw

    # --- what is plotted ---

    def plot(self, *args, color=None, linewidth=LINE_PT, marker="", markersize=MARKER_PT,
             label=None):
        """``Axes.plot(y)``, ``(y, fmt)``, ``(x, y)`` or ``(x, y, fmt)``: one
        line a column of ``y``."""
        args = list(args)
        fmt = parse_fmt(args.pop()) if args and isinstance(args[-1], str) else {}
        y = np.asarray(args[-1], np.float64)
        x = (np.asarray(args[0], np.float64) if len(args) == 2
             else np.arange(len(np.atleast_1d(y)), dtype=np.float64))
        x, y = np.atleast_1d(x), np.atleast_1d(y)
        ys = y.T if y.ndim == 2 else y[None]
        color = fmt.get("color", color)
        style = dict(linewidth=float(linewidth), marker=fmt.get("marker", marker),
                     markersize=float(markersize),
                     linestyle=fmt.get("linestyle", "-"),
                     label=label)
        for yi in ys:
            if color is None:
                c = TAB10[self._cycle % len(TAB10)]
                self._cycle += 1
            else:
                c = color
            self.series.append(dict(kind="line", x=x.copy(), y=yi.copy(), color=to_rgb(c),
                                    **style))
        return self

    def scatter(self, x, y, s=None, c=None, cmap="viridis", alpha=None, edgecolors="face"):
        self.series.append(dict(kind="scatter", x=np.asarray(x, np.float64).ravel(),
                                y=np.asarray(y, np.float64).ravel(),
                                c=np.asarray(c, np.float64).ravel(), cmap=cmap,
                                s=float(MARKER_PT ** 2 if s is None else s),
                                alpha=None if alpha is None else float(alpha),
                                edgecolors=edgecolors))
        return self

    def hist(self, x, bins=10, rwidth=None):
        self.series.append(dict(kind="hist", values=np.asarray(x, np.float64).ravel(),
                                bins=np.asarray(bins, np.float64),
                                rwidth=1.0 if rwidth is None else float(rwidth),
                                color=to_rgb(TAB10[0])))
        return self

    def hist2d(self, x, y, bins=10):
        self.series.append(dict(kind="hist2d", x=np.asarray(x, np.float64).ravel(),
                                y=np.asarray(y, np.float64).ravel(), bins=int(bins),
                                cmap="viridis"))
        return self

    def set_title(self, s: str, size=None):
        self.title = str(s)
        if size is not None:
            self.title_size = float(size)

    def set_xlabel(self, s: str):
        self.xlabel = str(s)

    def set_ylabel(self, s: str):
        self.ylabel = str(s)

    def set_xlim(self, lo, hi):
        self.xlim = (float(lo), float(hi))

    def set_ylim(self, lo, hi):
        self.ylim = (float(lo), float(hi))

    def grid(self):
        self.grid_lines = True

    def tick_params(self, labelsize=None):
        if labelsize is not None:
            self.labelsize = float(labelsize)

    def legend(self, bbox_to_anchor, loc="upper left"):
        """A legend whose ``loc`` corner sits at ``bbox_to_anchor`` (axes
        fractions); the charts place it by its upper left corner."""
        if loc != "upper left":
            raise ValueError(f"legends are placed by their upper left corner, not {loc!r}")
        self.legend_kw = {"bbox_to_anchor": tuple(float(v) for v in bbox_to_anchor), "loc": loc}

    def set_facecolor(self, c):
        self.facecolor = tuple(float(v) for v in c)

    def record(self) -> dict:
        return {"place": self.place, "title": self.title, "title_size": self.title_size,
                "xlabel": self.xlabel, "ylabel": self.ylabel, "xlim": self.xlim,
                "ylim": self.ylim, "grid_lines": self.grid_lines, "labelsize": self.labelsize,
                "legend": self.legend_kw, "facecolor": self.facecolor,
                "series": [dict(s) for s in self.series]}

    # --- how it is drawn ---

    def to_pixels(self, x, y):
        """Data coordinates -> (column, row) pixel coordinates of the last draw."""
        x0, y0, x1, y1 = self.box
        vx0, vx1, vy0, vy1 = self.view
        px = x0 + (np.asarray(x, np.float64) - vx0) / (vx1 - vx0) * (x1 - x0)
        py = y1 - (np.asarray(y, np.float64) - vy0) / (vy1 - vy0) * (y1 - y0)
        return px, py


class Figure:
    """A figure of ``figsize`` inches; ``savefig`` sets the dpi and draws."""

    def __init__(self, figsize=(6.4, 4.8), tight_layout: bool = False):
        self.figsize = tuple(float(v) for v in figsize)
        self.tight_layout = bool(tight_layout)
        self.axes: List[Axes] = []
        self.dpi = None
        self.path = None

    def add_subplot(self, rows: int, cols: int, index: int) -> Axes:
        ax = Axes((rows, cols, index))
        self.axes.append(ax)
        return ax

    def subplots(self, rows: int, cols: int) -> List[Axes]:
        """Every axes of a rows x cols grid, in row-major order."""
        return [self.add_subplot(rows, cols, i + 1) for i in range(rows * cols)]

    def gca(self) -> Axes:
        return self.axes[-1] if self.axes else self.add_subplot(1, 1, 1)

    def heatmap(self, data, annot=False, annot_kws=None, cmap="Blues", fmt=".2g",
                square=False, xticklabels="auto", yticklabels="auto") -> Axes:
        """seaborn's ``heatmap`` on this figure's current axes (with its colorbar)."""
        ax = self.gca()
        ax.series.append(dict(kind="heatmap", data=np.array(data, np.float64),
                              annot=bool(annot), fmt=fmt,
                              annot_size=float((annot_kws or {}).get("size", FONT_PT)),
                              cmap=cmap, square=bool(square),
                              xticklabels=list(xticklabels) if not isinstance(
                                  xticklabels, str) else xticklabels,
                              yticklabels=list(yticklabels) if not isinstance(
                                  yticklabels, str) else yticklabels))
        return ax

    def record(self) -> dict:
        return {"figsize": self.figsize, "tight_layout": self.tight_layout, "dpi": self.dpi,
                "path": None if self.path is None else str(self.path),
                "axes": [ax.record() for ax in self.axes]}

    def size(self, dpi: float):
        """matplotlib's pixel size of this figure at ``dpi``: (width, height)."""
        return int(self.figsize[0] * dpi), int(self.figsize[1] * dpi)

    def render(self, dpi: float) -> np.ndarray:
        """The figure as an (H, W, 3) uint8 RGB image at ``dpi``."""
        w, h = self.size(dpi)
        img = np.full((h, w, 3), 255, np.uint8)
        Raster(img, dpi).draw(self)
        return img

    def savefig(self, path, dpi: float = 100.0) -> np.ndarray:
        """Draw at ``dpi`` and write ``path`` (PNG or JPEG by suffix); returns the image."""
        from ..data.images import imwrite
        self.dpi, self.path = dpi, path
        img = self.render(dpi)
        imwrite(str(path), img[:, :, ::-1])
        return img


# --------------------------------------------------------------------- text

def _resample(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights: box filter when shrinking, linear when growing."""
    s = n_in / n_out
    if s > 1:
        lo = np.arange(n_out)[:, None] * s
        j = np.arange(n_in)[None]
        return np.clip(np.minimum(lo + s, j + 1) - np.maximum(lo, j), 0, None) / s
    c = np.clip((np.arange(n_out) + 0.5) * s - 0.5, 0, n_in - 1)
    j0 = np.floor(c).astype(int)
    j1 = np.minimum(j0 + 1, n_in - 1)
    w = np.zeros((n_out, n_in))
    np.add.at(w, (np.arange(n_out), j0), 1 - (c - j0))
    np.add.at(w, (np.arange(n_out), j1), c - j0)
    return w


@functools.lru_cache(maxsize=512)
def text_stamp(s: str, size_px: float) -> np.ndarray:
    """Coverage (0-255) of ``s`` at a font of ``size_px`` pixels: rows from
    the ascent to the descent, the baseline at ``round(REF_ASCENT * k)``."""
    t = glyph_table()
    ref = t[3]
    oy, ox = (int(v) for v in t["glyph_origin"])
    idx = [glyph_index(c) for c in s]
    adv = ref["advance"][idx]
    width = int(adv.sum()) + ref["glyphs"].shape[2]
    canvas = np.zeros((ref["glyphs"].shape[1], width), np.uint8)
    x = 0
    for i, a in zip(idx, adv):
        g = ref["glyphs"][i]
        np.maximum(canvas[:, x:x + g.shape[1]], g, out=canvas[:, x:x + g.shape[1]])
        x += int(a)
    canvas = canvas[oy - REF_ASCENT:oy + REF_DESCENT, ox:ox + max(int(adv.sum()), 1)]
    k = size_px / REF_EM
    h, w = max(1, round(canvas.shape[0] * k)), max(1, round(canvas.shape[1] * k))
    out = _resample(canvas.shape[0], h) @ canvas.astype(np.float64) @ _resample(
        canvas.shape[1], w).T
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def text_extent(s: str, size_px: float, rotation: int = 0):
    """(width, height) in pixels of ``s`` drawn at ``size_px``."""
    if not s:
        return 0, 0
    h, w = text_stamp(s, size_px).shape
    return (h, w) if rotation else (w, h)


# ------------------------------------------------------------------ raster

def _nice_ticks(lo: float, hi: float, nmax: int) -> np.ndarray:
    """Ticks inside [lo, hi] at a step of 1, 2, 2.5 or 5 x 10^k, at most
    about ``nmax`` of them (matplotlib's MaxNLocator steps)."""
    span = hi - lo
    if not span > 0:
        return np.array([lo])
    raw = span / max(nmax, 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw * (1 - 1e-9))
    start = math.ceil(lo / step - 1e-9)
    stop = math.floor(hi / step + 1e-9)
    return np.arange(start, stop + 1) * step


def _tick_labels(ticks: np.ndarray) -> List[str]:
    if len(ticks) < 2:
        return [f"{v:g}" for v in ticks]
    step = float(np.min(np.diff(ticks)))
    d = max(0, -math.floor(math.log10(step) + 1e-9))
    while d < 12 and abs(round(step * 10 ** d) - step * 10 ** d) > 1e-6 * 10 ** d * step:
        d += 1
    out = [f"{v:.{d}f}" for v in ticks]
    return [v[1:] if v.startswith("-") and float(v) == 0 else v for v in out]


def _disc(r: float) -> np.ndarray:
    """(K, 2) integer (dy, dx) offsets within radius ``r`` (at least the centre)."""
    n = int(math.ceil(r))
    dy, dx = np.mgrid[-n:n + 1, -n:n + 1]
    keep = dy * dy + dx * dx <= max(r, 0.5) ** 2
    return np.stack([dy[keep], dx[keep]], 1)


class Raster:
    """Draws a ``Figure`` into ``img`` at ``dpi``."""

    def __init__(self, img: np.ndarray, dpi: float):
        self.img, self.dpi = img, float(dpi)
        self.px = self.dpi / 72.0          # pixels a point

    # --- primitives ---

    def text(self, s: str, x: float, y: float, size_pt: float, col=BLACK, ha="center",
             va="baseline", rotation: int = 0) -> None:
        """``s`` with its anchor (ha: left/center/right, va: top/center/
        baseline/bottom) at (x, y); rotated 90 degrees counter-clockwise
        when ``rotation``."""
        if not s:
            return
        size = size_pt * self.px
        cover = text_stamp(s, size)
        base = round(REF_ASCENT * size / REF_EM)
        h, w = cover.shape
        dx = {"left": 0, "center": w / 2, "right": w}[ha]
        dy = {"top": 0, "center": h / 2, "baseline": base, "bottom": h}[va]
        if rotation:
            cover = np.rot90(cover)
            x0, y0 = x - dy, y - (w - dx)
        else:
            x0, y0 = x - dx, y - dy
        blend(self.img, cover, int(round(x0)), int(round(y0)), col)

    def rect(self, x0, y0, x1, y1, col, alpha: float = 1.0) -> None:
        h, w = self.img.shape[:2]
        xa, xb = max(0, int(round(min(x0, x1)))), min(w, int(round(max(x0, x1))))
        ya, yb = max(0, int(round(min(y0, y1)))), min(h, int(round(max(y0, y1))))
        if xa >= xb or ya >= yb:
            return
        if alpha >= 1:
            self.img[ya:yb, xa:xb] = col
        else:
            p = self.img[ya:yb, xa:xb].astype(np.float32)
            self.img[ya:yb, xa:xb] = np.rint(p + (np.asarray(col, np.float32) - p) * alpha)

    def points(self, ys, xs, cols, clip, alpha: Optional[float] = None) -> None:
        """Pixels (ys, xs) (integer arrays) set to ``cols`` ((3,) or (N, 3)),
        inside ``clip`` = (x0, y0, x1, y1)."""
        x0, y0, x1, y1 = clip
        h, w = self.img.shape[:2]
        keep = ((xs >= max(0, x0)) & (xs < min(w, x1)) & (ys >= max(0, y0))
                & (ys < min(h, y1)))
        cols = np.asarray(cols, np.float32)
        if cols.ndim == 2:
            cols = cols[keep]
        ys, xs = ys[keep], xs[keep]
        if alpha is None or alpha >= 1:
            self.img[ys, xs] = np.rint(cols)
        else:
            p = self.img[ys, xs].astype(np.float32)
            self.img[ys, xs] = np.rint(p + (cols - p) * alpha)

    def stroke(self, xs, ys, width_px: float, col, clip) -> None:
        """A polyline through pixel points (xs, ys) of ``width_px``."""
        pts = np.stack([np.asarray(xs, np.float64), np.asarray(ys, np.float64)], 1)
        ok = np.isfinite(pts).all(1)
        segs = ok[:-1] & ok[1:]
        if len(pts) == 1 or not segs.any():
            samples = pts[ok]
        else:
            p0, d = pts[:-1][segs], (pts[1:] - pts[:-1])[segs]
            n = np.maximum(np.ceil(np.hypot(d[:, 0], d[:, 1]) / 0.5).astype(np.int64), 1)
            seg = np.repeat(np.arange(len(n)), n)
            t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(n, n)
            samples = np.concatenate([p0[seg] + d[seg] * t[:, None], (p0 + d)[-1:]], 0)
        self.dots(samples[:, 0], samples[:, 1], width_px / 2, col, clip)

    def dots(self, xs, ys, r: float, cols, clip, alpha=None) -> None:
        """Discs of radius ``r`` pixels at pixel points (xs, ys)."""
        if not len(xs):
            return
        off = _disc(r)
        cy = np.floor(np.asarray(ys)).astype(np.int64)
        cx = np.floor(np.asarray(xs)).astype(np.int64)
        yy = (cy[:, None] + off[None, :, 0]).ravel()
        xx = (cx[:, None] + off[None, :, 1]).ravel()
        cols = np.asarray(cols, np.float32)
        if cols.ndim == 2:
            cols = np.repeat(cols, len(off), 0)
        self.points(yy, xx, cols, clip, alpha)

    # --- layout ---

    def _limits(self, ax: Axes):
        """The view (x0, x1, y0, y1) of ``ax``: its set limits, else the
        data's with matplotlib's 5% margins (none where edges stick: the
        2-D histogram's and heatmap's cells, a histogram's zero)."""
        xs, ys, stick_y0 = [], [], False
        sticky = None
        for s in ax.series:
            k = s["kind"]
            if k in ("line", "scatter"):
                xs.append(s["x"])
                ys.append(s["y"])
            elif k == "hist":
                counts, edges = np.histogram(s["values"], s["bins"])
                xs.append(edges)
                ys.append(np.concatenate([[0.0], counts]))
                stick_y0 = True
            elif k == "hist2d":
                _, ex, ey = np.histogram2d(s["x"], s["y"], bins=s["bins"])
                sticky = (ex[0], ex[-1], ey[0], ey[-1])
            elif k == "heatmap":
                r, c = s["data"].shape
                sticky = (0.0, float(c), float(r), 0.0)
        if sticky is not None and not xs:
            view = list(sticky)
        else:
            x = np.concatenate([np.ravel(v) for v in xs]) if xs else np.array([0.0, 1.0])
            y = np.concatenate([np.ravel(v) for v in ys]) if ys else np.array([0.0, 1.0])
            x, y = x[np.isfinite(x)], y[np.isfinite(y)]
            view = []
            for v, stick in ((x, False), (y, stick_y0)):
                lo, hi = (float(v.min()), float(v.max())) if len(v) else (0.0, 1.0)
                if hi == lo:
                    lo, hi = lo - 0.05 * (abs(lo) or 1), hi + 0.05 * (abs(hi) or 1)
                m = MARGIN * (hi - lo)
                view += [lo if stick and lo == 0 else lo - m, hi + m]
        if ax.xlim is not None:
            view[0:2] = ax.xlim
        if ax.ylim is not None:
            view[2:4] = ax.ylim
        return tuple(float(v) for v in view)

    def _heat(self, ax: Axes):
        return next((s for s in ax.series if s["kind"] == "heatmap"), None)

    def _ticks(self, ax: Axes, view, box):
        """(x ticks, x labels, y ticks, y labels) in data coordinates."""
        hm = self._heat(ax)
        fs = ax.labelsize * self.px
        if hm is not None:
            r, c = hm["data"].shape
            out = []
            for n, labels, length in ((c, hm["xticklabels"], box[2] - box[0]),
                                      (r, hm["yticklabels"], box[3] - box[1])):
                if isinstance(labels, str):
                    step = max(1, int(math.ceil(n * fs * 1.2 / max(length, 1))))
                    idx = np.arange(0, n, step)
                    labels = [str(i) for i in idx]
                else:
                    idx = np.arange(len(labels))
                    labels = [str(v) for v in labels]
                out += [idx + 0.5, labels]
            return tuple(out)
        nx = int(np.clip((box[2] - box[0]) / (3 * fs), 2, 9))
        ny = int(np.clip((box[3] - box[1]) / (2 * fs), 2, 9))
        xt = _nice_ticks(min(view[0], view[1]), max(view[0], view[1]), nx)
        yt = _nice_ticks(min(view[2], view[3]), max(view[2], view[3]), ny)
        return xt, _tick_labels(xt), yt, _tick_labels(yt)

    def _legend_entries(self, ax: Axes):
        return [s for s in ax.series if s["kind"] == "line" and s.get("label")
                and not str(s["label"]).startswith("_")]

    def _legend_size(self, ax: Axes):
        entries = self._legend_entries(ax)
        if ax.legend_kw is None or not entries:
            return 0.0, 0.0
        em = FONT_PT * self.px
        tw = max(text_extent(str(s["label"]), em)[0] for s in entries)
        w = 2 * BORDER_EM * em + HANDLE_EM * em + HANDLE_PAD_EM * em + tw
        h = 2 * BORDER_EM * em + len(entries) * em + (len(entries) - 1) * SPACING_EM * em
        return w, h

    def _margins(self, ax: Axes, box):
        """Pixels that ``ax`` needs left, right, above and below its box."""
        view = self._limits(ax)
        xt, xl, yt, yl = self._ticks(ax, view, box)
        fs = ax.labelsize * self.px
        tick = (TICK_PT + TICK_PAD_PT) * self.px
        rot_x = self._rotate_x(ax, xl, box)
        xh = max((text_extent(s, fs, rot_x)[1] for s in xl), default=0)
        yw = max((text_extent(s, fs)[0] for s in yl), default=0)
        em = FONT_PT * self.px
        left = tick + yw + (em * 1.2 + LABEL_PAD_PT * self.px if ax.ylabel else 0)
        bottom = tick + xh + (em * 1.2 + LABEL_PAD_PT * self.px if ax.xlabel else 0)
        top = (ax.title_size * self.px * 1.2 + TITLE_PAD_PT * self.px if ax.title
               else fs * 0.6)
        right = max((text_extent(s, fs)[0] for s in xl[-1:]), default=0) / 2
        lw, lh = self._legend_size(ax)
        if lw:
            right += lw + (ax.legend_kw["bbox_to_anchor"][0] - 1) * (box[2] - box[0])
        if self._heat(ax) is not None:
            right += 0.2 * (box[2] - box[0]) + 4 * fs
        return left, right, top, bottom

    def _rotate_x(self, ax: Axes, labels, box) -> int:
        """seaborn turns a heatmap's x tick labels upright where they overlap."""
        if self._heat(ax) is None or not labels:
            return 0
        fs = ax.labelsize * self.px
        cell = (box[2] - box[0]) * 0.8 / max(len(labels), 1)
        return int(max(text_extent(s, fs)[0] for s in labels) > cell)

    def layout(self, fig: Figure):
        """Each axes' box (x0, y0, x1, y1) in pixels."""
        h, w = self.img.shape[:2]
        boxes = []
        for ax in fig.axes:
            rows, cols, index = ax.place
            r, c = divmod(index - 1, cols)
            sp = SUBPLOT
            cw = (sp["right"] - sp["left"]) * w / (cols + sp["wspace"] * (cols - 1))
            ch = (sp["top"] - sp["bottom"]) * h / (rows + sp["hspace"] * (rows - 1))
            x0 = sp["left"] * w + c * cw * (1 + sp["wspace"])
            y0 = (1 - sp["top"]) * h + r * ch * (1 + sp["hspace"])
            boxes.append((x0, y0, x0 + cw, y0 + ch))
        if fig.tight_layout and fig.axes:
            pad = 1.08 * FONT_PT * self.px
            need = [self._margins(ax, b) for ax, b in zip(fig.axes, boxes)]
            ml, mr, mt, mb = (max(n[i] for n in need) for i in range(4))
            tight = []
            for ax in fig.axes:
                rows, cols, index = ax.place
                r, c = divmod(index - 1, cols)
                cw = (w - 2 * pad - (cols - 1) * pad - cols * (ml + mr)) / cols
                ch = (h - 2 * pad - (rows - 1) * pad - rows * (mt + mb)) / rows
                x0 = pad + c * (cw + ml + mr + pad) + ml
                y0 = pad + r * (ch + mt + mb + pad) + mt
                tight.append((x0, y0, x0 + max(cw, 1), y0 + max(ch, 1)))
            boxes = tight
        out = []
        for ax, b in zip(fig.axes, boxes):
            hm = self._heat(ax)
            if hm is not None:        # the colorbar takes 20% of the width; square cells
                x0, y0, x1, y1 = b
                x1 = x0 + 0.8 * (x1 - x0)
                if hm["square"]:
                    r, c = hm["data"].shape
                    cell = min((x1 - x0) / c, (y1 - y0) / r)
                    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
                    x0, x1 = cx - cell * c / 2, cx + cell * c / 2
                    y0, y1 = cy - cell * r / 2, cy + cell * r / 2
                b = (x0, y0, x1, y1)
            out.append(tuple(float(v) for v in b))
        return out

    # --- drawing ---

    def draw(self, fig: Figure) -> None:
        for ax, box in zip(fig.axes, self.layout(fig)):
            self.draw_axes(ax, box)

    def draw_axes(self, ax: Axes, box) -> None:
        view = self._limits(ax)
        ax.box, ax.view = box, view
        x0, y0, x1, y1 = box
        ix0, iy0, ix1, iy1 = (int(round(v)) for v in box)
        clip = (ix0, iy0, ix1 + 1, iy1 + 1)
        self.rect(x0, y0, x1, y1, to_rgb(ax.facecolor))
        xt, xl, yt, yl = self._ticks(ax, view, box)
        hm = self._heat(ax)
        if ax.grid_lines:
            g = max(0.8 * self.px, 1.0)
            for t in xt:
                px, _ = ax.to_pixels(t, view[2])
                self.rect(px - g / 2, y0, px + g / 2, y1, GRID)
            for t in yt:
                _, py = ax.to_pixels(view[0], t)
                self.rect(x0, py - g / 2, x1, py + g / 2, GRID)
        for s in ax.series:
            getattr(self, "draw_" + s["kind"])(ax, s, clip)
        # frame, ticks, tick labels
        sw = max(SPINE_PT * self.px, 1.0)
        for a, b, c, d in ((x0, y0, x1, y0), (x0, y1, x1, y1), (x0, y0, x0, y1),
                           (x1, y0, x1, y1)):
            self.rect(a - sw / 2, b - sw / 2, c + sw / 2, d + sw / 2, BLACK)
        fs_pt = ax.labelsize
        tick, pad = TICK_PT * self.px, TICK_PAD_PT * self.px
        rot_x = self._rotate_x(ax, xl, box)
        xh = 0
        for t, s in zip(xt, xl):
            px, _ = ax.to_pixels(t, view[2])
            if not x0 - 1 <= px <= x1 + 1:
                continue
            if hm is None:
                self.rect(px - sw / 2, y1, px + sw / 2, y1 + tick, BLACK)
            self.text(s, px, y1 + tick + pad, fs_pt, ha="center" if not rot_x else "right",
                      va="top" if not rot_x else "center", rotation=rot_x)
            xh = max(xh, text_extent(s, fs_pt * self.px, rot_x)[1])
        yw = 0
        for t, s in zip(yt, yl):
            _, py = ax.to_pixels(view[0], t)
            if not min(y0, y1) - 1 <= py <= max(y0, y1) + 1:
                continue
            if hm is None:
                self.rect(x0 - tick, py - sw / 2, x0, py + sw / 2, BLACK)
            self.text(s, x0 - tick - pad, py, fs_pt, ha="right", va="center")
            yw = max(yw, text_extent(s, fs_pt * self.px)[0])
        lp = LABEL_PAD_PT * self.px
        if ax.xlabel:
            self.text(ax.xlabel, (x0 + x1) / 2, y1 + tick + pad + xh + lp, FONT_PT, va="top")
        if ax.ylabel:
            self.text(ax.ylabel, x0 - tick - pad - yw - lp, (y0 + y1) / 2, FONT_PT,
                      va="bottom", rotation=1)
        if ax.title:
            self.text(ax.title, (x0 + x1) / 2, y0 - TITLE_PAD_PT * self.px, ax.title_size,
                      va="bottom")
        if hm is not None:
            self.draw_colorbar(ax, hm, box)
        if ax.legend_kw is not None:
            self.draw_legend(ax, box)

    def draw_line(self, ax: Axes, s: dict, clip) -> None:
        px, py = ax.to_pixels(s["x"], s["y"])
        col = s["color"]
        if s["linestyle"]:
            self.stroke(px, py, max(s["linewidth"] * self.px, 1.0), col, clip)
        ms = s["markersize"] * self.px
        if s["marker"] == ".":           # matplotlib's point: a disc of half the size
            self.dots(px, py, ms / 4, col, clip)
        elif s["marker"] == "+":
            h = ms / 2
            for dx, dy in (((-h, h), (0, 0)), ((0, 0), (-h, h))):
                for x, y in zip(px, py):
                    self.stroke([x + dx[0], x + dx[1]], [y + dy[0], y + dy[1]],
                                max(self.px, 1.0), col, clip)

    def draw_scatter(self, ax: Axes, s: dict, clip) -> None:
        px, py = ax.to_pixels(s["x"], s["y"])
        r = math.sqrt(s["s"]) / 2 * self.px
        if s["edgecolors"] != "none":
            r += 0.5 * self.px           # the edge (1 pt wide), in the face's colour
        self.dots(px, py, max(r, 0.5), cmap(s["cmap"], s["c"]), clip, s["alpha"])

    def draw_hist(self, ax: Axes, s: dict, clip) -> None:
        counts, edges = np.histogram(s["values"], s["bins"])
        for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
            pad = (hi - lo) * (1 - s["rwidth"]) / 2
            xa, ya = ax.to_pixels(lo + pad, 0.0)
            xb, yb = ax.to_pixels(hi - pad, float(c))
            self.rect(xa, ya, xb, yb, s["color"])

    def _cells(self, ax: Axes, xedges, yedges, rgb, keep) -> None:
        """Fill ax's box with the cells between ``xedges`` and ``yedges``
        (data coordinates): ``rgb`` (nx, ny, 3) uint8 their colours, where
        ``keep`` (nx, ny) is set; elsewhere the face shows."""
        x0, y0, x1, y1 = (int(round(v)) for v in ax.box)
        h, w = self.img.shape[:2]
        x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
        if x0 >= x1 or y0 >= y1:
            return
        vx0, vx1, vy0, vy1 = ax.view
        bx0, bx1, by0, by1 = ax.box[0], ax.box[2], ax.box[1], ax.box[3]
        dx = vx0 + (np.arange(x0, x1) + 0.5 - bx0) / (bx1 - bx0) * (vx1 - vx0)
        dy = vy0 + (by1 - (np.arange(y0, y1) + 0.5)) / (by1 - by0) * (vy1 - vy0)
        ix = np.searchsorted(xedges, dx, side="right") - 1
        iy = np.searchsorted(yedges, dy, side="right") - 1
        okx = (ix >= 0) & (ix < len(xedges) - 1)
        oky = (iy >= 0) & (iy < len(yedges) - 1)
        ix, iy = np.clip(ix, 0, len(xedges) - 2), np.clip(iy, 0, len(yedges) - 2)
        cell_rgb = rgb[ix[None, :], iy[:, None]]
        inside = okx[None, :] & oky[:, None] & keep[ix[None, :], iy[:, None]]
        region = self.img[y0:y1, x0:x1]
        region[inside] = cell_rgb[inside]

    def draw_hist2d(self, ax: Axes, s: dict, clip) -> None:
        counts, ex, ey = np.histogram2d(s["x"], s["y"], bins=s["bins"])
        rgb = cmap(s["cmap"], counts.ravel()).reshape(*counts.shape, 3)
        self._cells(ax, ex, ey, rgb, np.ones(counts.shape, bool))

    def draw_heatmap(self, ax: Axes, s: dict, clip) -> None:
        data = s["data"]
        r, c = data.shape
        ok = np.isfinite(data)
        lo, hi = (np.nanmin(data), np.nanmax(data)) if ok.any() else (0.0, 1.0)
        rgb = cmap(s["cmap"], np.where(ok, data, lo).ravel(), lo, hi).reshape(r, c, 3)
        # cells (column, row) in data coordinates: x = column, y = row (top down)
        self._cells(ax, np.arange(c + 1.0), np.arange(r + 1.0), rgb.transpose(1, 0, 2), ok.T)
        if s["annot"]:
            lum = (rgb / 255.0) @ np.array([0.2126, 0.7152, 0.0722])
            for i, j in zip(*np.nonzero(ok)):
                px, py = ax.to_pixels(j + 0.5, i + 0.5)
                col = (38, 38, 38) if lum[i, j] > 0.408 else (255, 255, 255)
                self.text(format(data[i, j], s["fmt"]), px, py, s["annot_size"], col,
                          va="center")

    def draw_colorbar(self, ax: Axes, hm: dict, box) -> None:
        """seaborn's colorbar: a vertical ramp of the colormap right of the
        heatmap, with ticks over the data's range."""
        data = hm["data"]
        ok = np.isfinite(data)
        lo, hi = (float(np.nanmin(data)), float(np.nanmax(data))) if ok.any() else (0.0, 1.0)
        x0, y0, x1, y1 = box
        w = 0.05 * (x1 - x0)
        cx0 = x1 + 0.06 * (x1 - x0)
        iy0, iy1 = int(round(y0)), int(round(y1))
        ramp = np.linspace(hi, lo, max(iy1 - iy0, 1))
        cols = cmap(hm["cmap"], ramp, lo, hi)
        ix0, ix1 = int(round(cx0)), int(round(cx0 + w))
        hh, ww = self.img.shape[:2]
        if 0 <= iy0 < iy1 <= hh and 0 <= ix0 < ix1 <= ww:
            self.img[iy0:iy1, ix0:ix1] = cols[:, None]
        fs = ax.labelsize
        for t, s in zip(*(lambda t: (t, _tick_labels(t)))(_nice_ticks(lo, hi, 6))):
            py = y1 - (t - lo) / (hi - lo) * (y1 - y0) if hi > lo else y1
            self.rect(cx0 + w, py - self.px * 0.4, cx0 + w + TICK_PT * self.px,
                      py + self.px * 0.4, BLACK)
            self.text(s, cx0 + w + (TICK_PT + TICK_PAD_PT) * self.px, py, fs, ha="left",
                      va="center")

    def draw_legend(self, ax: Axes, box) -> None:
        entries = self._legend_entries(ax)
        if not entries:
            return
        lw, lh = self._legend_size(ax)
        x0, y0, x1, y1 = box
        anchor = ax.legend_kw["bbox_to_anchor"]
        lx = x0 + anchor[0] * (x1 - x0)
        ly = y1 - anchor[1] * (y1 - y0)
        em = FONT_PT * self.px
        self.rect(lx, ly, lx + lw, ly + lh, (255, 255, 255), 0.8)
        e = max(self.px * 0.8, 1.0)
        for a, b, c, d in ((lx, ly, lx + lw, ly), (lx, ly + lh, lx + lw, ly + lh),
                           (lx, ly, lx, ly + lh), (lx + lw, ly, lx + lw, ly + lh)):
            self.rect(a - e / 2, b - e / 2, c + e / 2, d + e / 2, LEGEND_EDGE)
        whole = (0, 0, *self.img.shape[1::-1])
        y = ly + BORDER_EM * em + em / 2
        for s in entries:
            hx0 = lx + BORDER_EM * em
            self.stroke([hx0, hx0 + HANDLE_EM * em], [y, y],
                        max(s["linewidth"] * self.px, 1.0), s["color"], whole)
            self.text(str(s["label"]), hx0 + (HANDLE_EM + HANDLE_PAD_EM) * em, y, FONT_PT,
                      ha="left", va="center")
            y += em * (1 + SPACING_EM)
