"""The port's training-batch mosaics and charts (multiyolov5_tpu_torch/
utils/plots.py, utils/charts.py) against the JAX package's
(multiyolov5_tpu/utils/plots.py), which draws with cv2, matplotlib and
seaborn; the port imports none of them.

* ``plot_one_box`` at ``line_thickness`` 1 (the mosaics' setting) against
  cv2 on single labelled boxes, and ``plot_images`` against the JAX
  mosaic on a seeded batch: equal outside each box's stroke band (its
  outline grown and shrunk by tl + 1 = 2 px) and its label rectangle grown
  by 2 px, as tests/test_torch_detect_app.py holds the app's boxes at
  thickness 3; inside the bands, cv2 blends each stroke with its own
  rounding where the port blends its coverage once.  Read: single boxes
  16.8% of band pixels on average, 27.6% at most (a 1 px line's band is
  mostly anti-aliased edge), by at most 2 levels away from the image's
  edge and 61 where cv2 clips a label rectangle at it; the mosaic 22.4%,
  by at most 2 levels.  Held at 25%, 35%, 8 and 80 levels, and 30% and 8
  levels.  The mosaic's ``.jpg`` bytes equal cv2's ``imwrite`` of the
  port's own mosaic.
* Each chart function, on seeded data: the ``Figure`` it records equals
  what the JAX function hands a recording stand-in for ``matplotlib``,
  ``matplotlib.pyplot`` and ``seaborn`` (arrays to 1e-12; strings, limits,
  figure sizes, dpi and paths exactly), the stand-in reading format
  strings and colours through matplotlib's own parsers; the written file
  has the pixel size of the JAX function's file drawn by the real
  matplotlib; and each line series' colour lies within 1 px of each of its
  points inside the axes (points that a later line covers aside).
"""

import sys
import types
from pathlib import Path

import cv2
import numpy as np
import pytest

from multiyolov5_tpu.utils import plots as jax_plots
from multiyolov5_tpu_torch.data import images
from multiyolov5_tpu_torch.utils import plots
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

TL = 1
# inside the bands (see the docstring for the readings)
BOX_BAND_MEAN, BOX_BAND_SHARE, BOX_BAND_MAX, BOX_EDGE_MAX = 0.25, 0.35, 8, 80
MOSAIC_BAND_SHARE, MOSAIC_BAND_MAX = 0.30, 8
ARRAY_ATOL = 1e-12


# ------------------------------------------------------------ the mosaics

def _box_band(mask, xyxy, label, tl=TL):
    """The box's stroke band and its label rectangle (grown), set in ``mask``."""
    h, w = mask.shape
    g = tl + 1
    x0, y0, x1, y1 = (int(v) for v in xyxy)
    outer = np.zeros_like(mask)
    outer[max(0, y0 - g):max(0, y1 + g + 1), max(0, x0 - g):max(0, x1 + g + 1)] = True
    inner = np.zeros_like(mask)
    inner[max(0, y0 + g + 1):max(0, y1 - g), max(0, x0 + g + 1):max(0, x1 - g)] = True
    mask |= outer & ~inner
    tw, th = plots.text_size(label, tl)
    mask[max(0, y0 - th - 3 - 2):max(0, y0 + 3), max(0, x0 - 2):max(0, x0 + tw + 3)] = True


def _hold(got, want, band):
    """Equal outside ``band``; inside it, (the differing share, the largest
    difference two or more pixels from the image's edge, the largest at it)."""
    diff = np.abs(got.astype(int) - want.astype(int)).max(2)
    assert not diff[~band].any(), np.argwhere(diff * ~band)[:5]
    inner = np.zeros_like(band)
    inner[2:-2, 2:-2] = True
    return ((diff[band] > 0).mean() if band.any() else 0.0,
            int(diff[band & inner].max(initial=0)), int(diff[band & ~inner].max(initial=0)))


def test_plot_one_box_at_thickness_1_matches_cv2_outside_its_bands():
    rng = np.random.RandomState(3)
    shares, maxes, edges = [], [], []
    for _ in range(40):
        img = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
        x0, y0 = rng.randint(-5, 150, 2)
        w, h = rng.randint(0, 80, 2)
        box = [x0, y0, x0 + w, y0 + h]
        color = [int(v) for v in rng.randint(0, 255, 3)]
        label = ("car", "person", "traffic light", "7")[rng.randint(4)]
        want, got = img.copy(), img.copy()
        jax_plots.plot_one_box(box, want, color=color, label=label, line_thickness=TL)
        plots.plot_one_box(box, got, color=color, label=label, line_thickness=TL)
        assert plots.text_size(label, TL) == cv2.getTextSize(label, 0, TL / 3, 1)[0]
        band = np.zeros(img.shape[:2], bool)
        _box_band(band, box, label)
        share, mx, edge = _hold(got, want, band)
        shares.append(share)
        maxes.append(mx)
        edges.append(edge)
    assert max(shares) <= BOX_BAND_SHARE and max(maxes) <= BOX_BAND_MAX, (shares, maxes)
    assert np.mean(shares) <= BOX_BAND_MEAN and max(edges) <= BOX_EDGE_MAX, edges


@pytest.mark.parametrize("float_input", [False, True], ids=["0-255", "0-1"])
def test_plot_images_matches_jax_mosaic(tmp_path, float_input):
    rng = np.random.RandomState(4)
    bs, hw = 5, 224                                      # 3 x 3 tiles, no shrink past 640
    imgs = (rng.rand(bs, hw, hw, 3) * 255).astype(np.uint8).astype(np.float32)
    if float_input:
        imgs = imgs / 255
    n = 14
    targets = np.concatenate([rng.randint(0, bs, (n, 1)), rng.randint(0, 12, (n, 1)),
                              rng.rand(n, 2) * 0.6 + 0.2, rng.rand(n, 2) * 0.3 + 0.05], 1)
    names = [f"cls{i}" for i in range(10)]               # 10 and 11 print as numbers
    want = jax_plots.plot_images(imgs, targets, fname=str(tmp_path / "jax.jpg"), names=names,
                                 max_size=160)
    got = plots.plot_images(imgs, targets, fname=str(tmp_path / "port.jpg"), names=names,
                            max_size=160)
    assert got.shape == want.shape == (3 * 160, 3 * 160, 3)
    band = np.zeros(got.shape[:2], bool)
    for t in targets:
        i, cls = int(t[0]), int(t[1])
        bx, by = (i % 3) * 160, (i // 3) * 160
        cx, cy, bw, bh = t[2] * 160, t[3] * 160, t[4] * 160, t[5] * 160
        _box_band(band, [bx + cx - bw / 2, by + cy - bh / 2, bx + cx + bw / 2,
                         by + cy + bh / 2], names[cls] if cls < len(names) else str(cls))
    share, mx, edge = _hold(got, want, band)
    assert share <= MOSAIC_BAND_SHARE and max(mx, edge) <= MOSAIC_BAND_MAX, (share, mx, edge)
    cv2.imwrite(str(tmp_path / "cv2.jpg"), got[:, :, ::-1])
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "cv2.jpg").read_bytes()


# ------------------------------------------------------------- the charts

class RecAxes:
    """A recording stand-in for a matplotlib Axes: what each call plots,
    in the port's ``Axes.record`` layout, read with matplotlib's parsers."""

    def __init__(self, place, mpl):
        self.mpl = mpl
        self.cycle = 0
        self.r = dict(place=tuple(place), title="", title_size=12.0, xlabel="", ylabel="",
                      xlim=None, ylim=None, grid_lines=False, labelsize=10.0, legend=None,
                      facecolor=(1.0, 1.0, 1.0), series=[])

    def _rgb(self, c):
        return tuple(int(round(v * 255)) for v in self.mpl["to_rgb"](c))

    def plot(self, *args, color=None, linewidth=1.5, marker="", markersize=6.0, label=None):
        args = list(args)
        ls, fmt_marker, fmt_color = (self.mpl["fmt"](args.pop()) if isinstance(args[-1], str)
                                     else (None, None, None))
        y = np.atleast_1d(np.asarray(args[-1], np.float64))
        x = (np.atleast_1d(np.asarray(args[0], np.float64)) if len(args) == 2
             else np.arange(len(y), dtype=np.float64))
        color = fmt_color or color
        for yi in (y.T if y.ndim == 2 else [y]):
            c = color
            if c is None:
                c = self.mpl["cycle"][self.cycle % len(self.mpl["cycle"])]
                self.cycle += 1
            self.r["series"].append(dict(
                kind="line", x=x, y=np.asarray(yi, np.float64), color=self._rgb(c),
                linewidth=float(linewidth), marker=fmt_marker or marker,
                markersize=float(markersize),
                linestyle="" if ls == "None" else (ls or "-"), label=label))

    def scatter(self, x, y, s=None, c=None, cmap=None, alpha=None, edgecolors="face"):
        self.r["series"].append(dict(kind="scatter", x=np.ravel(x).astype(np.float64),
                                     y=np.ravel(y).astype(np.float64),
                                     c=np.ravel(c).astype(np.float64), cmap=cmap,
                                     s=float(36.0 if s is None else s), alpha=alpha,
                                     edgecolors=edgecolors))

    def hist(self, x, bins=10, rwidth=None):
        self.r["series"].append(dict(kind="hist", values=np.ravel(x).astype(np.float64),
                                     bins=np.asarray(bins, np.float64),
                                     rwidth=1.0 if rwidth is None else rwidth,
                                     color=self._rgb(self.mpl["cycle"][0])))

    def hist2d(self, x, y, bins=10):
        self.r["series"].append(dict(kind="hist2d", x=np.ravel(x).astype(np.float64),
                                     y=np.ravel(y).astype(np.float64), bins=bins,
                                     cmap="viridis"))

    def set_title(self, s, fontdict=None):
        self.r["title"] = s
        if fontdict:
            self.r["title_size"] = float(fontdict["size"])

    def set_xlabel(self, s):
        self.r["xlabel"] = s

    def set_ylabel(self, s):
        self.r["ylabel"] = s

    def set_xlim(self, lo, hi):
        self.r["xlim"] = (float(lo), float(hi))

    def set_ylim(self, lo, hi):
        self.r["ylim"] = (float(lo), float(hi))

    def grid(self):
        self.r["grid_lines"] = True

    def tick_params(self, labelsize=None):
        self.r["labelsize"] = float(labelsize)

    def legend(self, bbox_to_anchor=None, loc=None):
        self.r["legend"] = {"bbox_to_anchor": tuple(float(v) for v in bbox_to_anchor),
                            "loc": loc}

    def set_facecolor(self, c):
        self.r["facecolor"] = tuple(float(v) for v in c)


class RecFigure:
    def __init__(self, mpl, figsize=(6.4, 4.8), tight_layout=False):
        self.mpl, self.axes = mpl, []
        self.r = dict(figsize=tuple(float(v) for v in figsize), tight_layout=bool(tight_layout),
                      dpi=None, path=None)

    def add(self, place):
        ax = RecAxes(place, self.mpl)
        self.axes.append(ax)
        return ax

    def savefig(self, path, dpi=None):
        self.r.update(dpi=dpi, path=str(path))

    def record(self):
        return dict(self.r, axes=[ax.r for ax in self.axes])


def _stand_ins(monkeypatch):
    """Fake ``matplotlib``, ``matplotlib.pyplot`` and ``seaborn`` in
    sys.modules; returns the list the saved figures' records go to."""
    import matplotlib
    from matplotlib.axes._base import _process_plot_format
    from matplotlib.colors import to_rgb
    mpl = {"fmt": _process_plot_format, "to_rgb": to_rgb,
           "cycle": matplotlib.rcParams["axes.prop_cycle"].by_key()["color"]}
    saved, state = [], {"fig": None}

    def figure(figsize=(6.4, 4.8), tight_layout=False):
        state["fig"] = RecFigure(mpl, figsize, tight_layout)
        return state["fig"]

    def gcf():
        return state["fig"] or figure()

    def gca():
        fig = gcf()
        return fig.axes[-1] if fig.axes else fig.add((1, 1, 1))

    def subplots(rows, cols, figsize=(6.4, 4.8), tight_layout=False):
        fig = figure(figsize, tight_layout)
        axes = [fig.add((rows, cols, i + 1)) for i in range(rows * cols)]
        return fig, (axes[0] if rows * cols == 1 else np.array(axes).reshape(rows, cols))

    def savefig(path, dpi=None):
        gcf().savefig(path, dpi)

    def close():
        if state["fig"] is not None:
            saved.append(state["fig"].record())
        state["fig"] = None

    plt = types.ModuleType("matplotlib.pyplot")
    plt.figure, plt.subplots, plt.savefig, plt.close, plt.gca = (figure, subplots, savefig,
                                                                 close, gca)
    plt.subplot = lambda r, c, i: gcf().add((r, c, i))
    plt.plot = lambda *a, **k: gca().plot(*a, **k)
    plt.scatter = lambda *a, **k: gca().scatter(*a, **k)
    plt.title = lambda s, fontdict=None: gca().set_title(s, fontdict)
    plt.xlabel = lambda s: gca().set_xlabel(s)
    plt.ylabel = lambda s: gca().set_ylabel(s)
    plt.grid = lambda: gca().grid()
    plt.tick_params = lambda labelsize=None: gca().tick_params(labelsize)
    plt.legend = lambda **k: gca().legend(**k)
    fake_mpl = types.ModuleType("matplotlib")
    fake_mpl.use = lambda backend: None
    fake_mpl.pyplot = plt
    sn = types.ModuleType("seaborn")

    def heatmap(data, annot=None, annot_kws=None, cmap=None, fmt=".2g", square=False,
                xticklabels="auto", yticklabels="auto"):
        ax = gca()
        ax.r["series"].append(dict(kind="heatmap", data=np.array(data, np.float64),
                                   annot=bool(annot), fmt=fmt,
                                   annot_size=float(annot_kws["size"]), cmap=cmap,
                                   square=square, xticklabels=xticklabels,
                                   yticklabels=yticklabels))
        return ax
    sn.heatmap = heatmap
    for name, mod in (("matplotlib", fake_mpl), ("matplotlib.pyplot", plt), ("seaborn", sn)):
        monkeypatch.setitem(sys.modules, name, mod)
    return saved


def _inputs(tmp: Path):
    """Seeded inputs of every chart case, and the files the cases read."""
    rng = np.random.RandomState(5)
    px = np.linspace(0, 1, 1000)
    py = [np.clip(1 - px ** (1.5 + 2 * i), 0, 1) * (0.9 - 0.2 * i) for i in range(3)]
    ap = rng.rand(3, 10)
    mc = np.stack([np.exp(-((px - 0.3 - 0.2 * i) / 0.15) ** 2) * (0.9 - 0.25 * i)
                   for i in range(3)])
    results = tmp / "results.txt"
    np.savetxt(results, np.concatenate([np.arange(4)[:, None], rng.rand(4, 11)], 1),
               fmt="%.5g")
    evolve = tmp / "evolve.txt"
    np.savetxt(evolve, rng.rand(7, 5 + 5))
    labels = np.concatenate([rng.randint(0, 6, (150, 1)), rng.rand(150, 4) * 0.5 + 0.2], 1)
    return dict(px=px, py=py, ap=ap, mc=mc, results=results, evolve=evolve, labels=labels,
                m4=rng.randint(0, 30, (5, 5)).astype(np.float64),
                m40=rng.randint(0, 4, (41, 41)).astype(np.float64))


CASES = {
    "lr": lambda m, d, i: m.plot_lr_scheduler(list(0.01 * (1 + np.cos(np.arange(30) / 9))), d),
    "results": lambda m, d, i: m.plot_results(str(i["results"]), d),
    "evolution": lambda m, d, i: m.plot_evolution(str(i["evolve"]),
                                                  ["lr0", "momentum", "box"], d),
    "pr_named": lambda m, d, i: m.plot_pr_curve(i["px"], i["py"], i["ap"], d / "PR_curve.png",
                                                ["car", "person", "bus"]),
    "pr_unnamed": lambda m, d, i: m.plot_pr_curve(i["px"], i["py"], i["ap"],
                                                  d / "PR_curve.png", ()),
    "mc_named": lambda m, d, i: m.plot_mc_curve(i["px"], i["mc"], d / "F1_curve.png",
                                                ["car", "person", "bus"], ylabel="F1"),
    "mc_unnamed": lambda m, d, i: m.plot_mc_curve(i["px"], i["mc"], d / "P_curve.png", (),
                                                  ylabel="Precision"),
    "confusion_named": lambda m, d, i: m.plot_confusion_matrix(i["m4"], 4, d,
                                                               ["a", "b", "c", "d"]),
    "confusion_40": lambda m, d, i: m.plot_confusion_matrix(i["m40"], 40, d, ()),
    "labels": lambda m, d, i: m.plot_labels(i["labels"], (), d),
}
FILES = {"lr": "LR.png", "results": "results.png", "evolution": "evolve.png",
         "pr_named": "PR_curve.png", "pr_unnamed": "PR_curve.png", "mc_named": "F1_curve.png",
         "mc_unnamed": "P_curve.png", "confusion_named": "confusion_matrix.png",
         "confusion_40": "confusion_matrix.png", "labels": "labels.jpg"}


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, sorted(a), b)
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list) and not isinstance(b, np.ndarray):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for n, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{n}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (where, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=ARRAY_ATOL, equal_nan=True,
                                   err_msg=where)
    else:
        assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, (where, a, b)
        assert a == b, (where, a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chart_records_what_jax_hands_matplotlib(case, tmp_path, monkeypatch):
    inputs = _inputs(tmp_path)
    fig = CASES[case](plots, tmp_path, inputs)
    saved = _stand_ins(monkeypatch)
    CASES[case](jax_plots, tmp_path, inputs)
    want, = saved
    _same(fig.record(), want)
    assert fig.record()["path"] == str(tmp_path / FILES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_chart_file_has_matplotlibs_pixel_size(case, tmp_path):
    inputs = _inputs(tmp_path)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    CASES[case](plots, tmp_path / "port", inputs)
    CASES[case](jax_plots, tmp_path / "jax", inputs)
    got = images.imread(str(tmp_path / "port" / FILES[case]))
    want = cv2.imread(str(tmp_path / "jax" / FILES[case]))
    assert got.shape == want.shape, (got.shape, want.shape)


def _covered_later(ax, n, px, py, img_px):
    """Points of series ``n`` within a later line's half width (+ 1.5 px) of it."""
    later = ax.series[n + 1:]
    hit = np.zeros(len(px), bool)
    for t in later:
        if t["kind"] != "line":
            continue
        tx, ty = ax.to_pixels(t["x"], t["y"])
        r = max(t["linewidth"] * img_px / 2, t["markersize"] * img_px / 2 if t["marker"]
                else 0) + 1.5
        for k in range(len(tx)):
            hit |= np.hypot(px - tx[k], py - ty[k]) <= r
            if k:
                # the segment from the previous point
                ax_, ay_, bx_, by_ = tx[k - 1], ty[k - 1], tx[k], ty[k]
                d = np.array([bx_ - ax_, by_ - ay_])
                L2 = max(d @ d, 1e-12)
                u = np.clip(((px - ax_) * d[0] + (py - ay_) * d[1]) / L2, 0, 1)
                hit |= np.hypot(px - ax_ - u * d[0], py - ay_ - u * d[1]) <= r
    return hit


@pytest.mark.parametrize("case", ["lr", "results", "evolution", "pr_named", "pr_unnamed",
                                  "mc_named", "mc_unnamed"])
def test_chart_lines_lie_where_the_transform_puts_them(case, tmp_path):
    inputs = _inputs(tmp_path)
    fig = CASES[case](plots, tmp_path, inputs)
    img = fig.render(fig.dpi)
    ppt = fig.dpi / 72
    checked = 0
    for ax in fig.axes:
        x0, y0, x1, y1 = ax.box
        edge = max(0.8 * ppt, 1.0) + 2
        for n, s in enumerate(ax.series):
            if s["kind"] != "line":
                continue
            px, py = ax.to_pixels(s["x"], s["y"])
            inside = (px > x0 + edge) & (px < x1 - edge) & (py > y0 + edge) & (py < y1 - edge)
            keep = inside & ~_covered_later(ax, n, px, py, ppt)
            for u, v in zip(px[keep], py[keep]):
                r, c = int(np.floor(v)), int(np.floor(u))
                win = img[r - 1:r + 2, c - 1:c + 2].reshape(-1, 3)
                assert (win == s["color"]).all(1).any(), (case, s.get("label"), u, v,
                                                          s["color"], win)
                checked += 1
    assert checked > 0
