"""Box drawing, the training-batch mosaics and the charts (counterpart of
``multiyolov5_tpu/utils/plots.py``), in numpy.

``plot_one_box`` draws as cv2 would at the two settings the JAX package
uses: ``line_thickness`` 3 (the detect app and hub: an outline of
thickness 3, a filled label rectangle and the label in Hershey font 0 at
``fontScale`` 1, thickness 2) and 1 (``plot_images``: thickness 1,
``fontScale`` 1/3, thickness 1), all anti-aliased.  What cv2 draws for
these comes from ``glyphs.npz`` (made by ``tools/make_glyphs.py`` with
cv2): per setting, the coverage of the outline and of the label rectangle
at every size up to a base size (a larger one repeats the base's middle
row and column), and each printable ASCII character's coverage and
advance.  A stamp is blended into the image as ``round(p + (color - p) *
coverage / 255)``: fully covered pixels take the colour exactly; at the
anti-aliased edges, where cv2 blends each stroke in turn with its own
integer rounding, the result can differ from cv2's by a few levels, and
more where a shape is clipped at the image's edge.  ``add_weighted`` is
``cv2.addWeighted`` on uint8 images.  ``color_list`` is the JAX package's
ten base colours (the hub and the mosaics draw with them).

``plot_images`` is the JAX mosaic (cv2's ``INTER_LINEAR`` shrink through
``data/augment.resize_linear``, written by ``data/images.imwrite``).  The
charts (``plot_lr_scheduler``, ``plot_results``, ``plot_evolution``,
``plot_pr_curve``, ``plot_mc_curve``, ``plot_confusion_matrix``,
``plot_labels``) make the same calls as the JAX functions make of
matplotlib and seaborn, on ``utils/charts.py``'s ``Figure``, which draws
them without either; each returns its ``Figure`` (None where the JAX
function draws nothing).
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
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
def glyph_table() -> dict:
    """glyphs.npz: the stamps of each line thickness under ``{tl: {...}}``
    (outline, filled, glyphs, advance, text_height, text_pad), and the
    shared chars, glyph_origin, base and margin."""
    with np.load(os.path.join(os.path.dirname(__file__), "glyphs.npz")) as z:
        t = {k: z[k] for k in z.files}
    t["chars"] = bytes(t["chars"]).decode()
    for tl in t["thicknesses"].tolist():
        sfx = f"_t{tl}"
        t[tl] = {k[:-len(sfx)]: t.pop(k) for k in list(t) if isinstance(k, str)
                 and k.endswith(sfx)}
    return t


def _setting(tl: int) -> dict:
    t = glyph_table()
    if tl not in t:
        raise ValueError(f"boxes are drawn at line_thickness {t['thicknesses'].tolist()} "
                         f"only, not {tl}")
    return t[tl]


def _stretch(stamps: np.ndarray, w: int, h: int) -> np.ndarray:
    """The coverage stamp of a w x h shape, ``margin`` pixels around it."""
    t = glyph_table()
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


def blend(img: np.ndarray, cover: np.ndarray, x0: int, y0: int, color) -> None:
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


def glyph_index(c: str) -> int:
    """A character's row of the glyph table (printable ASCII); '?' for any other."""
    chars = glyph_table()["chars"]
    return chars.find(c if c in chars else "?")


def text_size(label: str, line_thickness: int = 3):
    """``cv2.getTextSize(label, 0, tl / 3, max(tl - 1, 1))[0]``: (width, height)."""
    t = _setting(line_thickness)
    idx = [glyph_index(c) for c in label]
    return int(t["advance"][idx].sum() + t["text_pad"]), int(t["text_height"])


def _put_text(img: np.ndarray, label: str, org, tl: int) -> None:
    """``cv2.putText(img, label, org, 0, tl / 3, TEXT_COLOR, max(tl - 1, 1), LINE_AA)``."""
    t = _setting(tl)
    oy, ox = (int(v) for v in glyph_table()["glyph_origin"])
    x = int(org[0])
    for c in label:
        i = glyph_index(c)
        blend(img, t["glyphs"][i], x - ox, int(org[1]) - oy, TEXT_COLOR)
        x += int(t["advance"][i])


def plot_one_box(x: Sequence[float], img: np.ndarray, color=None, label: Optional[str] = None,
                 line_thickness: int = 3) -> None:
    """Draw one xyxy box on a BGR (H, W, 3) uint8 image, in place, as
    multiyolov5_tpu/utils/plots.py:24-36 does with cv2."""
    tl = line_thickness or round(0.002 * (img.shape[0] + img.shape[1]) / 2) + 1
    t = _setting(tl)
    color = color or [np.random.randint(0, 255) for _ in range(3)]
    m = int(glyph_table()["margin"])
    x0, y0, x1, y1 = (int(v) for v in x[:4])
    x0, x1, y0, y1 = min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1)
    s = _stretch(t["outline"], x1 - x0, y1 - y0)
    k = 2 * m + 1                 # the outline's band; inside it cv2 draws nothing
    if min(s.shape) <= 2 * k:
        blend(img, s, x0 - m, y0 - m, color)
    else:
        blend(img, s[:k], x0 - m, y0 - m, color)
        blend(img, s[-k:], x0 - m, y0 - m + s.shape[0] - k, color)
        blend(img, s[k:-k, :k], x0 - m, y0 - m + k, color)
        blend(img, s[k:-k, -k:], x0 - m + s.shape[1] - k, y0 - m + k, color)
    if label:
        tw, th = text_size(label, tl)
        blend(img, _stretch(t["filled"], tw, th + 3), x0 - m, y0 - th - 3 - m, color)
        _put_text(img, label, (x0, y0 - 2), tl)


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


def plot_images(images, targets, paths=None, fname="images.jpg", names=None,
                max_size=640, max_subplots=16):
    """The training-batch mosaic (multiyolov5_tpu/utils/plots.py:39-73;
    reference utils/plots.py:114-191 simplified): up to ``max_subplots``
    tiles shrunk to ``max_size``, on white, each target's box in
    ``color_list()[cls % 10]`` with its class name at ``line_thickness`` 1.

    images: (B, H, W, 3) NHWC, [0, 1] or [0, 255]; targets: (n, 6) [image,
    cls, xywh normalised].  Returns the RGB mosaic; writes it to ``fname``
    (``data/images.imwrite``: JPEG at cv2's defaults) unless ``fname`` is
    empty."""
    from ..data.augment import resize_linear
    from ..data.images import imwrite
    if images.max() <= 1:
        images = images * 255
    bs, h, w, _ = images.shape
    bs = min(bs, max_subplots)
    ns = int(np.ceil(bs ** 0.5))
    scale = max_size / max(h, w)
    if scale < 1:
        h, w = int(h * scale), int(w * scale)
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    colors = color_list()
    for i in range(bs):
        img = images[i].astype(np.uint8)
        if scale < 1:
            img = resize_linear(img, (w, h))
        bx, by = (i % ns) * w, (i // ns) * h
        mosaic[by:by + h, bx:bx + w] = img
        if targets is not None and len(targets):
            for t in targets[targets[:, 0] == i]:
                cls = int(t[1])
                cx, cy, bw, bh = t[2] * w, t[3] * h, t[4] * w, t[5] * h
                xyxy = [bx + cx - bw / 2, by + cy - bh / 2, bx + cx + bw / 2, by + cy + bh / 2]
                label = names[cls] if names and cls < len(names) else str(cls)
                plot_one_box(xyxy, mosaic, color=colors[cls % 10], label=label,
                             line_thickness=1)
    if fname:
        imwrite(str(fname), mosaic[:, :, ::-1])
    return mosaic


def plot_lr_scheduler(lrs, save_dir=""):
    """LR.png (multiyolov5_tpu/utils/plots.py:76-85)."""
    from .charts import Figure
    fig = Figure()
    ax = fig.gca()
    ax.plot(lrs, ".-", label="LR")
    ax.set_xlabel("epoch")
    ax.set_ylabel("LR")
    ax.grid()
    fig.savefig(Path(save_dir) / "LR.png", dpi=200)
    return fig


RESULT_TITLES = ["Box", "Objectness", "Classification", "Precision", "Recall",
                 "Seg", "mAP@0.5", "mAP@0.5:0.95", "mIoU", "fitness2"]


def plot_results(results_file="results.txt", save_dir=""):
    """results.png: each results.txt column from the third on against the
    epoch (multiyolov5_tpu/utils/plots.py:88-106); None where the file does
    not load."""
    from .charts import Figure
    try:
        data = np.loadtxt(results_file, usecols=range(2, 12), ndmin=2).T
    except (OSError, ValueError):
        return None
    fig = Figure(figsize=(12, 6), tight_layout=True)
    ax = fig.subplots(2, 5)
    n = data.shape[1]
    for i in range(min(10, data.shape[0])):
        ax[i].plot(range(n), data[i], marker=".", linewidth=2, markersize=8)
        ax[i].set_title(RESULT_TITLES[i] if i < len(RESULT_TITLES) else str(i))
    fig.savefig(Path(save_dir) / "results.png", dpi=200)
    return fig


def plot_evolution(evolve_txt="evolve.txt", keys=(), save_dir=None):
    """evolve.png: fitness against each hyperparameter, the best point
    marked (multiyolov5_tpu/utils/plots.py:109-136)."""
    from .charts import Figure
    x = np.loadtxt(evolve_txt, ndmin=2)
    if not len(x):
        return None
    f = x[:, 0]
    n = x.shape[1] - 5
    keys = list(keys) if keys else [f"hyp{i}" for i in range(n)]
    fig = Figure(figsize=(12, 12), tight_layout=True)
    cols = int(np.ceil(np.sqrt(n)))
    for i in range(n):
        y = x[:, 5 + i]
        ax = fig.add_subplot(cols, int(np.ceil(n / cols)), i + 1)
        ax.scatter(y, f, c=f, cmap="viridis", alpha=0.8, edgecolors="none")
        ax.plot(y[f.argmax()], f.max(), "k+", markersize=15)
        ax.set_title(f"{keys[i] if i < len(keys) else i} = {y[f.argmax()]:.3g}", size=9)
        ax.tick_params(labelsize=7)
    out = Path(save_dir or Path(evolve_txt).parent) / "evolve.png"
    fig.savefig(out, dpi=200)
    print(f"saved evolution plot to {out}")
    return fig


def plot_pr_curve(px, py, ap, save_dir="pr_curve.png", names=()):
    """PR_curve.png: each class's precision-recall curve and their mean
    (multiyolov5_tpu/utils/plots.py:139-158)."""
    from .charts import Figure
    fig = Figure(figsize=(9, 6), tight_layout=True)
    ax = fig.gca()
    if py:
        py = np.stack(py, axis=1)
        if 0 < len(names) < 21:
            for i, y in enumerate(py.T):
                ax.plot(px, y, linewidth=1, label=f"{names[i]} {ap[i, 0]:.3f}")
        else:
            ax.plot(px, py, linewidth=1, color="grey")
        ax.plot(px, py.mean(1), linewidth=3, color="blue",
                label="all classes %.3f mAP@0.5" % ap[:, 0].mean())
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(Path(save_dir), dpi=250)
    return fig


def plot_mc_curve(px, py, save_dir="mc_curve.png", names=(), xlabel="Confidence",
                  ylabel="Metric"):
    """A metric against confidence for each class and their mean
    (multiyolov5_tpu/utils/plots.py:161-182)."""
    from .charts import Figure
    fig = Figure(figsize=(9, 6), tight_layout=True)
    ax = fig.gca()
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=f"{names[i]}")
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(Path(save_dir), dpi=250)
    return fig


def plot_confusion_matrix(matrix, nc, save_dir="", names=()):
    """confusion_matrix.png: seaborn's heatmap of the column-normalised
    matrix (multiyolov5_tpu/utils/plots.py:185-206)."""
    from .charts import Figure
    array = matrix / (matrix.sum(0).reshape(1, nc + 1) + 1e-6)
    array[array < 0.005] = np.nan
    fig = Figure(figsize=(12, 9), tight_layout=True)
    labels = (0 < len(names) < 99) and len(names) == nc
    fig.heatmap(array, annot=nc < 30, annot_kws={"size": 8}, cmap="Blues", fmt=".2f",
                square=True,
                xticklabels=list(names) + ["background FP"] if labels else "auto",
                yticklabels=list(names) + ["background FN"] if labels else "auto",
                ).set_facecolor((1, 1, 1))
    fig.axes[0].set_xlabel("True")
    fig.axes[0].set_ylabel("Predicted")
    fig.savefig(Path(save_dir) / "confusion_matrix.png", dpi=250)
    return fig


def plot_labels(labels, names=(), save_dir=""):
    """labels.jpg: the class histogram, the centres and sizes by class, and
    the centres' 2-D histogram (multiyolov5_tpu/utils/plots.py:209-227)."""
    from .charts import Figure
    c, b = labels[:, 0], labels[:, 1:5].T
    nc = int(c.max() + 1) if len(c) else 1
    fig = Figure(figsize=(8, 8), tight_layout=True)
    ax = fig.subplots(2, 2)
    ax[0].hist(c, bins=np.linspace(0, nc, nc + 1) - 0.5, rwidth=0.8)
    ax[0].set_ylabel("instances")
    ax[1].scatter(b[0], b[1], c=c, cmap="tab10", s=3)
    ax[1].set_xlabel("x")
    ax[1].set_ylabel("y")
    ax[2].scatter(b[2], b[3], c=c, cmap="tab10", s=3)
    ax[2].set_xlabel("width")
    ax[2].set_ylabel("height")
    ax[3].hist2d(b[0], b[1], bins=50)
    fig.savefig(Path(save_dir) / "labels.jpg", dpi=200)
    return fig
