"""AutoAnchor: the best-possible-recall check and the k-means + genetic
anchor evolution (counterpart of ``multiyolov5_tpu/utils/autoanchor.py``;
reference utils/autoanchor.py).

numpy and scipy's ``kmeans``.  The JAX module draws from the global
``np.random``; here every draw (the 0.9-1.1 shape jitter, kmeans' initial
centroids, the mutation loop) comes from one passed
``np.random.RandomState``, in the same order, so seeded alike the two give
the same anchors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def check_anchor_order(anchors: np.ndarray, strides: Sequence[int]) -> np.ndarray:
    """Reverse the anchors if their area order disagrees with the strides'
    (reference utils/autoanchor.py:12-20).  anchors: (nl, na, 2)."""
    a = anchors.reshape(-1, 2).prod(-1)
    da = a[-1] - a[0]
    ds = strides[-1] - strides[0]
    if np.sign(da) != np.sign(ds):
        return anchors[::-1].copy()
    return anchors


def metric_bpr(anchors_wh: np.ndarray, wh: np.ndarray, thr: float = 4.0):
    """(best possible recall, anchors above threshold per target)
    (reference utils/autoanchor.py:30-37)."""
    r = wh[:, None] / anchors_wh[None]
    x = np.minimum(r, 1.0 / r).min(2)
    best = x.max(1)
    aat = (x > 1.0 / thr).sum(1).mean()
    bpr = (best > 1.0 / thr).mean()
    return bpr, aat


def check_anchors(dataset, spec, rng: np.random.RandomState, thr: float = 4.0,
                  imgsz: int = 640):
    """The BPR >= 0.98 gate; below it, k-means anchors replace the spec's
    when their BPR is higher (reference :23-59).  Mutates ``spec.anchors``
    in place and returns them."""
    shapes = imgsz * dataset.shapes / dataset.shapes.max(1, keepdims=True)
    scale = rng.uniform(0.9, 1.1, size=(shapes.shape[0], 1))
    wh = np.concatenate([lb[:, 3:5] * s for s, lb in zip(shapes * scale, dataset.labels)
                         if len(lb)])
    anchors = np.asarray(spec.anchors, np.float32).reshape(-1, 2)
    bpr, aat = metric_bpr(anchors, wh, thr)
    print(f"autoanchor: anchors/target = {aat:.2f}, BPR = {bpr:.4f}")
    if bpr < 0.98:
        print("autoanchor: attempting to improve anchors...")
        na = anchors.shape[0]
        new = kmean_anchors(dataset, rng, n=na, img_size=imgsz, thr=thr, gen=1000,
                            verbose=False)
        new_bpr = metric_bpr(new, wh, thr)[0]
        if new_bpr > bpr:
            new = check_anchor_order(new.reshape(spec.nl, -1, 2), spec.strides)
            spec.anchors = [list(a.reshape(-1)) for a in new]
            print("autoanchor: new anchors saved to spec")
        else:
            print("autoanchor: original anchors better, keeping")
    return spec.anchors


def kmean_anchors(dataset, rng: np.random.RandomState, n: int = 9, img_size: int = 640,
                  thr: float = 4.0, gen: int = 1000, verbose: bool = True,
                  wh: np.ndarray = None) -> np.ndarray:
    """k-means, then ``gen`` generations of mutation, on the labels' wh
    (reference utils/autoanchor.py:62-160).  Returns (n, 2) sorted by area."""
    from scipy.cluster.vq import kmeans

    thr = 1.0 / thr

    def metric(k, wh_):
        r = wh_[:, None] / k[None]
        x = np.minimum(r, 1.0 / r).min(2)
        return x, x.max(1)

    def anchor_fitness(k):
        _, best = metric(k, wh)
        return (best * (best > thr)).mean()

    if wh is None:
        shapes = img_size * dataset.shapes / dataset.shapes.max(1, keepdims=True)
        wh0 = np.concatenate([lb[:, 3:5] * s for s, lb in zip(shapes, dataset.labels)
                              if len(lb)])
        i = (wh0 < 3.0).any(1).sum()
        if i:
            print(f"autoanchor: WARNING: {i} of {len(wh0)} labels are < 3 px")
        wh = wh0[(wh0 >= 2.0).any(1)]

    s = wh.std(0)
    # ``seed`` takes a RandomState as it is (``rng`` would reseed from it),
    # so kmeans draws what the JAX module's global-state call draws
    k, _ = kmeans(wh / s, n, iter=30, seed=rng)
    if len(k) != n:
        raise ValueError("kmeans returned fewer clusters than requested")
    k *= s
    k = k[np.argsort(k.prod(1))]

    f = anchor_fitness(k)
    sh = k.shape
    mp, sigma = 0.9, 0.1
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((rng.random_sample(sh) < mp) * rng.random_sample()
                 * rng.randn(*sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = anchor_fitness(kg)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    if verbose:
        _, best = metric(k, wh)
        print(f"autoanchor: fitness={f:.4f}, BPR={(best > thr).mean():.4f}")
    return k
