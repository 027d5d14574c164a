"""Detection dataset and loader for evaluation (counterpart of
``multiyolov5_tpu/data/detection.py``; reference utils/datasets.py).

The JAX package's eval semantics on the port's own host code: discovery
from a directory, a ``.txt`` list (``./`` entries relative to it) or a
list; the label cache (under ``.torchcache.npz``, so that neither package
reads the other's); polygon label rows turned into boxes; ``single_cls``;
rect binning by aspect ratio with ``batch_shapes``; ``load_image``
(shrinks by cv2's ``INTER_AREA``, ``data/resize.py``; grows by cv2's
``INTER_LINEAR``, ``data/letterbox.py``), the letterbox with ``auto=False,
scaleup=False``, the label transform and BGR -> RGB.  ``DetectionLoader``
yields the ``(imgs, targets, tmask, paths, shapes)`` batches that
``evaluation.evaluate_detection`` reads, from ordered worker threads.

Images are PNG files, read by ``data/png.py``: any other image in a split
raises ``NotImplementedError`` naming it before anything is loaded (the
JAX cache would drop it as corrupted, and so change the metric).  The
training parts raise ``NotImplementedError`` too: ``augment`` (mosaic,
``random_perspective``, HSV, flips), ``image_weights`` and ``quad`` come
with the rest of training (ROADMAP.md, "The rest of training"), and so
does the RAM image cache.
"""

from __future__ import annotations

import glob
import hashlib
import math
import os
import queue as queue_mod
import threading
from pathlib import Path
from typing import List

import numpy as np
import torch

from ..utils.boxes import xywhn2xyxy, xyxy2xywh
from . import png
from .letterbox import _resize, letterbox
from .resize import resize_area

IMG_FORMATS = ("bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo")
CACHE_VERSION = "torch-0.1"
CACHE_SUFFIX = ".torchcache.npz"
TRAINING = ("comes with the rest of training, which the port does not have yet "
            "(ROADMAP.md, 'The rest of training')")


def img2label_paths(img_paths: List[str]) -> List[str]:
    sa, sb = os.sep + "images" + os.sep, os.sep + "labels" + os.sep
    return [sb.join(x.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for x in img_paths]


def get_hash(files: List[str]) -> str:
    total = sum(os.path.getsize(f) for f in files if os.path.isfile(f))
    return hashlib.md5(f"{total}:{len(files)}".encode()).hexdigest()


class DetectionDataset:
    """reference LoadImagesAndLabels, evaluation mode."""

    def __init__(self, path, img_size=640, batch_size=16, augment=False,
                 rect=False, image_weights=False, single_cls=False, stride=32,
                 pad=0.0, prefix=""):
        if augment:
            raise NotImplementedError(
                f"augment (mosaic, random_perspective, HSV, flips) {TRAINING}")
        if image_weights:
            raise NotImplementedError(f"image_weights {TRAINING}")
        self.img_size = img_size
        self.rect = rect

        f: List[str] = []
        for p in (path if isinstance(path, list) else [path]):
            p = Path(p)
            if p.is_dir():
                f += glob.glob(str(p / "**" / "*.*"), recursive=True)
            elif p.is_file():
                with open(p) as t:
                    lines = t.read().strip().splitlines()
                parent = str(p.parent) + os.sep
                f += [x.replace("./", parent) if x.startswith("./") else x
                      for x in lines]
            else:
                raise FileNotFoundError(f"{prefix}{p} does not exist")
        self.img_files = sorted(
            x for x in f if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS)
        if not self.img_files:
            raise FileNotFoundError(f"{prefix}No images found in {path}")
        png.require_png(self.img_files, "detection split")
        self.label_files = img2label_paths(self.img_files)

        p0 = Path(path if isinstance(path, str) else path[0])
        cache_path = (p0 if p0.is_file()
                      else Path(self.label_files[0]).parent).with_suffix(CACHE_SUFFIX)
        cache = None
        if cache_path.is_file():
            try:
                with np.load(cache_path, allow_pickle=False) as z:
                    if (str(z["hash"]) == get_hash(self.label_files + self.img_files)
                            and str(z["version"]) == CACHE_VERSION):
                        ends = np.cumsum(z["counts"])
                        cache = {"files": [str(f) for f in z["files"]],
                                 "labels": np.split(z["labels"], ends[:-1]),
                                 "shapes": z["shapes"]}
            except (OSError, KeyError, ValueError):
                cache = None
        if cache is None:
            cache = self._cache_labels(cache_path, prefix)

        self.img_files = cache["files"]
        self.label_files = img2label_paths(self.img_files)
        self.labels = [np.asarray(lb, np.float32).reshape(-1, 5)
                       for lb in cache["labels"]]
        self.shapes = np.asarray(cache["shapes"], np.float64)
        if single_cls:
            for x in self.labels:
                x[:, 0] = 0

        n = len(self.img_files)
        bi = np.floor(np.arange(n) / batch_size).astype(int)
        nb = int(bi[-1]) + 1
        self.batch = bi
        self.n = n

        if self.rect:
            s = self.shapes  # (w, h)
            ar = s[:, 1] / s[:, 0]
            irect = ar.argsort()
            self.img_files = [self.img_files[i] for i in irect]
            self.label_files = [self.label_files[i] for i in irect]
            self.labels = [self.labels[i] for i in irect]
            self.shapes = s[irect]
            ar = ar[irect]
            shapes = [[1.0, 1.0]] * nb
            for i in range(nb):
                ari = ar[bi == i]
                mini, maxi = ari.min(), ari.max()
                if maxi < 1:
                    shapes[i] = [maxi, 1]
                elif mini > 1:
                    shapes[i] = [1, 1 / mini]
            self.batch_shapes = (np.ceil(
                np.array(shapes) * img_size / stride + pad) * stride).astype(int)

    def _cache_labels(self, path: Path, prefix: str = ""):
        """Each image's size (its PNG header) and labels; an image whose
        header or labels fail the checks is dropped, as the JAX package
        drops it."""
        files, labels, shapes = [], [], []
        nf = nm = ne = nc = 0
        for im_file, lb_file in zip(self.img_files, self.label_files):
            try:
                shape = png.size(im_file)
                if shape[0] <= 9 or shape[1] <= 9:
                    raise ValueError(f"image size {shape} <10px")
                if os.path.isfile(lb_file):
                    nf += 1
                    with open(lb_file) as fh:
                        rows = [x.split() for x in fh.read().strip().splitlines()]
                    if any(len(x) > 8 for x in rows):  # polygon segments -> boxes
                        cls = np.array([x[0] for x in rows], np.float32)
                        segs = [np.array(x[1:], np.float32).reshape(-1, 2)
                                for x in rows]
                        boxes = np.array([[s[:, 0].min(), s[:, 1].min(),
                                           s[:, 0].max(), s[:, 1].max()]
                                          for s in segs], np.float32)
                        lb = np.concatenate([cls[:, None], xyxy2xywh(boxes)], 1)
                    else:
                        lb = np.array(rows, np.float32)
                    if len(lb):
                        if lb.shape[1] != 5:
                            raise ValueError("labels require 5 columns")
                        if (lb < 0).any():
                            raise ValueError("negative labels")
                        if (lb[:, 1:] > 1).any():
                            raise ValueError("non-normalized coords")
                    else:
                        ne += 1
                        lb = np.zeros((0, 5), np.float32)
                else:
                    nm += 1
                    lb = np.zeros((0, 5), np.float32)
                files.append(im_file)
                labels.append(lb)
                shapes.append(shape)
            except (OSError, ValueError, IndexError) as e:
                nc += 1
                print(f"{prefix}WARNING: ignoring corrupted {im_file}: {e}")
        print(f"{prefix}Scanned {len(files)} images: {nf} labels found, "
              f"{nm} missing, {ne} empty, {nc} corrupted")
        try:
            # every image's label rows in one array and their counts: no pickle
            np.savez(path, files=np.array(files), shapes=np.array(shapes),
                     labels=np.concatenate([np.zeros((0, 5), np.float32)] + labels),
                     counts=np.array([len(lb) for lb in labels], np.int64),
                     hash=get_hash(self.label_files + self.img_files),
                     version=CACHE_VERSION)
        except OSError:                   # a read-only label directory: no cache
            pass
        return {"files": files, "labels": labels, "shapes": shapes}

    def __len__(self):
        return self.n

    def load_image(self, index):
        """(BGR uint8 image resized so its long side is ``img_size``,
        (h0, w0), (h, w)): ``INTER_AREA`` to shrink, ``INTER_LINEAR`` to grow."""
        img = png.imread(self.img_files[index])
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            wh = (int(w0 * r), int(h0 * r))
            img = (resize_area(img, wh) if r < 1
                   else _resize(torch.from_numpy(img), wh).numpy())
        return img, (h0, w0), img.shape[:2]

    def __getitem__(self, index):
        img, (h0, w0), (h, w) = self.load_image(index)
        shape = self.batch_shapes[self.batch[index]] if self.rect else self.img_size
        img, ratio, pad = letterbox(img, shape, auto=False, scaleup=False)
        img = img.numpy()
        shapes = (h0, w0), ((h / h0, w / w0), pad)
        labels = self.labels[index].copy()
        if labels.size:
            labels[:, 1:] = xywhn2xyxy(labels[:, 1:], ratio[0] * w, ratio[1] * h,
                                       padw=pad[0], padh=pad[1])
        if len(labels):
            labels[:, 1:5] = xyxy2xywh(labels[:, 1:5])
            labels[:, [2, 4]] /= img.shape[0]
            labels[:, [1, 3]] /= img.shape[1]
        img = np.ascontiguousarray(img[:, :, ::-1])  # BGR->RGB, keep HWC
        return img, labels.astype(np.float32), self.img_files[index], shapes


def ordered_batches(n: int, make, workers: int):
    """Yield ``make(0)``, ..., ``make(n - 1)`` in order, built by up to
    ``workers`` threads: batch k by worker k % W into its own queue of 2
    (backpressure), each put timed so that an abandoned iterator leaves no
    thread blocked; an exception in a worker is raised here."""
    W = min(max(1, workers), max(1, n))
    qs = [queue_mod.Queue(maxsize=2) for _ in range(W)]
    stop = threading.Event()

    def produce(w):
        for bi in range(w, n, W):
            try:
                payload = make(bi)
            except Exception as e:
                payload = e
            while not stop.is_set():
                try:
                    qs[w].put(payload, timeout=0.2)
                    break
                except queue_mod.Full:
                    continue
            if stop.is_set() or isinstance(payload, Exception):
                return

    for w in range(W):
        threading.Thread(target=produce, args=(w,), daemon=True).start()
    try:
        for k in range(n):
            batch = qs[k % W].get()
            if isinstance(batch, Exception):
                raise batch
            yield batch
    finally:
        stop.set()


class DetectionLoader:
    """Threaded prefetching loader of eval batches, in order.

    Yields (imgs (B, H, W, 3) uint8 RGB, targets (B, T, 5), mask (B, T),
    paths, shapes).  A rect dataset's batches are its aspect-ratio bins.
    ``shard`` / ``num_shards`` split the batches between hosts (reference
    utils/datasets.py:76)."""

    def __init__(self, dataset: DetectionDataset, batch_size: int,
                 max_targets: int = 128, shuffle: bool = False,
                 workers: int = 4, shard: int = 0, num_shards: int = 1,
                 drop_last: bool = True, quad: bool = False):
        if quad:
            raise NotImplementedError(f"quad (collate_fn4) {TRAINING}")
        if shuffle and not dataset.rect:
            raise NotImplementedError(f"shuffle {TRAINING}")
        self.ds = dataset
        self.bs = batch_size
        self.max_targets = max_targets
        self.workers = max(1, workers)
        self.shard = shard
        self.num_shards = num_shards
        self.drop_last = drop_last

    def _plan(self):
        """The batches' index arrays, shard-local."""
        n = len(self.ds)
        idx = np.arange(n)
        if self.ds.rect:
            bins = np.asarray(self.ds.batch)
            nb = int(bins[-1]) + 1 if n else 0
            batches = [idx[bins == b] for b in range(nb)]
            if self.drop_last and nb > 1 and len(batches[-1]) < len(batches[0]):
                batches = batches[:-1]
            return batches[self.shard::self.num_shards]
        idx = idx[self.shard::self.num_shards]
        if self.num_shards > 1:         # equal step counts on every host
            idx = idx[: n // self.num_shards]
        nb = (len(idx) // self.bs if self.drop_last
              else math.ceil(len(idx) / self.bs))
        return [idx[i * self.bs:(i + 1) * self.bs] for i in range(nb)]

    def __len__(self):
        return len(self._plan())

    def __iter__(self):
        batches = self._plan()
        return ordered_batches(len(batches),
                               lambda bi: self._collate([self.ds[i] for i in batches[bi]]),
                               self.workers)

    def _collate(self, items):
        imgs = np.stack([it[0] for it in items], 0)
        B = len(items)
        targets = np.zeros((B, self.max_targets, 5), np.float32)
        mask = np.zeros((B, self.max_targets), bool)
        for i, it in enumerate(items):
            lb = it[1]
            n = min(len(lb), self.max_targets)
            if n:
                targets[i, :n] = lb[:n]
                mask[i, :n] = True
        paths = [it[2] for it in items]
        shapes = [it[3] for it in items]
        return imgs, targets, mask, paths, shapes
