"""Detection dataset and loader (counterpart of
``multiyolov5_tpu/data/detection.py``; reference utils/datasets.py).

The JAX package's semantics on the port's own host code: discovery from a
directory, a ``.txt`` list (``./`` entries relative to it) or a list; the
label cache (under ``.torchcache.npz``, so that neither package reads the
other's); polygon label rows turned into boxes; ``single_cls``; rect
binning by aspect ratio with ``batch_shapes``; ``load_image`` (in eval mode
it shrinks by cv2's ``INTER_AREA``, ``data/resize.py``; it grows, and with
``augment`` also shrinks, by cv2's ``INTER_LINEAR``, ``data/letterbox.py``)
and the RAM image cache; the letterbox, the label transform and BGR ->
RGB.  ``DetectionLoader`` yields the ``(imgs, targets, tmask, paths,
shapes)`` batches that the train step and ``evaluation.evaluate_detection``
read, from ordered worker threads.

Training (``augment``): mosaic, mixup, ``random_perspective``, the HSV
jitter and the flips (``data/augment.py`` computes cv2's warps and colour
conversions), and rect training; the loader's shuffle, image weights and
``quad`` (collate_fn4).  The JAX dataset draws from the global ``random``
and ``np.random``; an item here takes a ``random.Random`` and an
``np.random.RandomState`` and draws from them in the same order (mosaic
``random()``; the centre's two ``uniform``s and ``choices(k=3)``; the eight
``uniform``s of ``random_perspective``; mixup's ``random()`` [,
``randint``, ``beta``]; the HSV gains' ``uniform(-1, 1, 3)``; the flips'
two ``random()``s), so seeded alike the two items are equal.  The loader
derives each item's generators from (seed, epoch, position in the epoch)
and each quad group's from (seed, epoch, batch): a batch is the same
whatever the worker count.

Images are PNG, JPEG, MPO, BMP, TIFF and WebP files, read by ``data/images.py``:
``load_image`` as ``cv2.imread`` reads (the orientation applied where
OpenCV applies it), the label cache's shapes and verdicts as the JAX
cache's ``Image.open(f)``, ``verify()`` and ``exif_size`` give them
(swapped for EXIF orientations 6 and 8 only; a PNG with a bad chunk
dropped).  A DNG image in a split raises ``NotImplementedError``
naming it before anything is loaded (the JAX cache would keep it, and cv2
read it).
The augmentations the JAX CLI never calls are here too, on the same
generators: ``load_mosaic9`` (a method beside ``load_mosaic``),
``replicate``, ``cutout`` and ``hist_equalize`` (cv2's YUV conversions,
``equalizeHist`` and CLAHE from data/augment.py).
"""

from __future__ import annotations

import glob
import hashlib
import math
import os
import queue as queue_mod
import random
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..utils.boxes import xywhn2xyxy, xyxy2xywh
from . import images
from .augment import augment_hsv, equalize_hist, random_perspective, resize_linear, rgb2yuv, yuv2rgb
from .augment import clahe as augment_clahe
from .letterbox import letterbox
from .resize import resize_area

IMG_FORMATS = ("bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo")
CACHE_VERSION = "torch-0.1"
CACHE_SUFFIX = ".torchcache.npz"
QUAD_STREAM = 1 << 30      # keeps the quad groups' streams apart from the items'


def generators(*key: int) -> Tuple[random.Random, np.random.RandomState]:
    """A ``random.Random`` and an ``np.random.RandomState`` seeded from the
    integers ``key`` (``np.random.SeedSequence``)."""
    a, b = np.random.SeedSequence([int(k) for k in key]).generate_state(2)
    return random.Random(int(a)), np.random.RandomState(int(b))


def img2label_paths(img_paths: List[str]) -> List[str]:
    sa, sb = os.sep + "images" + os.sep, os.sep + "labels" + os.sep
    return [sb.join(x.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for x in img_paths]


def get_hash(files: List[str]) -> str:
    total = sum(os.path.getsize(f) for f in files if os.path.isfile(f))
    return hashlib.md5(f"{total}:{len(files)}".encode()).hexdigest()


class DetectionDataset:
    """reference LoadImagesAndLabels."""

    def __init__(self, path, img_size=640, batch_size=16, augment=False, hyp=None,
                 rect=False, image_weights=False, cache_images=False, single_cls=False,
                 stride=32, pad=0.0, prefix=""):
        self.img_size = img_size
        self.augment = augment
        self.hyp = hyp or {}
        self.image_weights = image_weights
        self.rect = False if image_weights else rect
        self.mosaic = self.augment and not self.rect
        self.mosaic_border = [-img_size // 2, -img_size // 2]
        self.stride = stride

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
        images.require_readable(self.img_files, "detection split")
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
        self.indices = list(range(n))

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

        self.imgs = [None] * n
        self.img_hw0 = [None] * n
        self.img_hw = [None] * n
        if cache_images:
            for i in range(n):
                self.imgs[i], self.img_hw0[i], self.img_hw[i] = self.load_image(i)

    def _cache_labels(self, path: Path, prefix: str = ""):
        """Each image's size (its header, EXIF-swapped as the JAX
        ``exif_size``) and labels; an image whose header or labels fail the
        checks is dropped, as the JAX package drops it."""
        files, labels, shapes = [], [], []
        nf = nm = ne = nc = 0
        for im_file, lb_file in zip(self.img_files, self.label_files):
            try:
                shape = images.exif_size(im_file)
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
        (h0, w0), (h, w)), from the RAM cache when it holds it: cv2's
        ``INTER_AREA`` to shrink in eval mode, ``INTER_LINEAR`` otherwise."""
        if self.imgs[index] is not None:
            return self.imgs[index], self.img_hw0[index], self.img_hw[index]
        img = images.imread(self.img_files[index])
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            wh = (int(w0 * r), int(h0 * r))
            img = (resize_area(img, wh) if r < 1 and not self.augment
                   else resize_linear(img, wh))
        return img, (h0, w0), img.shape[:2]

    def _perspective(self, img, labels, rnd, border=(0, 0)):
        hyp = self.hyp
        return random_perspective(
            img, labels, rnd, degrees=hyp.get("degrees", 0),
            translate=hyp.get("translate", 0.1), scale=hyp.get("scale", 0.5),
            shear=hyp.get("shear", 0), perspective=hyp.get("perspective", 0.0),
            border=border)

    def load_mosaic(self, index, rnd):
        """Four images around a random centre on a 2s x 2s canvas of 114,
        then ``random_perspective`` back to s x s (reference
        utils/datasets.py:668-725)."""
        labels4 = []
        s = self.img_size
        yc, xc = (int(rnd.uniform(-x, 2 * s + x)) for x in self.mosaic_border)
        indices = [index] + rnd.choices(self.indices, k=3)
        img4 = None
        for i, idx in enumerate(indices):
            img, _, (h, w) = self.load_image(idx)
            if i == 0:
                img4 = np.full((s * 2, s * 2, img.shape[2]), 114, np.uint8)
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
            elif i == 1:
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
            else:
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
            img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b
            labels = self.labels[idx].copy()
            if labels.size:
                labels[:, 1:] = xywhn2xyxy(labels[:, 1:], w, h, padw, padh)
            labels4.append(labels)
        labels4 = np.concatenate(labels4, 0)
        np.clip(labels4[:, 1:], 0, 2 * s, out=labels4[:, 1:])
        return self._perspective(img4, labels4, rnd, border=self.mosaic_border)

    def load_mosaic9(self, index, rnd):
        """Nine images around the first on a 3s x 3s canvas of 114, a random
        2s x 2s crop of it, then ``random_perspective`` back to s x s
        (reference utils/datasets.py:727-798): ``rnd.choices(k=8)``, the
        crop's two ``uniform``s, the warp's eight."""
        labels9 = []
        s = self.img_size
        indices = [index] + rnd.choices(self.indices, k=8)
        img9 = None
        hp = wp = -1
        for i, idx in enumerate(indices):
            img, _, (h, w) = self.load_image(idx)
            if i == 0:  # center
                img9 = np.full((s * 3, s * 3, img.shape[2]), 114, np.uint8)
                h0, w0 = h, w
                c = s, s, s + w, s + h
            elif i == 1:  # top
                c = s, s - h, s + w, s
            elif i == 2:  # top right
                c = s + wp, s - h, s + wp + w, s
            elif i == 3:  # right
                c = s + w0, s, s + w0 + w, s + h
            elif i == 4:  # bottom right
                c = s + w0, s + hp, s + w0 + w, s + hp + h
            elif i == 5:  # bottom
                c = s + w0 - w, s + h0, s + w0, s + h0 + h
            elif i == 6:  # bottom left
                c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
            elif i == 7:  # left
                c = s - w, s + h0 - h, s, s + h0
            else:  # top left
                c = s - w, s + h0 - hp - h, s, s + h0 - hp
            padx, pady = c[:2]
            x1, y1, x2, y2 = (max(x, 0) for x in c)
            labels = self.labels[idx].copy()
            if labels.size:
                labels[:, 1:] = xywhn2xyxy(labels[:, 1:], w, h, padx, pady)
            labels9.append(labels)
            img9[y1:y2, x1:x2] = img[y1 - pady:, x1 - padx:][:y2 - y1, :x2 - x1]
            hp, wp = h, w
        yc, xc = (int(rnd.uniform(0, s)) for _ in self.mosaic_border)
        img9 = img9[yc:yc + 2 * s, xc:xc + 2 * s]
        labels9 = np.concatenate(labels9, 0)
        if len(labels9):
            labels9[:, [1, 3]] -= xc
            labels9[:, [2, 4]] -= yc
            np.clip(labels9[:, 1:], 0, 2 * s, out=labels9[:, 1:])
        return self._perspective(img9, labels9, rnd, border=self.mosaic_border)

    def __getitem__(self, index):
        """The item at position ``index``; in training mode with the
        generators of (0, 0, index) (the loader passes its own to
        :meth:`item`)."""
        return self.item(index, *(generators(0, 0, index) if self.augment else (None, None)))

    def item(self, index, rnd: Optional[random.Random], nrs: Optional[np.random.RandomState]):
        """(RGB uint8 image, labels (n, 5) [cls, xywh normalised], path,
        shapes or None), the JAX ``__getitem__`` with its draws from
        ``rnd`` and ``nrs``."""
        index = self.indices[index]
        hyp = self.hyp
        mosaic = self.mosaic and rnd.random() < hyp.get("mosaic", 0)
        shapes = None
        if mosaic:
            img, labels = self.load_mosaic(index, rnd)
            if rnd.random() < hyp.get("mixup", 0):
                img2, labels2 = self.load_mosaic(rnd.randint(0, self.n - 1), rnd)
                r = nrs.beta(8.0, 8.0)
                img = (img * r + img2 * (1 - r)).astype(np.uint8)
                labels = np.concatenate((labels, labels2), 0)
        else:
            img, (h0, w0), (h, w) = self.load_image(index)
            shape = self.batch_shapes[self.batch[index]] if self.rect else self.img_size
            img, ratio, pad = letterbox(img, shape, auto=False, scaleup=self.augment)
            img = img.numpy()
            shapes = (h0, w0), ((h / h0, w / w0), pad)
            labels = self.labels[index].copy()
            if labels.size:
                labels[:, 1:] = xywhn2xyxy(labels[:, 1:], ratio[0] * w, ratio[1] * h,
                                           padw=pad[0], padh=pad[1])

        if self.augment:
            if not mosaic:
                img, labels = self._perspective(img, labels, rnd)
            augment_hsv(img, nrs, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                        hyp.get("hsv_v", 0.4))

        nl = len(labels)
        if nl:
            labels[:, 1:5] = xyxy2xywh(labels[:, 1:5])
            labels[:, [2, 4]] /= img.shape[0]
            labels[:, [1, 3]] /= img.shape[1]
        if self.augment:
            if rnd.random() < hyp.get("flipud", 0):
                img = np.flipud(img)
                if nl:
                    labels[:, 2] = 1 - labels[:, 2]
            if rnd.random() < hyp.get("fliplr", 0):
                img = np.fliplr(img)
                if nl:
                    labels[:, 1] = 1 - labels[:, 1]
        img = np.ascontiguousarray(img[:, :, ::-1])  # BGR->RGB, keep HWC
        return img, labels.astype(np.float32), self.img_files[index], shapes


def hist_equalize(img: np.ndarray, clahe: bool = True, bgr: bool = False) -> np.ndarray:
    """Histogram equalization of the Y channel of a uint8 BGR/RGB image
    (reference utils/datasets.py hist_equalize; JAX
    multiyolov5_tpu/data/detection.py:436): cv2's YUV round trip, CLAHE
    (clip 2, 8 x 8 tiles) or ``equalizeHist``."""
    yuv = rgb2yuv(img[..., ::-1] if bgr else img)
    yuv[:, :, 0] = augment_clahe(yuv[:, :, 0], 2.0, (8, 8)) if clahe else \
        equalize_hist(yuv[:, :, 0])
    out = yuv2rgb(yuv)
    return np.ascontiguousarray(out[..., ::-1] if bgr else out)


def replicate(img: np.ndarray, labels: np.ndarray, rnd: random.Random):
    """Copy the smaller half of the boxes (by mean side) to random places,
    in place, and add their labels (reference utils/datasets.py
    replicate()); ``rnd`` gives two ``uniform``s a copy."""
    h, w = img.shape[:2]
    boxes = labels[:, 1:].astype(int)
    x1, y1, x2, y2 = boxes.T
    s = ((x2 - x1) + (y2 - y1)) / 2
    for i in s.argsort()[: round(s.size * 0.5)]:
        x1b, y1b, x2b, y2b = boxes[i]
        bh, bw = y2b - y1b, x2b - x1b
        yc, xc = int(rnd.uniform(0, h - bh)), int(rnd.uniform(0, w - bw))
        x1a, y1a, x2a, y2a = [xc, yc, xc + bw, yc + bh]
        img[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        labels = np.append(labels, [[labels[i, 0], x1a, y1a, x2a, y2a]], axis=0)
    return img, labels


def cutout(img: np.ndarray, labels: np.ndarray, rnd: random.Random) -> np.ndarray:
    """31 grey rectangles of halving sizes, in place; the labels that the
    larger ones cover by 60% or more go (reference utils/datasets.py:948-991).
    ``rnd`` gives each mask's four ``randint``s and its colour's three."""
    h, w = img.shape[:2]
    scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16
    for s in scales:
        mask_h = rnd.randint(1, int(h * s))
        mask_w = rnd.randint(1, int(w * s))
        xmin = max(0, rnd.randint(0, w) - mask_w // 2)
        ymin = max(0, rnd.randint(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        img[ymin:ymax, xmin:xmax] = [rnd.randint(64, 191) for _ in range(3)]
        if len(labels) and s > 0.03:
            box = np.array([[xmin, ymin, xmax, ymax]], np.float32)
            ioa = _bbox_ioa(box[0], labels[:, 1:5])
            labels = labels[ioa < 0.60]
    return labels


def _bbox_ioa(box1, box2, eps=1e-9):
    """Intersection of ``box1`` (4,) with each of ``box2`` (n, 4) xyxy, over
    each box2's area."""
    b2x1, b2y1, b2x2, b2y2 = box2.T
    inter = (np.minimum(box1[2], b2x2) - np.maximum(box1[0], b2x1)).clip(0) * \
            (np.minimum(box1[3], b2y2) - np.maximum(box1[1], b2y1)).clip(0)
    return inter / ((b2x2 - b2x1) * (b2y2 - b2y1) + eps)


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
    """Threaded prefetching loader, batches in order.

    Yields (imgs (B, H, W, 3) uint8 RGB, targets (B, T, 5), mask (B, T),
    paths, shapes).  A rect dataset's batches are its aspect-ratio bins
    (never shuffled).  ``shuffle`` permutes the positions with
    ``RandomState(seed + epoch)``, the epoch counting the iterations;
    ``quad`` folds each 4 items into one (collate_fn4).  ``shard`` /
    ``num_shards`` split the batches between hosts (reference
    utils/datasets.py:76)."""

    def __init__(self, dataset: DetectionDataset, batch_size: int,
                 max_targets: int = 128, shuffle: bool = False,
                 workers: int = 4, shard: int = 0, num_shards: int = 1,
                 drop_last: bool = True, seed: int = 0, quad: bool = False):
        if quad and batch_size % 4:
            raise ValueError("quad=True requires batch_size divisible by 4")
        self.ds = dataset
        self.bs = batch_size
        self.max_targets = max_targets
        self.quad = quad
        self.rect = bool(getattr(dataset, "rect", False))
        self.shuffle = shuffle and not self.rect
        self.workers = max(1, workers)
        self.shard = shard
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.epoch = 0
        self.seed = seed

    def _plan(self):
        """The epoch's batches' position arrays, shard-local."""
        n = len(self.ds)
        idx = np.arange(n)
        if self.rect:
            bins = np.asarray(self.ds.batch)
            nb = int(bins[-1]) + 1 if n else 0
            batches = [idx[bins == b] for b in range(nb)]
            if self.drop_last and nb > 1 and len(batches[-1]) < len(batches[0]):
                batches = batches[:-1]
            return batches[self.shard::self.num_shards]
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        idx = idx[self.shard::self.num_shards]
        if self.num_shards > 1:         # equal step counts on every host
            idx = idx[: n // self.num_shards]
        nb = (len(idx) // self.bs if self.drop_last
              else math.ceil(len(idx) / self.bs))
        return [idx[i * self.bs:(i + 1) * self.bs] for i in range(nb)]

    def __len__(self):
        return len(self._plan())

    def set_image_weights(self, weights: np.ndarray):
        """reference train.py:303-316: the epoch's positions map to images
        drawn with probability proportional to ``weights``."""
        n = len(self.ds)
        rng = np.random.RandomState(self.seed + self.epoch)
        self.ds.indices = list(rng.choice(n, size=n, p=weights / weights.sum()))

    def batch(self, batches, bi: int, epoch: int):
        """Batch ``bi`` of an epoch's plan, its items' draws from
        (seed, epoch, position) and its quad groups' from (seed, epoch, bi)."""
        aug = self.ds.augment
        items = [self.ds.item(i, *(generators(self.seed, epoch, i) if aug else (None, None)))
                 for i in batches[bi]]
        if self.quad:
            items = self._quad(items, generators(self.seed, epoch, bi, QUAD_STREAM)[0])
        return self._collate(items)

    def __iter__(self):
        batches = self._plan()
        epoch = self.epoch
        self.epoch += 1
        return ordered_batches(len(batches), lambda bi: self.batch(batches, bi, epoch),
                               self.workers)

    @staticmethod
    def _quad(items, rnd: random.Random):
        """collate_fn4 (reference utils/datasets.py:601-625;
        multiyolov5_tpu/data/detection.py:611-644): each group of 4 items
        becomes one 2x item, with probability 0.5 (``rnd.random()``) its
        first image grown 2x by cv2's ``INTER_LINEAR``, else a 2x2 stitch of
        the four with their labels offset and halved."""
        if len(items) < 4:      # a ragged drop_last=False tail passes unfolded
            return items
        out = []
        ho = np.array([[0., 0, 1, 0, 0]], np.float32)   # below: y += 1
        wo = np.array([[0., 1, 0, 0, 0]], np.float32)   # right: x += 1
        s = np.array([[1, .5, .5, .5, .5]], np.float32)
        for g in range(len(items) // 4):
            i = g * 4
            img, _, path, shapes = items[i]
            h, w = img.shape[:2]
            if rnd.random() < 0.5:
                im = resize_linear(img, (w * 2, h * 2))
                lb = items[i][1]
            else:
                im = np.empty((h * 2, w * 2, img.shape[2]), img.dtype)
                im[:h, :w] = img
                im[h:, :w] = items[i + 1][0]
                im[:h, w:] = items[i + 2][0]
                im[h:, w:] = items[i + 3][0]
                lb = np.concatenate([items[i][1], items[i + 1][1] + ho,
                                     items[i + 2][1] + wo, items[i + 3][1] + ho + wo], 0) * s
            out.append((im, lb, path, shapes))
        return out

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
