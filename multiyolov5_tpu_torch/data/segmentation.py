"""Segmentation datasets and loaders (counterpart of
``multiyolov5_tpu/data/segmentation.py``; reference SegmentationDataset.py).

Every mode of the JAX package, its PIL calls done by ``data/resize.py``
(``BILINEAR``) and ``data/pil_ops.py`` (``NEAREST``, ``ImageEnhance``, the
HSV conversions), equal value for value:

* ``train``: flip (p 0.5), the long side drawn from ``range_and_prob``'s
  normal pdf (scipy) over [low, high] x base_size / 32, ``BILINEAR`` for
  the image and ``NEAREST`` for the mask, the pad (image 0, mask 255) up
  to the crop, a random crop, then the colour jitter
  (``torchvision.ColorJitter`` semantics: brightness, contrast,
  saturation, hue factors drawn in that order, applied in a shuffled
  order);
* ``val``: the short side resized to the crop, a centre crop;
* ``testval``: the image's long side resized to ``base_size``, rounded to
  a multiple of 32, the mask kept at its own size; ``test``: the image and
  its file name.

The mask is read as stored (``data/images.py`` ``read_samples``,
``np.array(Image.open(m))``: a gray or a palette file's indices, uint16
for 16-bit gray, bool for 1-bit) and taken as int32; Cityscapes labelIds map to trainIds through the
JAX package's key table, ignore = -1.  Outputs are numpy: img (H, W, 3)
float32 in [0, 1] RGB, mask (H, W) int.  The JAX dataset draws from the
global ``random``; an item here takes a ``random.Random`` and draws from
it in the same order (flip, long side, crop x and y, jitter factors,
shuffle), so seeded alike the two items are equal.  ``SegLoader`` derives
each item's generator from (seed, epoch, position in the epoch).

Images are PNG, JPEG, MPO, BMP, TIFF and WebP files, read as
``Image.open(...).convert("RGB")`` reads them (``data/images.py``; no EXIF
orientation applied, but a TIFF's, which Pillow applies; a WebP
animation's first frame); masks as ``np.array(Image.open(...))`` gives
them (a WebP mask as RGB, or RGBA where it has alpha): a split holding a
DNG image raises ``NotImplementedError`` naming it when the
dataset is built.  ``CityBddSegmentation`` mixes Cityscapes with BDD100k,
whose frames are ``.jpg``.
"""

from __future__ import annotations

import functools
import math
import os
import random
from typing import Optional

import numpy as np

from ..ops.nn import make_divisible
from . import images, pil_ops
from .detection import generators, ordered_batches
from .resize import resize_bilinear_pil

MODES = ("train", "val", "testval", "test")


@functools.lru_cache(128)
def range_and_prob(base_size: int, low: float = 0.5, high: float = 3.0, std: int = 25):
    from scipy import stats

    lo = math.ceil((base_size * low) / 32)
    hi = math.ceil((base_size * high) / 32)
    mean = math.ceil(base_size / 32) - 4
    x = np.arange(lo, hi + 1)
    p = stats.norm.pdf(x, mean, std)
    p = p / p.sum()
    return x, np.cumsum(p)


def get_long_size(rnd: random.Random, base_size: int, low: float = 0.5,
                  high: float = 3.0, std: int = 40) -> int:
    x, cum_p = range_and_prob(base_size, low, high, std)
    return rnd.choices(population=list(x), cum_weights=list(cum_p), k=1)[0] * 32


def color_jitter(img: np.ndarray, rnd: random.Random, brightness: float, contrast: float,
                 saturation: float, hue: float) -> np.ndarray:
    """torchvision ``ColorJitter`` semantics on uint8 RGB: each factor ~
    U[max(0, 1 - v), 1 + v] (hue ~ U[-h, h]), the ops in a random order."""
    ops = []
    if brightness > 0:
        f = rnd.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: pil_ops.brightness(im, f))
    if contrast > 0:
        f2 = rnd.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: pil_ops.contrast(im, f2))
    if saturation > 0:
        f3 = rnd.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: pil_ops.color(im, f3))
    if hue > 0:
        h = rnd.uniform(-hue, hue)
        ops.append(lambda im: pil_ops.hue_shift(im, h))
    rnd.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


class BaseSegDataset:
    def __init__(self, root, split, mode=None, base_size=520, crop_size=480,
                 low=0.6, high=3.0, sample_std=25, jitter=None):
        self.root = root
        self.split = split
        self.mode = mode if mode is not None else split
        if self.mode not in MODES:
            raise ValueError(f"seg mode {self.mode!r}: one of {MODES}")
        self.base_size = base_size
        self.crop_size = crop_size if isinstance(crop_size, tuple) else (crop_size, crop_size)
        self.low = low
        self.high = high
        self.sample_std = sample_std
        self.jitter = jitter  # (b, c, s, h) or None

    def _testval_img_transform(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        outlong = make_divisible(self.base_size, 32)
        if w > h:
            ow = outlong
            oh = make_divisible(int(1.0 * h * ow / w), 32)
        else:
            oh = outlong
            ow = make_divisible(int(1.0 * w * oh / h), 32)
        return resize_bilinear_pil(img, (ow, oh))

    def _val_sync_transform(self, img: np.ndarray, mask: np.ndarray):
        outsize = self.crop_size[0]
        if self.crop_size[0] != self.crop_size[1]:
            outsize = self.crop_size[1]  # square centre crop of the short side
        short_size = outsize
        h, w = img.shape[:2]
        if w > h:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        else:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        img = resize_bilinear_pil(img, (ow, oh))
        mask = pil_ops.resize_nearest(mask, (ow, oh))
        x1 = int(round((ow - outsize) / 2.0))
        y1 = int(round((oh - outsize) / 2.0))
        return (img[y1:y1 + outsize, x1:x1 + outsize],
                mask[y1:y1 + outsize, x1:x1 + outsize])

    def _sync_transform(self, img: np.ndarray, mask: np.ndarray, rnd: random.Random):
        if rnd.random() < 0.5:
            img, mask = img[:, ::-1], mask[:, ::-1]
        w_crop, h_crop = self.crop_size
        h, w = img.shape[:2]
        long_size = get_long_size(rnd, self.base_size, self.low, self.high, self.sample_std)
        if h > w:
            oh = long_size
            ow = int(1.0 * w * long_size / h + 0.5)
        else:
            ow = long_size
            oh = int(1.0 * h * long_size / w + 0.5)
        img = resize_bilinear_pil(np.ascontiguousarray(img), (ow, oh))
        mask = pil_ops.resize_nearest(mask, (ow, oh))
        if ow < w_crop or oh < h_crop:
            padh = h_crop - oh if oh < h_crop else 0
            padw = w_crop - ow if ow < w_crop else 0
            img = np.pad(img, ((0, padh), (0, padw), (0, 0)), constant_values=0)
            mask = np.pad(mask, ((0, padh), (0, padw)) + ((0, 0),) * (mask.ndim - 2),
                          constant_values=255)
            if mask.ndim == 3:      # PIL's fill 255 on a multi-band mask: its first band only
                mask[oh:, :, 1:] = 0
                mask[:, ow:, 1:] = 0
        h, w = img.shape[:2]
        x1 = rnd.randint(0, w - w_crop)
        y1 = rnd.randint(0, h - h_crop)
        return (img[y1:y1 + h_crop, x1:x1 + w_crop],
                np.ascontiguousarray(mask[y1:y1 + h_crop, x1:x1 + w_crop]))

    def _finish_img(self, img: np.ndarray, rnd: Optional[random.Random] = None) -> np.ndarray:
        if self.mode == "train" and self.jitter:
            img = color_jitter(np.ascontiguousarray(img), rnd, *self.jitter)
        return np.asarray(img, np.float32) / 255.0

    def _read(self, index, rnd: Optional[random.Random]):
        """(the image as uint8 RGB after the mode's transform, its mask's
        stored samples after it, or None in test mode)."""
        img = images.read_rgb(self.images[index])
        if self.mode == "test":
            return img, None
        mask = images.read_samples(self.mask_paths[index])
        if self.mode == "train":
            return self._sync_transform(img, mask, rnd)
        if self.mode == "val":
            return self._val_sync_transform(img, mask)
        return self._testval_img_transform(img), mask

    def __getitem__(self, index):
        """The item at ``index``; in train mode with the generator of (0, 0,
        index) (the loader passes its own to :meth:`item`)."""
        return self.item(index, generators(0, 0, index)[0] if self.mode == "train" else None)

    def __len__(self):
        return len(self.images)


class CitySegmentation(BaseSegDataset):
    """Cityscapes gtFine (labelId annotations)."""

    NUM_CLASS = 19

    def __init__(self, root="data/citys/", split="train", mode=None, **kw):
        super().__init__(root, split, mode, **kw)
        self.images, self.mask_paths = get_city_pairs(self.root, self.split)
        if not self.images:
            raise RuntimeError(f"Found 0 images in {self.root}")
        images.require_readable(self.images, "seg split")
        # labelId -> trainId (reference SegmentationDataset.py:174-182)
        self._key = np.array([-1, -1, -1, -1, -1, -1,
                              -1, -1, 0, 1, -1, -1,
                              2, 3, 4, -1, -1, -1,
                              5, -1, 6, 7, 8, 9,
                              10, 11, 12, 13, 14, 15,
                              -1, -1, 16, 17, 18])

    def _class_to_index(self, mask: np.ndarray) -> np.ndarray:
        """labelIds (>= 0) -> trainIds: the JAX package's
        ``np.digitize(mask, arange(-1, 34), right=True)`` is id + 1 there,
        so the key is indexed directly; an id past 33 raises IndexError,
        as it does there."""
        mask[mask == 255] = 0  # pad fill -> id 0 -> trainId -1
        return self._key[mask + 1]

    def item(self, index, rnd: Optional[random.Random]):
        img, mask = self._read(index, rnd)
        if self.mode == "test":
            return (self._finish_img(self._testval_img_transform(img)),
                    os.path.basename(self.images[index]))
        return self._finish_img(img, rnd), self._class_to_index(mask.astype("int32"))


class CityBddSegmentation(CitySegmentation):
    """Cityscapes + BDD100k mix (JAX ``segmentation.py:208-233``; reference
    SegmentationDataset.py:236-324): a ``.jpg`` frame is BDD's, its ``.png``
    mask already trainIds (255 -> -1 only); a ``.png`` frame's labelIds go
    through the trainId key.  Every mode draws as :class:`CitySegmentation`
    does; like the JAX dataset it has no ``test`` mode."""

    def __init__(self, root="data/citys/", split="train", mode=None, NUM_CLASS=19, **kw):
        super().__init__(root, split, mode, **kw)
        self.NUM_CLASS = NUM_CLASS

    def item(self, index, rnd: Optional[random.Random]):
        if self.mode == "test":
            raise ValueError("CityBddSegmentation has no test mode (nor has the JAX dataset)")
        img, mask = self._read(index, rnd)
        m = mask.astype("int32")
        if self.images[index].endswith(".jpg"):
            m[m == 255] = -1
        else:
            m = self._class_to_index(m)
        return self._finish_img(img, rnd), m


class CustomSegmentation(BaseSegDataset):
    """User datasets already in trainId format; 255 -> -1
    (reference SegmentationDataset.py:327-373)."""

    def __init__(self, root="data/", split="train", mode=None, NUM_CLASS=2, **kw):
        super().__init__(root, split, mode, **kw)
        self.NUM_CLASS = NUM_CLASS
        self.images, self.mask_paths = get_custom_pairs(self.root, self.split)
        if not self.images:
            raise RuntimeError(f"Found 0 images in {self.root}")
        images.require_readable(self.images, "seg split")

    def item(self, index, rnd: Optional[random.Random]):
        img, mask = self._read(index, rnd)
        if self.mode == "test":
            return (self._finish_img(self._testval_img_transform(img)),
                    os.path.basename(self.images[index]))
        m = mask.astype("int32")
        m[m == 255] = -1
        return self._finish_img(img, rnd), m


def _pairs(img_folder, mask_dir, mask_name):
    """(sorted image paths, sorted mask paths) under ``img_folder`` whose
    mask, ``mask_dir(image path)/mask_name(file name)``, exists."""
    img_paths, mask_paths = [], []
    for root, _, files in os.walk(img_folder):
        for filename in files:
            if filename.endswith((".png", ".jpg")):
                imgpath = os.path.join(root, filename)
                maskname = mask_name(filename)
                if filename.endswith(".jpg"):
                    maskname = maskname.replace(".jpg", ".png")
                maskpath = os.path.join(mask_dir(imgpath), maskname)
                if os.path.isfile(imgpath) and os.path.isfile(maskpath):
                    img_paths.append(imgpath)
                    mask_paths.append(maskpath)
                else:
                    print("cannot find the mask or image:", imgpath, maskpath)
    return sorted(img_paths), sorted(mask_paths)


def get_city_pairs(folder: str, split: str = "train"):
    def pairs(img_folder, mask_folder):
        return _pairs(img_folder,
                      lambda p: os.path.join(mask_folder, os.path.basename(os.path.dirname(p))),
                      lambda f: f.replace("leftImg8bit", "gtFine_labelIds"))

    if split in ("train", "val", "test"):
        return pairs(os.path.join(folder, "leftImg8bit", split),
                     os.path.join(folder, "gtFine", split))
    if split != "trainval":
        raise ValueError(f"split {split!r}: train, val, test or trainval")
    a = pairs(os.path.join(folder, "leftImg8bit/train"), os.path.join(folder, "gtFine/train"))
    b = pairs(os.path.join(folder, "leftImg8bit/val"), os.path.join(folder, "gtFine/val"))
    return a[0] + b[0], a[1] + b[1]


def get_custom_pairs(folder: str, split: str = "train"):
    if split not in ("train", "val", "test"):
        raise ValueError(f"split {split!r}: train, val or test")
    return _pairs(os.path.join(folder, "segimages", split),
                  lambda p: os.path.join(folder, "seglabels", split),
                  lambda f: f.replace("segimages", "seglabels"))


class SegLoader:
    """Threaded batch loader yielding (imgs (B, H, W, 3) f32, masks (B, H, W)
    int), in order.  ``shuffle`` permutes with ``RandomState(seed +
    epoch)``, the epoch counting the iterations.

    In testval mode images keep their own sizes; a batch stacks only when
    its shapes match, and raises otherwise, as the JAX loader does."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 workers: int = 4, drop_last: bool = False, shard: int = 0,
                 num_shards: int = 1, seed: int = 0):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.workers = max(1, workers)
        self.drop_last = drop_last
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed
        self.epoch = 0

    def _plan(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        idx = idx[self.shard::self.num_shards]
        if self.num_shards > 1:         # equal step counts on every host
            idx = idx[: len(self.ds) // self.num_shards]
        nb = (len(idx) // self.bs if self.drop_last
              else math.ceil(len(idx) / self.bs))
        return [idx[i * self.bs:(i + 1) * self.bs] for i in range(nb)]

    def __len__(self):
        return len(self._plan())

    def batch(self, index, epoch: int):
        """The batch of positions ``index``, each item's draws from (seed,
        epoch, position)."""
        train = self.ds.mode == "train"
        items = [self.ds.item(i, generators(self.seed, epoch, i)[0] if train else None)
                 for i in index]
        return (np.stack([it[0] for it in items], 0),
                np.stack([np.asarray(it[1]) for it in items], 0))

    def __iter__(self):
        batches = self._plan()
        epoch = self.epoch
        self.epoch += 1
        return ordered_batches(len(batches), lambda bi: self.batch(batches[bi], epoch),
                               self.workers)


def get_citys_loader(root="data/citys/", split="train", mode="train",
                     base_size=1024, crop_size=(1024, 512), batch_size=32,
                     workers=4, **kw):
    jitter = (0.45, 0.45, 0.45, 0.15) if mode == "train" else None
    ds = CitySegmentation(root=root, split=split, mode=mode,
                          base_size=base_size, crop_size=crop_size,
                          low=0.65, high=3, sample_std=25, jitter=jitter)
    return SegLoader(ds, batch_size, shuffle=(mode == "train"), workers=workers, **kw)


def get_citysbdd_loader(root="data/citys/", split="train", mode="train",
                        base_size=1024, crop_size=(1024, 512), batch_size=32,
                        workers=4, **kw):
    """The Cityscapes + BDD100k mix (reference SegmentationDataset.py:236-324):
    :class:`CityBddSegmentation` with this mix's jitter and scale range."""
    jitter = (0.4, 0.4, 0.4, 0.05) if mode == "train" else None
    ds = CityBddSegmentation(root=root, split=split, mode=mode,
                          base_size=base_size, crop_size=crop_size,
                          low=0.65, high=2, sample_std=40, jitter=jitter)
    return SegLoader(ds, batch_size, shuffle=(mode == "train"),
                     drop_last=(mode == "train"), workers=workers, **kw)


def get_custom_loader(root="data/", split="train", mode="train",
                      base_size=1024, batch_size=32, workers=4, n_segcls=2, **kw):
    jitter = (0.4, 0.4, 0.4, 0.0) if mode == "train" else None
    ds = CustomSegmentation(root=root, split=split, mode=mode, NUM_CLASS=n_segcls,
                            base_size=base_size, crop_size=(base_size, base_size),
                            low=0.75, high=1.5, sample_std=35, jitter=jitter)
    return SegLoader(ds, batch_size, shuffle=(mode == "train"),
                     drop_last=(mode == "train"), workers=workers, **kw)
