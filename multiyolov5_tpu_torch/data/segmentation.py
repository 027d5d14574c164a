"""Segmentation datasets and loaders for evaluation (counterpart of
``multiyolov5_tpu/data/segmentation.py``; reference SegmentationDataset.py).

Modes ``testval`` (the image's long side resized to ``base_size``, rounded
to a multiple of 32, by PIL's ``BILINEAR``, ``data/resize.py``; the mask
kept at its own size) and ``test`` (the image and its file name).  The
mask is read as stored (``data/png.py`` ``read_samples``: a gray or a
palette file's indices); Cityscapes labelIds map to trainIds through the
JAX package's key table, ignore = -1.  Outputs are numpy: img (H, W, 3)
float32 in [0, 1] RGB, mask (H, W) int.

Images are PNG files: a split holding any other image (BDD100k's ``.jpg``
frames in ``citysbdd``) raises ``NotImplementedError`` naming it when the
dataset is built.  Modes ``train`` and ``val`` (random scale, crop, flip,
colour jitter; ``range_and_prob`` needs scipy) come with the rest of
training (ROADMAP.md, "The rest of training") and raise too.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..ops.nn import make_divisible
from . import png
from .detection import TRAINING, ordered_batches
from .resize import resize_bilinear_pil

EVAL_MODES = ("testval", "test")


class BaseSegDataset:
    def __init__(self, root, split, mode=None, base_size=520):
        self.root = root
        self.split = split
        self.mode = mode if mode is not None else split
        if self.mode not in EVAL_MODES:
            raise NotImplementedError(f"seg mode {self.mode!r} (random scale, crop, flip, "
                                      f"colour jitter) {TRAINING}")
        self.base_size = base_size

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

    def _finish_img(self, img: np.ndarray) -> np.ndarray:
        return np.asarray(img, np.float32) / 255.0

    def _read(self, index):
        """(the image as uint8 RGB, its mask's stored samples or None in test mode)."""
        img = png.read_rgb(self.images[index])
        if self.mode == "test":
            return img, None
        return self._testval_img_transform(img), png.read_samples(self.mask_paths[index])

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
        png.require_png(self.images, "seg split")
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

    def __getitem__(self, index):
        img, mask = self._read(index)
        if self.mode == "test":
            return (self._finish_img(self._testval_img_transform(img)),
                    os.path.basename(self.images[index]))
        return self._finish_img(img), self._class_to_index(mask.astype("int32"))


class CustomSegmentation(BaseSegDataset):
    """User datasets already in trainId format; 255 -> -1
    (reference SegmentationDataset.py:327-373)."""

    def __init__(self, root="data/", split="train", mode=None, NUM_CLASS=2, **kw):
        super().__init__(root, split, mode, **kw)
        self.NUM_CLASS = NUM_CLASS
        self.images, self.mask_paths = get_custom_pairs(self.root, self.split)
        if not self.images:
            raise RuntimeError(f"Found 0 images in {self.root}")
        png.require_png(self.images, "seg split")

    def __getitem__(self, index):
        img, mask = self._read(index)
        if self.mode == "test":
            return (self._finish_img(self._testval_img_transform(img)),
                    os.path.basename(self.images[index]))
        m = mask.astype("int32")
        m[m == 255] = -1
        return self._finish_img(img), m


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
    """Threaded batch loader yielding (imgs (B,H,W,3) f32, masks (B,H,W) int),
    in order (the train mode's shuffle comes with training).

    In testval mode images keep their own sizes; a batch stacks only when
    its shapes match, and raises otherwise, as the JAX loader does."""

    def __init__(self, dataset, batch_size: int, workers: int = 4, shard: int = 0,
                 num_shards: int = 1):
        self.ds = dataset
        self.bs = batch_size
        self.workers = max(1, workers)
        self.shard = shard
        self.num_shards = num_shards

    def _plan(self):
        idx = np.arange(len(self.ds))[self.shard::self.num_shards]
        if self.num_shards > 1:         # equal step counts on every host
            idx = idx[: len(self.ds) // self.num_shards]
        return [idx[i * self.bs:(i + 1) * self.bs]
                for i in range(math.ceil(len(idx) / self.bs))]

    def __len__(self):
        return len(self._plan())

    def _batch(self, index):
        items = [self.ds[i] for i in index]
        return (np.stack([it[0] for it in items], 0),
                np.stack([np.asarray(it[1]) for it in items], 0))

    def __iter__(self):
        batches = self._plan()
        return ordered_batches(len(batches), lambda bi: self._batch(batches[bi]),
                               self.workers)


# The factories take the JAX ones' arguments; ``crop_size`` belongs to the
# train and val modes, which raise.
def get_citys_loader(root="data/citys/", split="train", mode="train",
                     base_size=1024, crop_size=(1024, 512), batch_size=32,
                     workers=4, **kw):
    ds = CitySegmentation(root=root, split=split, mode=mode, base_size=base_size)
    return SegLoader(ds, batch_size, workers=workers, **kw)


def get_citysbdd_loader(root="data/citys/", split="train", mode="train",
                        base_size=1024, crop_size=(1024, 512), batch_size=32,
                        workers=4, **kw):
    """The Cityscapes + BDD100k mix (reference SegmentationDataset.py:236-324).
    BDD's frames are ``.jpg``, so a split holding one raises when it is
    built, and every frame read is a Cityscapes one: the loader is
    :class:`CitySegmentation`'s."""
    ds = CitySegmentation(root=root, split=split, mode=mode, base_size=base_size)
    return SegLoader(ds, batch_size, workers=workers, **kw)


def get_custom_loader(root="data/", split="train", mode="train",
                      base_size=1024, batch_size=32, workers=4, n_segcls=2, **kw):
    ds = CustomSegmentation(root=root, split=split, mode=mode, NUM_CLASS=n_segcls,
                            base_size=base_size)
    return SegLoader(ds, batch_size, workers=workers, **kw)
