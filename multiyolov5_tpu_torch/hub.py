"""Hub-style model factories and an input-robust inference wrapper
(counterpart of ``multiyolov5_tpu/hub.py``; reference hubconf.py:22-119 and
models/common.py:605-765 autoShape / Detections).

``create`` builds a zoo model (the ten factories below name it), on the
card by default; ``classes`` other than 80 rebuilds the Detect head and
copies in the ``pretrained`` tensors whose names and shapes match.
Weights are the port's native ``.npz`` or a reference ``.pt``
(utils/checkpoint.load_checkpoint).  ``AutoShape`` takes PNG and JPEG
paths (PNG, JPEG, MPO, BMP, TIFF or WebP, read by ``data/images.py`` as
PIL's ``convert("RGB")`` reads them, no EXIF orientation applied but a
TIFF's, a WebP animation's first frame; DNG raises ``NotImplementedError``
naming the file),
numpy HWC, CHW and
2-D gray arrays, and PIL images where PIL imports; it letterboxes every
image to one shape on the engine's device and runs each group of
same-size images as one batched ``Engine`` call.  ``Detections`` holds the
boxes and class maps: ``print``, ``render``, ``save`` (``<name>.jpg``
files as PIL's ``save`` writes them, ``data/jpeg.py`` ``pil_save``),
``tolist``, ``pandas`` (where pandas imports); ``show``
raises, as the card's machine has no display.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from .data import images, jpeg
from .data.letterbox import letterbox
from .engine import Engine
from .models.config import load_spec
from .models.model import seeded_state_dict
from .utils.boxes import xyxy2xywh
from .utils.checkpoint import intersect_load, load_checkpoint
from .utils.general import increment_path
from .utils.plots import color_list, plot_one_box


def create(name: str, pretrained: Optional[str] = None, channels: int = 3,
           classes: int = 80, autoshape: bool = True, *,
           device: Union[str, torch.device] = "cuda", half: bool = True):
    """Build a model by zoo or hub-config name on ``device``; optionally
    load weights and wrap it in :class:`AutoShape` (reference
    hubconf.py:22-48).  The default ``channels`` (3) and ``classes`` (80, or
    None) keep the config and load ``pretrained`` whole; any other values
    rebuild the model for them (a seeded init) and copy in the
    ``pretrained`` tensors whose names and shapes match.  A model of other
    than 3 channels serves (B, H, W, ``channels``) frames through
    ``Engine`` (K1 reads them); :class:`AutoShape`, which makes 3-channel
    images, refuses it."""
    if channels == 3 and classes in (80, None):
        eng = Engine(pretrained if pretrained and os.path.exists(pretrained) else None,
                     cfg=name, device=device, half=half)
        return AutoShape(eng) if autoshape else eng
    spec = load_spec(name, ch=channels, nc=classes or 80)
    sd = seeded_state_dict(spec, 0)
    if pretrained and os.path.exists(pretrained):
        sd, _ = intersect_load(sd, load_checkpoint(pretrained)[1])
    eng = Engine(spec=spec, state_dict=sd, device=device, half=half)
    return AutoShape(eng) if autoshape else eng


def custom(path_or_model: str, autoshape: bool = True, *,
           device: Union[str, torch.device] = "cuda", half: bool = True):
    """Load a custom checkpoint (reference hubconf.py custom())."""
    eng = Engine(path_or_model, device=device, half=half)
    return AutoShape(eng) if autoshape else eng


def _factory(name):
    def f(pretrained=None, channels=3, classes=None, autoshape=True, **kw):
        return create(name, pretrained, channels, classes or 80, autoshape, **kw)
    f.__name__ = name
    return f


yolov5s = _factory("yolov5s")
yolov5m = _factory("yolov5m")
yolov5l = _factory("yolov5l")
yolov5x = _factory("yolov5x")
yolov5s6 = _factory("yolov5s6")
yolov5m6 = _factory("yolov5m6")
yolov5l6 = _factory("yolov5l6")
yolov5x6 = _factory("yolov5x6")
yolov5s_city_seg = _factory("yolov5s_city_seg")
yolov5m_city_seg = _factory("yolov5m_city_seg")


def _pil_image_class():
    """PIL's ``Image.Image`` where PIL imports, else None."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image.Image


class AutoShape:
    """Input-robust wrapper (reference models/common.py:605-672).  It makes
    3-channel RGB images of what it is given, so a model built for other
    channels raises ``ValueError`` at the call, before anything is read or
    launched (the JAX wrapper fails inside the model's stem)."""

    conf = 0.25
    iou = 0.45
    classes = None

    def __init__(self, engine: Engine):
        self.engine = engine
        self.names = engine.names

    def __call__(self, imgs, size: int = 640, augment: bool = False):
        ch = self.engine.spec.ch_in
        if ch != 3:
            raise ValueError(f"AutoShape makes 3-channel images; the model takes {ch} "
                             "channels: call its Engine on (B, H, W, "
                             f"{ch}) frames instead")
        pil_image = _pil_image_class()
        n, items = (len(imgs), list(imgs)) if isinstance(imgs, list) else (1, [imgs])
        images.require_readable([im for im in items if isinstance(im, (str, os.PathLike))],
                                "hub input")
        shape0, files, loaded = [], [], []
        for i, im in enumerate(items):
            f = f"image{i}"
            if isinstance(im, (str, os.PathLike)):
                f = str(im)
                im = images.read_rgb(f)
            elif pil_image is not None and isinstance(im, pil_image):
                f = getattr(im, "filename", f) or f
                im = np.asarray(im.convert("RGB"))
            im = np.asarray(im)
            if im.shape[0] < 5:  # CHW -> HWC
                im = im.transpose(1, 2, 0)
            im = im[:, :, :3] if im.ndim == 3 else np.tile(im[:, :, None], 3)
            files.append(Path(f).with_suffix(".jpg").name)
            shape0.append(im.shape[:2])
            loaded.append(im)
        stride = self.engine.stride
        g = [size / max(s) for s in shape0]
        shape1 = np.ceil(np.array(
            [[s[0] * gi, s[1] * gi] for s, gi in zip(shape0, g)]).max(0)
            / stride).astype(int) * stride
        batch = torch.stack([letterbox(np.ascontiguousarray(im), tuple(shape1), auto=False,
                                       device=self.engine.device)[0] for im in loaded], 0)

        # one batched Engine call a group of same-size images: the unmap
        # is per original shape (reference autoShape's one forward,
        # common.py:649)
        dets_all: list = [None] * n
        masks_all: list = [None] * n
        groups: dict = {}
        for i, s in enumerate(shape0):
            groups.setdefault(tuple(s), []).append(i)
        for s, idxs in groups.items():
            d, m = self.engine(batch[idxs], s, conf=self.conf, iou=self.iou,
                               classes=self.classes, augment=augment)
            for j, i in enumerate(idxs):
                dets_all[i] = d[j]
                masks_all[i] = m[j]
        return Detections(loaded, dets_all, files, names=self.names, masks=masks_all)


class Detections:
    """Result container (reference models/common.py:675-752)."""

    def __init__(self, imgs, pred, files, names=None, masks=None):
        self.imgs = imgs
        self.pred = pred
        self.files = files
        self.names = names or []
        self.masks = masks
        gn = [np.array([im.shape[1], im.shape[0], im.shape[1], im.shape[0],
                        1.0, 1.0]) for im in imgs]
        self.xyxy = pred
        self.xywh = [np.concatenate([xyxy2xywh(x[:, :4]), x[:, 4:]], 1)
                     if len(x) else x for x in pred]
        self.xyxyn = [x / g if len(x) else x for x, g in zip(self.xyxy, gn)]
        self.xywhn = [x / g if len(x) else x for x, g in zip(self.xywh, gn)]
        self.n = len(pred)

    def display(self, pprint=False, save=False, render=False, save_dir=""):
        colors = color_list()
        for i, (img, pred) in enumerate(zip(self.imgs, self.pred)):
            s = f"image {i + 1}/{self.n}: {img.shape[0]}x{img.shape[1]} "
            if pred is not None and len(pred):
                for c in np.unique(pred[:, -1]):
                    nc_ = int((pred[:, -1] == c).sum())
                    s += f"{nc_} {self.names[int(c)]}{'s' * (nc_ > 1)}, "
                if save or render:
                    img = np.ascontiguousarray(img)
                    for *box, conf, cls in pred:
                        label = f"{self.names[int(cls)]} {conf:.2f}"
                        plot_one_box(box, img, label=label, color=colors[int(cls) % 10])
                    self.imgs[i] = img
            if pprint:
                print(s.rstrip(", "))
            if save:
                Path(save_dir).mkdir(parents=True, exist_ok=True)
                jpeg.pil_save(str(Path(save_dir) / self.files[i]), self.imgs[i].astype(np.uint8))

    def print(self):
        self.display(pprint=True)

    def show(self):
        raise NotImplementedError("show needs a display (PIL's Image.show); use save or render")

    def save(self, save_dir="runs/hub/exp"):
        """Write each image with its boxes drawn as ``save_dir/<name>.jpg``."""
        save_dir = increment_path(save_dir, exist_ok=save_dir != "runs/hub/exp")
        self.display(save=True, save_dir=save_dir)

    def render(self):
        self.display(render=True)
        return self.imgs

    def pandas(self):
        try:
            import pandas as pd
        except ImportError as e:
            raise NotImplementedError("Detections.pandas needs pandas, which is not "
                                      "installed") from e
        new = copy.copy(self)
        ca = "xmin", "ymin", "xmax", "ymax", "confidence", "class", "name"
        cb = "xcenter", "ycenter", "width", "height", "confidence", "class", "name"
        for k, c in zip(["xyxy", "xyxyn", "xywh", "xywhn"], [ca, ca, cb, cb]):
            a = [[list(x[:5]) + [int(x[5]), self.names[int(x[5])]]
                  for x in arr.tolist()] for arr in getattr(self, k)]
            setattr(new, k, [pd.DataFrame(x, columns=c) for x in a])
        return new

    def tolist(self):
        return [Detections([self.imgs[i]], [self.pred[i]], [self.files[i]], self.names,
                           [self.masks[i]] if self.masks else None)
                for i in range(self.n)]

    def __len__(self):
        return self.n
