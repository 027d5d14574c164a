"""Inference input sources (counterpart of ``multiyolov5_tpu/data/sources.py``;
reference utils/datasets.py:122-338).

``LoadImages`` reads PNG, JPEG, MPO, BMP, TIFF and WebP files, directories and
globs with the port's own codecs (``data/images.py``: ``cv2.imread``'s
pixels, the orientation applied where OpenCV applies it) and letterboxes each frame with
``data/letterbox.py`` (cv2's ``INTER_LINEAR`` in integer torch ops) on the
host, numpy in and out, as the JAX loader does with cv2.  What needs cv2
or another decoder raises ``NotImplementedError`` when the source is
built, naming what is missing: video files, ``LoadWebcam`` and
``LoadStreams`` (cv2's ``VideoCapture``), and DNG images.  No file
is skipped.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

from . import images as images_mod
from .letterbox import letterbox

IMG_FORMATS = ("bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo")
VID_FORMATS = ("mov", "avi", "mp4", "mpg", "mpeg", "m4v", "wmv", "mkv")


class LoadImages:
    """Yields (path, letterboxed RGB HWC uint8, img0 BGR, None)."""

    def __init__(self, path: str, img_size=640, stride: int = 32, auto: bool = False):
        p = str(Path(path).absolute())
        if "*" in p:
            files = sorted(glob.glob(p, recursive=True))
        elif os.path.isdir(p):
            files = sorted(glob.glob(os.path.join(p, "*.*")))
        elif os.path.isfile(p):
            files = [p]
        else:
            raise FileNotFoundError(f"{p} does not exist")
        images = [x for x in files if x.split(".")[-1].lower() in IMG_FORMATS]
        videos = [x for x in files if x.split(".")[-1].lower() in VID_FORMATS]
        if videos:
            raise NotImplementedError(
                f"video sources need cv2's VideoCapture, which the port does not use: {videos[0]}")
        images_mod.require_readable(images, "image source")
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        if not images:
            raise FileNotFoundError(f"no images found in {p}")
        self.files = images
        self.nf = len(images)

    def __iter__(self):
        self.count = 0
        return self

    def __next__(self):
        if self.count == self.nf:
            raise StopIteration
        path = self.files[self.count]
        self.count += 1
        img0 = images_mod.imread(path)  # BGR
        img = letterbox(img0, self.img_size, auto=self.auto, stride=self.stride)[0].numpy()
        img = img[:, :, ::-1]  # BGR -> RGB (HWC; the engine takes NHWC)
        return path, np.ascontiguousarray(img), img0, None

    def __len__(self):
        return self.nf


class LoadWebcam:
    """Local camera source: needs cv2's VideoCapture."""

    def __init__(self, pipe="0", img_size=640, stride=32):
        raise NotImplementedError("webcam sources need cv2's VideoCapture, "
                                  "which the port does not use")


class LoadStreams:
    """RTSP/HTTP streams: need cv2's VideoCapture."""

    def __init__(self, sources="streams.txt", img_size=640, stride=32):
        raise NotImplementedError("stream sources need cv2's VideoCapture, "
                                  "which the port does not use")
