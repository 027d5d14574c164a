"""Cityscapes constants (counterpart of ``multiyolov5_tpu/data/cityscapes.py``,
a numpy copy): trainId color map, trainId->labelId map, names.

(reference detect.py:19-66; SegmentationDataset.py:165-189 id->trainId table.)
"""

from __future__ import annotations

import numpy as np

CITYSCAPES_COLORMAP = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [0, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32],
], dtype=np.uint8)

CITYSCAPES_IDMAP = np.array(
    [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33],
    dtype=np.uint8)

CITYSCAPES_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicyle",
]

# full labelId -> trainId lookup (reference SegmentationDataset.py:174-182):
# valid ids map to 0..18, everything else to -1 (ignore).
ID2TRAINID = np.full(256, -1, dtype=np.int64)
for train_id, label_id in enumerate(CITYSCAPES_IDMAP):
    ID2TRAINID[label_id] = train_id


def label2image(pred: np.ndarray, colormap: np.ndarray = CITYSCAPES_COLORMAP) -> np.ndarray:
    """trainId class map -> RGB color image (reference detect.py:69-72)."""
    return colormap[pred.astype(np.int32)]


def trainid2id(pred: np.ndarray, idmap: np.ndarray = CITYSCAPES_IDMAP) -> np.ndarray:
    """trainId class map -> Cityscapes labelId map for server submission
    (reference detect.py:74-77).  Returns (H, W, 1), which
    ``cv2.imwrite`` (and ``data/png.imwrite``) writes as a gray image."""
    cm = idmap.reshape(-1, 1)
    return cm[pred.astype(np.int32)]


def id2trainid(label: np.ndarray) -> np.ndarray:
    """labelId image -> trainId image with ignore=-1
    (reference SegmentationDataset.py:174-189 digitize equivalent)."""
    return ID2TRAINID[label.astype(np.int64)]
