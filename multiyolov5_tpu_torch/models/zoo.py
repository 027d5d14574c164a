"""Built-in model configurations (counterpart of ``multiyolov5_tpu/models/zoo.py``).

Every entry of the JAX package's zoo, under the same names: the seg+det
models ``yolov5{s,m,l,x}_city_seg`` (PSP head), ``yolov5m_citybdd``,
``yolov5s_custom_seg`` and the seg-head variants
``yolov5s_city_seg_{base,bise,lab}``; the detection-only
``yolov5{s,m,l,x}`` (80 classes); and the 4-level P6/64 ``yolov5{s,m,l,x}6``.
They encode the reference yaml files (models/yolov5s_city_seg.yaml,
models/hub/yolov5s6.yaml, ...) as plain Python dicts.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

_COCO_ANCHORS = [
    [10, 13, 16, 30, 33, 23],       # P3/8
    [30, 61, 62, 45, 59, 119],      # P4/16
    [116, 90, 156, 198, 373, 326],  # P5/32
]


def _v5_backbone():
    # CSPDarknet: Focus stem, alternating stride-2 Conv / C3 stages, SPP.
    return [
        [-1, 1, "Focus", [64, 3]],        # 0  P1/2
        [-1, 1, "Conv", [128, 3, 2]],     # 1  P2/4
        [-1, 3, "C3", [128]],             # 2
        [-1, 1, "Conv", [256, 3, 2]],     # 3  P3/8
        [-1, 9, "C3", [256]],             # 4
        [-1, 1, "Conv", [512, 3, 2]],     # 5  P4/16
        [-1, 9, "C3", [512]],             # 6
        [-1, 1, "Conv", [1024, 3, 2]],    # 7  P5/32
        [-1, 1, "SPP", [1024, [5, 9, 13]]],  # 8
        [-1, 3, "C3", [1024, False]],     # 9
    ]


def _v5_pan():
    # PAN neck rows 10-22: top-down then bottom-up, concat fusion.
    return [
        [-1, 1, "Conv", [512, 1, 1]],                  # 10
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 11
        [[-1, 6], 1, "Concat", [1]],                   # 12
        [-1, 3, "C3", [512, False]],                   # 13
        [-1, 1, "Conv", [256, 1, 1]],                  # 14
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 15
        [[-1, 4], 1, "Concat", [1]],                   # 16
        [-1, 3, "C3", [256, False]],                   # 17  P3/8
        [-1, 1, "Conv", [256, 3, 2]],                  # 18
        [[-1, 14], 1, "Concat", [1]],                  # 19
        [-1, 3, "C3", [512, False]],                   # 20  P4/16
        [-1, 1, "Conv", [512, 3, 2]],                  # 21
        [[-1, 10], 1, "Concat", [1]],                  # 22
    ]


def _seg_det_model(nc: int, n_segcls: int, gd: float, gw: float,
                   seg_head: str = "SegMaskPSP") -> Dict[str, Any]:
    head = _v5_pan()
    head.append([-1, 3, "C3", [1024, False]])  # 23  P5/32
    if seg_head == "SegMaskBase":
        head.append([[16], 1, "SegMaskBase", ["n_segcls", 3, 512, False]])  # 24
    elif seg_head == "SegMaskLab":
        head.append([[4, 19], 1, "SegMaskLab", ["n_segcls", 3, 256, False]])  # 24
    else:
        head.append([[16, 19, 22], 1, seg_head, ["n_segcls", 3, 256, False]])  # 24
    head.append([[17, 20, 23], 1, "Detect", ["nc", "anchors"]])  # 25 (must be last)
    return {
        "nc": nc,
        "n_segcls": n_segcls,
        "depth_multiple": gd,
        "width_multiple": gw,
        "anchors": copy.deepcopy(_COCO_ANCHORS),
        "backbone": _v5_backbone(),
        "head": head,
    }


def _det_model(nc: int, gd: float, gw: float) -> Dict[str, Any]:
    head = _v5_pan()
    head.append([-1, 3, "C3", [1024, False]])  # 23
    head.append([[17, 20, 23], 1, "Detect", ["nc", "anchors"]])  # 24
    return {
        "nc": nc,
        "depth_multiple": gd,
        "width_multiple": gw,
        "anchors": copy.deepcopy(_COCO_ANCHORS),
        "backbone": _v5_backbone(),
        "head": head,
    }


def _det_model_p6(nc: int, gd: float, gw: float) -> Dict[str, Any]:
    """4-level P6/64 detection model (reference models/hub/yolov5s6.yaml)."""
    backbone = [
        [-1, 1, "Focus", [64, 3]],         # 0  P1/2
        [-1, 1, "Conv", [128, 3, 2]],      # 1  P2/4
        [-1, 3, "C3", [128]],              # 2
        [-1, 1, "Conv", [256, 3, 2]],      # 3  P3/8
        [-1, 9, "C3", [256]],              # 4
        [-1, 1, "Conv", [512, 3, 2]],      # 5  P4/16
        [-1, 9, "C3", [512]],              # 6
        [-1, 1, "Conv", [768, 3, 2]],      # 7  P5/32
        [-1, 3, "C3", [768]],              # 8
        [-1, 1, "Conv", [1024, 3, 2]],     # 9  P6/64
        [-1, 1, "SPP", [1024, [3, 5, 7]]], # 10
        [-1, 3, "C3", [1024, False]],      # 11
    ]
    head = [
        [-1, 1, "Conv", [768, 1, 1]],                    # 12
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 13
        [[-1, 8], 1, "Concat", [1]],                     # 14
        [-1, 3, "C3", [768, False]],                     # 15
        [-1, 1, "Conv", [512, 1, 1]],                    # 16
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 17
        [[-1, 6], 1, "Concat", [1]],                     # 18
        [-1, 3, "C3", [512, False]],                     # 19
        [-1, 1, "Conv", [256, 1, 1]],                    # 20
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 21
        [[-1, 4], 1, "Concat", [1]],                     # 22
        [-1, 3, "C3", [256, False]],                     # 23  P3/8
        [-1, 1, "Conv", [256, 3, 2]],                    # 24
        [[-1, 20], 1, "Concat", [1]],                    # 25
        [-1, 3, "C3", [512, False]],                     # 26  P4/16
        [-1, 1, "Conv", [512, 3, 2]],                    # 27
        [[-1, 16], 1, "Concat", [1]],                    # 28
        [-1, 3, "C3", [768, False]],                     # 29  P5/32
        [-1, 1, "Conv", [768, 3, 2]],                    # 30
        [[-1, 12], 1, "Concat", [1]],                    # 31
        [-1, 3, "C3", [1024, False]],                    # 32  P6/64
        [[23, 26, 29, 32], 1, "Detect", ["nc", "anchors"]],
    ]
    return {
        "nc": nc,
        "depth_multiple": gd,
        "width_multiple": gw,
        "anchors": [
            [19, 27, 44, 40, 38, 94],
            [96, 68, 86, 152, 180, 137],
            [140, 301, 303, 264, 238, 542],
            [436, 615, 739, 380, 925, 792],
        ],
        "backbone": backbone,
        "head": head,
    }


_GAINS = {"s": (0.33, 0.50), "m": (0.67, 0.75), "l": (1.0, 1.0), "x": (1.33, 1.25)}

_ZOO: Dict[str, Any] = {}
for _sz, (_gd, _gw) in _GAINS.items():
    _ZOO[f"yolov5{_sz}_city_seg"] = _seg_det_model(10, 19, _gd, _gw)
    _ZOO[f"yolov5{_sz}"] = _det_model(80, _gd, _gw)
    _ZOO[f"yolov5{_sz}6"] = _det_model_p6(80, _gd, _gw)
_ZOO["yolov5m_citybdd"] = _seg_det_model(5, 19, *_GAINS["m"])
_ZOO["yolov5s_custom_seg"] = _seg_det_model(1, 2, *_GAINS["s"])
# seg-head variants of the s model (BASELINE.json configs #2-#4)
for _h, _tag in (("SegMaskBase", "base"), ("SegMaskBiSe", "bise"), ("SegMaskLab", "lab")):
    _ZOO[f"yolov5s_city_seg_{_tag}"] = _seg_det_model(10, 19, *_GAINS["s"], seg_head=_h)


def get(name: str) -> Dict[str, Any]:
    if name not in _ZOO:
        raise KeyError(f"unknown model config {name!r}; available: {sorted(_ZOO)}")
    return copy.deepcopy(_ZOO[name])


def available() -> list:
    return sorted(_ZOO)
