"""Hyperparameter presets (counterpart of ``multiyolov5_tpu/data/hyps.py``).

reference data/hyp.scratch.yaml / hyp.finetune.yaml; the fork lowers lr0 to
0.0015 (vs upstream 0.01) in its published recipe (reference README.md:88-92).
"""

import json

HYP_SCRATCH = {
    "lr0": 0.0015,
    "lrf": 0.2,
    "momentum": 0.937,
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
    "box": 0.05,
    "cls": 0.5,
    "cls_pw": 1.0,
    "obj": 1.0,
    "obj_pw": 1.0,
    "iou_t": 0.20,
    "anchor_t": 4.0,
    "fl_gamma": 0.0,
    "label_smoothing": 0.0,
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mixup": 0.0,
}

HYP_FINETUNE = {
    **HYP_SCRATCH,
    "lr0": 0.0032,
    "lrf": 0.12,
    "momentum": 0.843,
    "weight_decay": 0.00036,
    "warmup_epochs": 2.0,
    "warmup_momentum": 0.5,
    "warmup_bias_lr": 0.05,
    "box": 0.0296,
    "cls": 0.243,
    "cls_pw": 0.631,
    "obj": 0.301,
    "obj_pw": 0.911,
    "anchor_t": 2.91,
    "fl_gamma": 0.0,
    "hsv_h": 0.0138,
    "hsv_s": 0.664,
    "hsv_v": 0.464,
    "degrees": 0.373,
    "translate": 0.245,
    "scale": 0.898,
    "shear": 0.602,
    "perspective": 0.0,
    "flipud": 0.00856,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mixup": 0.243,
}


# Evolution bounds: (mutation gain, min, max) per hyper
# (reference train.py:640-668 meta dict)
EVOLVE_META = {
    "lr0": (1, 1e-5, 1e-1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
}


def read_yaml(path: str):
    """A yaml file's contents.  JSON (which is YAML) is read without PyYAML,
    which the card's machine need not have."""
    with open(path) as fh:
        text = fh.read()
    try:
        return json.loads(text)
    except ValueError:
        import yaml
        return yaml.safe_load(text)


def load_hyp(path_or_name):
    """A preset by name ("scratch", "finetune"), or a yaml (or JSON) file's
    entries over the scratch preset."""
    if path_or_name in (None, "scratch", "hyp.scratch", "hyp.scratch.yaml"):
        return dict(HYP_SCRATCH)
    if path_or_name in ("finetune", "hyp.finetune", "hyp.finetune.yaml"):
        return dict(HYP_FINETUNE)
    return {**HYP_SCRATCH, **read_yaml(path_or_name)}
