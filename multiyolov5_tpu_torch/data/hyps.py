"""Hyperparameter presets (counterpart of ``multiyolov5_tpu/data/hyps.py``).

reference data/hyp.scratch.yaml / hyp.finetune.yaml; the fork lowers lr0 to
0.0015 (vs upstream 0.01) in its published recipe (reference README.md:88-92).
"""

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


def load_hyp(path_or_name):
    """A preset by name ("scratch", "finetune"), or a yaml file's entries
    over the scratch preset."""
    if path_or_name in (None, "scratch", "hyp.scratch", "hyp.scratch.yaml"):
        return dict(HYP_SCRATCH)
    if path_or_name in ("finetune", "hyp.finetune", "hyp.finetune.yaml"):
        return dict(HYP_FINETUNE)
    import yaml
    with open(path_or_name) as fh:
        hyp = yaml.safe_load(fh)
    return {**HYP_SCRATCH, **hyp}
