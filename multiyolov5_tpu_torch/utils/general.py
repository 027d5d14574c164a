"""Run management helpers of the CLIs (counterpart of
``multiyolov5_tpu/utils/general.py``: ``set_logging``, ``increment_path``,
``get_latest_run``, ``colorstr``, ``one_cycle``, ``labels_to_class_weights``,
``labels_to_image_weights``, ``check_dataset``, ``clean_str``,
``check_file`` and ``print_mutation``, which writes its yaml as JSON:
JSON is YAML, so ``yaml.safe_load`` reads it, and the port needs no PyYAML),
and the helpers no entry point calls: ``check_requirements``,
``check_git_status`` (a no-op), ``copy_attr``, ``prune_params`` and
``sparsity`` (on the port's state dict).  ``check_imshow`` needs cv2's
windows and is not ported."""

from __future__ import annotations

import glob
import json
import logging
import math
import os
import re
from pathlib import Path

import numpy as np

logger = logging.getLogger("multiyolov5_tpu_torch")


def set_logging(rank: int = -1) -> None:
    logging.basicConfig(
        format="%(message)s",
        level=logging.INFO if rank in (-1, 0) else logging.WARN)


def increment_path(path, exist_ok: bool = False, sep: str = "") -> str:
    """runs/exp -> runs/exp{sep}2, ... (reference utils/general.py:594-604)."""
    path = Path(path)
    if (path.exists() and exist_ok) or (not path.exists()):
        return str(path)
    dirs = glob.glob(f"{path}{sep}*")
    matches = [re.search(rf"%s{sep}(\d+)" % re.escape(path.stem), d) for d in dirs]
    i = [int(m.groups()[0]) for m in matches if m]
    n = max(i) + 1 if i else 2
    return f"{path}{sep}{n}"


def get_latest_run(search_dir: str = ".") -> str:
    """The newest ``last*.npz`` / ``last*.pt`` under ``search_dir``, or ""."""
    last = glob.glob(f"{search_dir}/**/last*.npz", recursive=True) + \
        glob.glob(f"{search_dir}/**/last*.pt", recursive=True)
    return max(last, key=os.path.getctime) if last else ""


def colorstr(*input):
    *args, string = input if len(input) > 1 else ("blue", "bold", input[0])
    colors = {"black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
              "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
              "cyan": "\033[36m", "white": "\033[37m", "bright_black": "\033[90m",
              "bright_red": "\033[91m", "bright_green": "\033[92m",
              "bright_yellow": "\033[93m", "bright_blue": "\033[94m",
              "bright_magenta": "\033[95m", "bright_cyan": "\033[96m",
              "bright_white": "\033[97m", "end": "\033[0m", "bold": "\033[1m",
              "underline": "\033[4m"}
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


def one_cycle(y1: float = 0.0, y2: float = 1.0, steps: int = 100):
    """Cosine ramp y1->y2 (reference utils/general.py:186-188)."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def labels_to_class_weights(labels, nc: int = 80) -> np.ndarray:
    """Inverse-frequency class weights (reference utils/general.py:216-230)."""
    if len(labels) == 0:
        return np.zeros(nc)
    labels = np.concatenate(labels, 0)
    classes = labels[:, 0].astype(int)
    weights = np.bincount(classes, minlength=nc).astype(float)
    weights[weights == 0] = 1
    weights = 1 / weights
    weights /= weights.sum()
    return weights


def labels_to_image_weights(labels, nc: int = 80, class_weights=None) -> np.ndarray:
    """Each image's weight: its class counts against ``class_weights``."""
    if class_weights is None:
        class_weights = np.ones(nc)
    class_counts = np.array(
        [np.bincount(lb[:, 0].astype(int), minlength=nc) for lb in labels])
    return (class_weights.reshape(1, nc) * class_counts).sum(1)


def check_dataset(data: dict) -> None:
    """Every ``train`` / ``val`` path of the dataset dict exists (the
    reference's download is replaced by an error: no network)."""
    for k in ("train", "val"):
        if k in data and data[k]:
            paths = data[k] if isinstance(data[k], list) else [data[k]]
            for p in paths:
                if not os.path.exists(p):
                    raise FileNotFoundError(
                        f"dataset path missing: {p} (auto-download disabled)")


def clean_str(s: str) -> str:
    return re.sub(pattern="[|@#!¡·$€%&()=?¿^*;:,¨´><+]", repl="_", string=s)


def check_file(file: str) -> str:
    """``file`` itself, or the one file of that name under ``.``
    (reference utils/general.py:102-113)."""
    if not file or os.path.isfile(file):
        return file
    files = glob.glob("./**/" + file, recursive=True)
    if not files:
        raise FileNotFoundError(f"File Not Found: {file}")
    if len(files) != 1:
        raise ValueError(f"Multiple files match '{file}': {files}")
    return files[0]


def print_mutation(hyp: dict, results, yaml_file: str = "hyp_evolved.yaml",
                   evolve_txt: str = "evolve.txt", n_metrics: int = 5) -> None:
    """Log an evolution result, keep evolve.txt fitness-sorted (column 0
    fitness2; rows [fitness, P, R, mAP50, mAP, *hypers]) and write the best
    hyps to ``yaml_file`` (reference utils/general.py:528-556)."""
    keys = list(hyp.keys())
    print("evolved: " + ", ".join(f"{k}={hyp[k]:.4g}" for k in keys[:8]) + " ...")
    with open(evolve_txt, "a") as f:
        f.write(" ".join(f"{x:.5g}" for x in list(results) + [hyp[k] for k in keys])
                + "\n")
    x = np.unique(np.loadtxt(evolve_txt, ndmin=2), axis=0)
    x = x[np.argsort(-x[:, 0])]
    np.savetxt(evolve_txt, x, "%12.5g")
    best = {k: float(x[0, n_metrics + i]) for i, k in enumerate(keys)}
    with open(yaml_file, "w") as f:
        json.dump(best, f, indent=1)


def check_requirements(requirements=(), exclude=()) -> None:
    """Warn about each requirement that does not import (reference
    utils/general.py check_requirements; it installs nothing)."""
    import importlib

    for r in requirements:
        name = re.split(r"[<>=!]", r)[0].strip()
        if name in exclude:
            continue
        try:
            importlib.import_module(name)
        except ImportError:
            print(f"WARNING: requirement {r!r} not installed "
                  f"(auto-install disabled)")


def check_git_status() -> None:
    """No-op (the reference suggests a ``git pull``)."""
    return None


def copy_attr(a, b, include=(), exclude=()) -> None:
    """Copy attributes b -> a (reference utils/torch_utils.py copy_attr)."""
    for k, v in b.__dict__.items():
        if (include and k not in include) or k.startswith("_") or k in exclude:
            continue
        setattr(a, k, v)


def _quantile(a: np.ndarray, q: float) -> np.float32:
    """``jnp.quantile(a, q)`` of a float32 vector (linear interpolation, in
    float32 as the JAX package computes it on the CPU); the two order statistics by
    ``np.partition``, which holds at every zoo width (``torch.quantile``
    refuses more than 2^24 elements)."""
    n = a.size
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    lo = np.floor(pos)
    hi_w = np.float32(pos - lo)
    lo_w = np.float32(1) - hi_w
    i, j = int(min(max(lo, 0), n - 1)), int(min(max(np.ceil(pos), 0), n - 1))
    part = np.partition(a, (i, j))
    # XLA's CPU code fuses the high term: fma(high, w_high, low * w_low)
    low = np.float64(np.float32(part[i] * lo_w))
    return np.float32(np.float64(part[j]) * np.float64(hi_w) + low)


def prune_params(state_dict: dict, amount: float = 0.3) -> dict:
    """Magnitude pruning of conv weights (reference utils/torch_utils.py:171-179
    prune(); JAX multiyolov5_tpu/utils/general.py:169): a new state dict in
    which each 4-D ``.weight`` has its entries of |w| below the ``amount``
    quantile of its |w| zeroed."""
    import torch

    out = {}
    for k, v in state_dict.items():
        if k.endswith(".weight") and getattr(v, "ndim", 0) == 4:
            a = v.detach().abs().float()
            kth = _quantile(a.reshape(-1).cpu().numpy(), amount)
            out[k] = torch.where(a < float(kth), torch.zeros((), dtype=v.dtype), v)
        else:
            out[k] = v
    print(f"pruned conv weights to ~{amount:.0%} global sparsity "
          f"({sparsity(out):.3%} actual zeros)")
    return out


def sparsity(state_dict: dict) -> float:
    """The share of zeros over every tensor of ``state_dict``."""
    zeros = total = 0
    for v in state_dict.values():
        a = np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
        zeros += int((a == 0).sum())
        total += a.size
    return zeros / max(total, 1)
