"""Run management helpers the app needs (counterpart of part of
``multiyolov5_tpu/utils/general.py``: ``set_logging``, ``increment_path``,
``clean_str``, :17-32 and :92)."""

from __future__ import annotations

import glob
import logging
import re
from pathlib import Path

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


def clean_str(s: str) -> str:
    return re.sub(pattern="[|@#!¡·$€%&()=?¿^*;:,¨´><+]", repl="_", string=s)
