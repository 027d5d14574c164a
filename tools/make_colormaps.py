"""Writes ``multiyolov5_tpu_torch/utils/colormaps.npz``: matplotlib's
``viridis``, ``Blues`` and ``tab10`` colormaps as uint8 RGB tables, so the
port's charts (``utils/charts.py``) colour their scatters, 2-D histograms
and heatmaps as matplotlib does, without it.

    python tools/make_colormaps.py

Needs matplotlib (the port does not).  ``viridis`` and ``Blues`` are read at
their 256 entries, ``tab10`` at its 10; each entry is ``round(255 * c)``
of the colormap's float RGB, as matplotlib's Agg writes a colour.
"""

from __future__ import annotations

import os
import sys

import numpy as np
from matplotlib import colormaps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "multiyolov5_tpu_torch", "utils", "colormaps.npz")
NAMES = ("viridis", "Blues", "tab10")


def table(name: str) -> np.ndarray:
    cmap = colormaps[name]
    rgb = cmap(np.arange(cmap.N))[:, :3]
    return np.round(rgb * 255).astype(np.uint8)


def main() -> int:
    np.savez_compressed(OUT, **{n: table(n) for n in NAMES})
    print(f"wrote {os.path.relpath(OUT, ROOT)} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
