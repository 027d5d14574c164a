"""Folded stem weights (counterpart of ``multiyolov5_tpu/ops/stem.py``).

The YOLOv5 stem (Focus(3, c2, k=3) then Conv(c2, c2b, 3, s=2)) is rewritten
exactly on the 4x4 space-to-depth grid of a frame of c1 channels: conv1'
is a 3x3 conv 16*c1 -> 4*c2 whose output channel (P, co) holds phase P of
the Focus conv output, and conv2' is a 2x2 conv 4*c2 -> c2b with top/left padding 1.
The folded convs themselves run in kernel K1 (ops/kernels/stem.py).
The two functions here are pure numpy and equal the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# phase order of the space-to-depth: [ee, oe, eo, oo], H-offset first
_PHASE = {(0, 0): 0, (1, 0): 1, (0, 1): 2, (1, 1): 3}


def can_fold_stem(spec) -> bool:
    """True when rows 0/1 are the standard Focus(k=3) + Conv(k=3,s=2) stem
    and neither intermediate is consumed elsewhere."""
    if len(spec.rows) < 2:
        return False
    r0, r1 = spec.rows[0], spec.rows[1]
    return (r0.module == "Focus" and len(r0.args) >= 3 and r0.args[2] == 3
            and r1.module == "Conv" and len(r1.args) >= 4
            and r1.args[2] == 3 and r1.args[3] == 2
            and 0 not in spec.save and 1 not in spec.save)


def fold_stem_weights(w0, b0, w1, b1) -> Tuple[np.ndarray, ...]:
    """Derive the folded-stem weights from the fused stem weights.

    Args:
      w0: (3, 3, 4*c1, c2) HWIO Focus conv weight (input phase-stacked).
      b0: (c2,) fused bias.
      w1: (3, 3, c2, c2b) HWIO layer-1 conv weight (stride 2 originally).
      b1: (c2b,) fused bias.
    Returns:
      (w1p (3,3,16*c1,4*c2), b1p (4*c2,), w2p (2,2,4*c2,c2b), b2p (c2b,)).
    """
    w0 = np.asarray(w0, np.float32)
    w1 = np.asarray(w1, np.float32)
    k0, _, c12, c2 = w0.shape
    assert k0 == 3, k0
    _, _, c2_in, c2b = w1.shape
    assert c2_in == c2, (c2_in, c2)

    w1p = np.zeros((3, 3, 4 * c12, 4 * c2), np.float32)
    for p in (0, 1):
        for q in (0, 1):
            pout = _PHASE[(p, q)]
            for dy in range(3):
                du = 1 + (p + dy - 1) // 2
                pr = (p + dy - 1) % 2
                for dx in range(3):
                    dv = 1 + (q + dx - 1) // 2
                    qc = (q + dx - 1) % 2
                    pin = _PHASE[(pr, qc)]
                    w1p[du, dv, pin * c12:(pin + 1) * c12,
                        pout * c2:(pout + 1) * c2] += w0[dy, dx]
    b1p = np.tile(np.asarray(b0, np.float32), 4)

    w2p = np.zeros((2, 2, 4 * c2, c2b), np.float32)
    for dy in range(3):
        du = 1 + (dy - 1) // 2
        p = (dy - 1) % 2
        for dx in range(3):
            dv = 1 + (dx - 1) // 2
            q = (dx - 1) % 2
            pin = _PHASE[(p, q)]
            w2p[du, dv, pin * c2:(pin + 1) * c2] += w1[dy, dx]
    b2p = np.asarray(b1, np.float32)
    return w1p, b1p, w2p, b2p
