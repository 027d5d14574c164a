"""K7: the whole fused C3 block (cv1, n Bottlenecks, cv2, split cv3).

Counterpart of ``c3_packed_pallas`` and ``c3_packed_pallas_hwbc``
(multiyolov5_tpu/ops/pallas/c3_kernel.py:391, :315), whose outputs are
equal.  The kernel is ``csrc/c3.cu``; its design notes are there.  The
plain version is the C3 module's own conv sequence on NHWC tensors, the
counterpart of ``_xla_c3`` in tests/test_c3_kernel.py.

Weights are OHWI, of the input's dtype; biases float32, BN folded:
``wcv1``/``wcv2`` (c_, 1, 1, c1), ``wcv3`` (c2, 1, 1, 2 c_), and ``mws`` a
sequence of (wb1 (c_, 1, 1, c_), bb1, wb2 (c_, 3, 3, c_), bb2), one per
bottleneck.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_void_p)] * 2
             + [ctypes.c_int] * 12 + [ctypes.c_void_p])
MAX_BOTTLENECKS = 4
SMEM_LIMIT = 227 * 1024
# (tile rows, tile cols, weight buffers), tried in order until one fits in
# shared memory; two buffers let a stage's weights load during the stage before
PLANS = ((8, 16, 2), (8, 16, 1), (8, 8, 2), (8, 8, 1), (4, 8, 1))

Bottleneck = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def c3_plain(x: torch.Tensor, wcv1: torch.Tensor, bcv1: torch.Tensor,
             wcv2: torch.Tensor, bcv2: torch.Tensor, wcv3: torch.Tensor,
             bcv3: torch.Tensor, mws: Sequence[Bottleneck],
             shortcut: bool = True) -> torch.Tensor:
    """x (B, H, W, c1) -> (B, H, W, c2), in x's dtype: the C3 module's five
    convs, concat and adds (each 3x3 zero-pads its own input)."""
    def cv(t, w, b, pad=0):
        return F.silu(F.conv2d(t, w.permute(0, 3, 1, 2).to(t.dtype), b.to(t.dtype),
                               padding=pad))

    xc = x.permute(0, 3, 1, 2)
    y1 = cv(xc, wcv1, bcv1)
    for wb1, bb1, wb2, bb2 in mws:
        t = cv(cv(y1, wb1, bb1), wb2, bb2, 1)
        y1 = y1 + t if shortcut else t
    y = cv(torch.cat([y1, cv(xc, wcv2, bcv2)], 1), wcv3, bcv3)
    return y.permute(0, 2, 3, 1)


def c3(x: torch.Tensor, wcv1: torch.Tensor, bcv1: torch.Tensor,
       wcv2: torch.Tensor, bcv2: torch.Tensor, wcv3: torch.Tensor,
       bcv3: torch.Tensor, mws: Sequence[Bottleneck],
       shortcut: bool = True) -> torch.Tensor:
    """K7 on a CUDA tensor, :func:`c3_plain` on a CPU tensor.

    Kernel inputs: x contiguous NHWC float32 or bfloat16, c1 % 16 == 0,
    c_ % 8 == 0, c2 % 8 == 0, 1 to 4 bottlenecks; weights contiguous OHWI of
    x's dtype, biases contiguous float32; x and weights 16-byte aligned."""
    if not build.on_device(x, "c3"):
        return c3_plain(x, wcv1, bcv1, wcv2, bcv2, wcv3, bcv3, mws, shortcut)
    build.require(x.dim() == 4 and x.is_contiguous() and x.dtype in _DTYPES,
                  f"c3: x must be contiguous NHWC float32 or bfloat16, got {x.dtype}")
    bsz, h, w, c1 = x.shape
    ch, c2, nb = wcv1.shape[0], wcv3.shape[0], len(mws)
    build.require(c1 % 16 == 0 and ch % 8 == 0 and c2 % 8 == 0,
                  f"c3: needs c1 % 16 == 0, c_ % 8 == 0 and c2 % 8 == 0, got {c1}, {ch}, {c2}")
    build.require(1 <= nb <= MAX_BOTTLENECKS, f"c3: {nb} bottlenecks")
    build.require(x.data_ptr() % 16 == 0, "c3: x is not 16-byte aligned")
    weights = [(wcv1, (ch, 1, 1, c1)), (wcv2, (ch, 1, 1, c1)), (wcv3, (c2, 1, 1, 2 * ch))]
    biases = [(bcv1, ch), (bcv2, ch), (bcv3, c2)]
    for wb1, bb1, wb2, bb2 in mws:
        weights += [(wb1, (ch, 1, 1, ch)), (wb2, (ch, 3, 3, ch))]
        biases += [(bb1, ch), (bb2, ch)]
    for t, shape in weights:
        build.require(tuple(t.shape) == shape and t.dtype == x.dtype
                      and t.is_contiguous() and t.device == x.device
                      and t.data_ptr() % 16 == 0,
                      f"c3: weight {tuple(t.shape)} {t.dtype}, want {shape} {x.dtype}")
    for t, n in biases:
        build.require(tuple(t.shape) == (n,) and t.dtype == torch.float32
                      and t.is_contiguous() and t.device == x.device,
                      f"c3: bias {tuple(t.shape)} {t.dtype}, want ({n},) float32")
    dt = _DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        smem = build.function("mk_c3_smem_bytes", [ctypes.c_int] * 8)
        plan = next((p for p in PLANS if smem(c1, ch, c2, nb, *p, dt) <= SMEM_LIMIT), None)
        build.require(plan is not None, f"c3: widths {c1}, {ch}, {c2} with {nb} "
                      "bottlenecks do not fit in shared memory")
        y = torch.empty((bsz, h, w, c2), dtype=x.dtype, device=x.device)
        wp = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t, _ in weights))
        bp = (ctypes.c_void_p * len(biases))(*(t.data_ptr() for t, _ in biases))
        fn = build.function("mk_c3", _ARGTYPES)
        err = fn(build.ptr(x), build.ptr(y), wp, bp, bsz, h, w, c1, ch, c2, nb,
                 int(shortcut), *plan, dt, build.stream_of(x))
    build.check(err, "c3")
    c3.launches += 1
    return y


c3.launches = 0
