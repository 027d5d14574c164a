"""K7: the whole fused C3 block (cv1, n Bottlenecks, cv2, split cv3).

Counterpart of ``c3_packed_pallas`` and ``c3_packed_pallas_hwbc``
(multiyolov5_tpu/ops/pallas/c3_kernel.py:391, :315), whose outputs are
equal.  The kernel is ``csrc/c3.cu``; its design notes are there.  Both
types run on the tensor cores with one warp tiling: bfloat16 as bf16
products (``c3_bf16``), float32 as 3xTF32 (``c3_tf32``: three TF32
products a multiply-add, float32 sums).  The plain version is the C3
module's own conv sequence on NHWC tensors, the counterpart of ``_xla_c3``
in tests/test_c3_kernel.py.

:func:`plan` picks a launch's tile, weight buffers and weight rows a pass
on the host from :func:`smem_bytes`, the kernel's shared-memory layout in
Python.

Weights are OHWI, of the input's dtype; biases float32, BN folded:
``wcv1``/``wcv2`` (c_, 1, 1, c1), ``wcv3`` (c2, 1, 1, 2 c_), and ``mws`` a
sequence of (wb1 (c_, 1, 1, c_), bb1, wb2 (c_, 3, 3, c_), bb2), one per
bottleneck.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_void_p)] * 2
             + [ctypes.c_int] * 13 + [ctypes.c_void_p])
MAX_BOTTLENECKS = 4
SMEM_LIMIT = 227 * 1024
# (tile rows, tile cols, weight buffers, weight rows), tried in order until
# one fits in shared memory.  Two buffers let a step's weights load during
# the step before; a stage runs in passes of `weight rows` output channels,
# each over its own rows of weights (0: one pass).  The float32 order is
# the fastest first at eval's and pspv5m's shapes on an H100 (PERF.md,
# prof_c3_torch.py --sweep).  A 16x16 tile has 8x32's work on a smaller
# slab (and 8x8 has 4x16's), so the wider tile of each pair is never picked.
PLANS = {torch.bfloat16: ((8, 16, 2, 0), (8, 16, 1, 0), (8, 8, 2, 0), (8, 8, 1, 0),
                          (4, 8, 1, 0)),
         torch.float32: ((16, 16, 1, 0), (8, 16, 2, 0), (8, 16, 1, 32), (8, 16, 1, 16),
                         (8, 8, 1, 0), (4, 8, 1, 0), (4, 8, 1, 16))}


class Plan(NamedTuple):
    """One K7 launch: a CTA a ``th`` x ``tw`` output tile of one image,
    ``nbuf`` weight buffers of ``rows`` rows (0: a whole stage's), ``smem``
    bytes of dynamic shared memory."""
    th: int
    tw: int
    nbuf: int
    rows: int
    smem: int
    ctas: int


def _up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def smem_bytes(c1: int, ch: int, c2: int, nb: int, th: int, tw: int, nbuf: int, rows: int,
               dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA, as csrc/c3.cu make_layout counts
    it: x's slab (rows of c1 + 16 bytes), A's slab, the bottleneck 1x1's
    output on A's slab (in x's rows where c_ <= c1), cv2's output on the
    tile, and ``nbuf`` buffers of the largest step's weights (a stage's
    rows padded to 16, at most ``rows`` of them unless 0, each row 16 bytes
    longer than its taps x c_in)."""
    es = 2 if dtype == torch.bfloat16 else 4
    pad = 16 // es
    s = (th + 2 * nb) * (tw + 2 * nb)
    cp = _up(ch, 16 if es == 2 else 8)

    def r(n):
        return min(_up(n, 16), rows) if rows else _up(n, 16)

    wsize = _up(max(r(cp) * (c1 + pad), r(c2) * (2 * cp + pad), r(cp) * (9 * cp + pad)), 8)
    slab_a = _up(s * (cp + pad), 8)
    off_b2 = _up(s * (c1 + pad), 8) + (1 if cp <= c1 else 2) * slab_a
    return (off_b2 + _up(th * tw * (cp + pad), 8) + nbuf * wsize) * es


def plan(bsz: int, h: int, w: int, c1: int, ch: int, c2: int, nb: int,
         dtype: torch.dtype) -> Plan:
    """The first of ``PLANS[dtype]`` whose layout fits in shared memory, for
    a (bsz, h, w, c1) input.  Raises ValueError on a shape the kernel does
    not take."""
    if dtype not in PLANS:
        raise ValueError(f"c3: dtype {dtype}")
    if c1 % 16 or ch % 8 or c2 % 8 or min(bsz, h, w, c1, ch, c2) < 1:
        raise ValueError(f"c3: needs c1 % 16 == 0, c_ % 8 == 0 and c2 % 8 == 0, "
                         f"got {c1}, {ch}, {c2}")
    if not 1 <= nb <= MAX_BOTTLENECKS:
        raise ValueError(f"c3: {nb} bottlenecks")
    for th, tw, nbuf, rows in PLANS[dtype]:
        smem = smem_bytes(c1, ch, c2, nb, th, tw, nbuf, rows, dtype)
        if smem <= SMEM_LIMIT:
            return Plan(th, tw, nbuf, rows, smem, bsz * -(-h // th) * -(-w // tw))
    raise ValueError(f"c3: widths {c1}, {ch}, {c2} with {nb} bottlenecks do not fit in "
                     "shared memory")


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
    p = plan(bsz, h, w, c1, ch, c2, nb, x.dtype)
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
    with torch.cuda.device(x.device):
        y = torch.empty((bsz, h, w, c2), dtype=x.dtype, device=x.device)
        wp = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t, _ in weights))
        bp = (ctypes.c_void_p * len(biases))(*(t.data_ptr() for t, _ in biases))
        fn = build.function("mk_c3", _ARGTYPES)
        err = fn(build.ptr(x), build.ptr(y), wp, bp, bsz, h, w, c1, ch, c2, nb,
                 int(shortcut), p.th, p.tw, p.nbuf, p.rows, _DTYPES[x.dtype],
                 build.stream_of(x))
    build.check(err, "c3")
    c3.launches += 1
    return y


c3.launches = 0
