"""K7: the whole fused C3 block (cv1, n Bottlenecks, cv2, split cv3).

Counterpart of ``c3_packed_pallas`` and ``c3_packed_pallas_hwbc``
(multiyolov5_tpu/ops/pallas/c3_kernel.py:391, :315), whose outputs are
equal.  The kernel is ``csrc/c3.cu``; its design notes are there.  Both
types run on the tensor cores: bfloat16 as bf16 products in persistent
CTAs, one an SM, that keep the block's weights in shared memory and load
each tile's input slab by TMA (``c3_bf16``), float32 as 3xTF32 in a CTA a tile
(``c3_tf32``: three TF32 products a multiply-add, float32 sums).  The
plain version is the C3 module's own conv sequence on NHWC tensors, the
counterpart of ``_xla_c3`` in tests/test_c3_kernel.py.

:func:`plan` picks a launch's tile, buffers and grid on the host from
:func:`smem_bytes`, the kernel's shared-memory layout in Python.

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
from .conv3x3 import SMS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_void_p)] * 2
             + [ctypes.c_int] * 14 + [ctypes.c_void_p])
MAX_BOTTLENECKS = 4
SMEM_LIMIT = 227 * 1024
BF16_STATIC = 16          # the bf16 form's static shared memory (its mbarrier, as ptxas counts it)
# float32: (tile rows, tile cols, weight buffers, weight rows), tried in
# order until one fits in shared memory.  Two buffers let a step's weights
# load during the step before; a stage runs in passes of `weight rows`
# output channels, each over its own rows of weights (0: one pass).  The
# order is the fastest first at eval's and pspv5m's shapes on an H100
# (PERF.md, prof_c3_torch.py --sweep).  A 16x16 tile has 8x32's work on a
# smaller slab (and 8x8 has 4x16's), so the wider tile of each pair is
# never picked.
# bfloat16: (tile rows, tile cols, 1, 0): one x slab, every stage's weights
# in shared memory, one persistent CTA an SM.  The order is the sweep's at
# pspv5s's and pspv5m's bs8 shapes on an H100 (PERF.md): 16x16 at pspv5s;
# 8x8 at pspv5m, whose weights leave no room for a larger tile.
PLANS = {torch.bfloat16: ((16, 16, 1, 0), (8, 16, 1, 0), (8, 8, 1, 0), (4, 8, 1, 0)),
         torch.float32: ((16, 16, 1, 0), (8, 16, 2, 0), (8, 16, 1, 32), (8, 16, 1, 16),
                         (8, 8, 1, 0), (4, 8, 1, 0), (4, 8, 1, 16))}


class Plan(NamedTuple):
    """One K7 launch: ``th`` x ``tw`` output tiles, ``smem`` bytes of
    dynamic shared memory a CTA, a grid of ``ctas``.  float32: a CTA a tile,
    ``nbuf`` weight buffers of ``rows`` rows (0: a whole stage's).
    bfloat16: ``nbuf`` 1 and ``rows`` 0, each of the ``ctas`` persistent
    CTAs (one an SM) taking every ``ctas``-th tile."""
    th: int
    tw: int
    nbuf: int
    rows: int
    smem: int
    ctas: int


def _up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _x_chunk(c1: int) -> int:
    """Channels of one TMA box of the bf16 form's x slab."""
    return 64 if c1 % 64 == 0 else 32 if c1 % 32 == 0 else 16


def smem_bytes(c1: int, ch: int, c2: int, nb: int, th: int, tw: int, nbuf: int, rows: int,
               dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA, as csrc/c3.cu make_layout counts
    it.  Both forms pad a row by 16 bytes and c_ to c_p (16 in bf16, 8 in
    float32), on a slab of (th + 2n) x (tw + 2n) pixels.

    float32: x's slab (rows of c1 + 4), A's slab, the bottleneck 1x1's
    output on A's slab (in x's rows where c_p <= c1), cv2's output on the
    tile, and ``nbuf`` buffers of the largest step's weights (a stage's rows
    padded to 16, at most ``rows`` of them unless 0, each row 16 bytes
    longer than its taps x c_in).

    bfloat16 (``nbuf`` 1, ``rows`` 0): 1024 bytes to align to, x's slab
    (dense rows of KC = 64, 32 or 16 channels, c1 / KC chunks of them, each
    chunk's elements rounded up to 512), A's slab (rows of c_p + 8), the
    1x1's output on the slab or y's staging tile (rows of c2 + 8), whichever
    is larger, cv2's output on the tile, and every stage's weights (rows of
    taps x c_in + 8; c_p rows, cv3 c2 rounded to 16)."""
    s = (th + 2 * nb) * (tw + 2 * nb)
    if dtype == torch.bfloat16:
        if rows or nbuf != 1:
            raise ValueError("c3: the bf16 form keeps one x slab and every stage's weights "
                             "(nbuf 1, rows 0)")
        cp, kc = _up(ch, 16), _x_chunk(c1)
        pa, tile = cp + 8, th * tw
        xbufs = (c1 // kc) * _up(s * kc, 512)
        weights = (2 * cp * (c1 + 8) + _up(c2, 16) * (2 * cp + 8)
                   + nb * cp * (cp + 8 + 9 * cp + 8))
        return 2 * (xbufs + s * pa + max(s * pa, tile * (c2 + 8)) + tile * pa + weights) + 1024
    pad = 4
    cp = _up(ch, 8)

    def r(n):
        return min(_up(n, 16), rows) if rows else _up(n, 16)

    wsize = _up(max(r(cp) * (c1 + pad), r(c2) * (2 * cp + pad), r(cp) * (9 * cp + pad)), 8)
    slab_a = _up(s * (cp + pad), 8)
    off_b2 = _up(s * (c1 + pad), 8) + (1 if cp <= c1 else 2) * slab_a
    return (off_b2 + _up(th * tw * (cp + pad), 8) + nbuf * wsize) * 4


def fits(smem: int, dtype: torch.dtype) -> bool:
    """Whether ``smem`` bytes of dynamic shared memory fit beside the
    form's static shared memory."""
    return smem <= SMEM_LIMIT - (BF16_STATIC if dtype == torch.bfloat16 else 0)


def plan(bsz: int, h: int, w: int, c1: int, ch: int, c2: int, nb: int,
         dtype: torch.dtype, sms: int = SMS) -> Plan:
    """The first of ``PLANS[dtype]`` whose layout fits in shared memory, for
    a (bsz, h, w, c1) input on a card of ``sms`` SMs.  Raises ValueError on
    a shape the kernel does not take."""
    if dtype not in PLANS:
        raise ValueError(f"c3: dtype {dtype}")
    if c1 % 16 or ch % 8 or c2 % 8 or min(bsz, h, w, c1, ch, c2) < 1:
        raise ValueError(f"c3: needs c1 % 16 == 0, c_ % 8 == 0 and c2 % 8 == 0, "
                         f"got {c1}, {ch}, {c2}")
    if not 1 <= nb <= MAX_BOTTLENECKS:
        raise ValueError(f"c3: {nb} bottlenecks")
    for th, tw, nbuf, rows in PLANS[dtype]:
        smem = smem_bytes(c1, ch, c2, nb, th, tw, nbuf, rows, dtype)
        if fits(smem, dtype):
            tiles = bsz * -(-h // th) * -(-w // tw)
            if dtype == torch.bfloat16:
                return Plan(th, tw, nbuf, rows, smem, min(tiles, sms))
            return Plan(th, tw, nbuf, rows, smem, tiles)
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
    p = plan(bsz, h, w, c1, ch, c2, nb, x.dtype,
             torch.cuda.get_device_properties(x.device).multi_processor_count)
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
                 int(shortcut), p.th, p.tw, p.nbuf, p.rows, p.ctas, _DTYPES[x.dtype],
                 build.stream_of(x))
    build.check(err, "c3")
    c3.launches += 1
    return y


c3.launches = 0
