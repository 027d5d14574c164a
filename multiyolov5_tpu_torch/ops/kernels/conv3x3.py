"""K2: NHWC 3x3 conv + bias (+ SiLU), stride 1/2, dilation 1/2/3.

Counterpart of ``conv3x3_silu_pallas`` / ``conv3x3s2_silu_pallas``
(multiyolov5_tpu/ops/pallas/conv3x3_kernel.py:98, :153) and
``conv3x3_packed_pallas`` (multiyolov5_tpu/ops/pallas/c3_kernel.py:270).
The kernel is ``csrc/conv3x3.cu``; its design notes are there.  :func:`plan`
picks its tile and its split of K over a thread-block cluster on the host.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + [ctypes.c_void_p]

SMS = 132           # streaming multiprocessors of an H100 SXM
MAX_SPLIT = 8       # CTAs a portable thread-block cluster may hold
# float32 splits K until the grid holds this many CTAs an SM: its 8x16 px x
# 64 ch and 8x8 px x 128 ch tiles fit two an SM (PERF.md)
F32_FILL = 1.75


class Plan(NamedTuple):
    """One K2 launch: a CTA computes a ``bm`` x ``bn`` output tile over
    ``k_steps`` (or one fewer) of the conv's ``9 * c_in / bk`` K steps; the
    ``split`` CTAs of a cluster share the K steps and sum their partial
    tiles through distributed shared memory.  The ``bm`` pixels are an 8 x
    ``bm / 8`` rectangle of one image."""
    bm: int
    bn: int
    bk: int
    split: int
    tiles: int
    ctas: int
    k_steps: int


def takes(c_in: int, c_out: int, stride: int = 1, dilation: int = 1) -> bool:
    """Whether K2 takes a 3x3 conv of these widths, stride and dilation:
    what :func:`plan` accepts of any shape.  Models decide their K2 sites
    by it when they are built."""
    return c_in % 16 == 0 and c_out % 8 == 0 and stride in (1, 2) and dilation in (1, 2, 3)


def plan(bsz: int, ho: int, wo: int, c_in: int, c_out: int, dtype: torch.dtype,
         stride: int = 1, dilation: int = 1) -> Plan:
    """The tile and split of K2 for a (bsz, ho, wo, c_out) output of a
    ``c_in``-channel input in ``dtype``.

    BK: 128-byte rows where c_in allows (bf16 64 channels, float32 32),
    else the next that divides c_in (down to 16 channels).

    bfloat16: a 128-pixel tile (8x16) with 128 channels, or else 64, where
    those tiles alone give one CTA an SM; otherwise a 64-pixel tile (8x8),
    with 128 channels where c_out is a multiple of 128 and that gives one
    CTA per two SMs, else 64.  Where the tiles are fewer than the SMs, K is
    split over the CTAs of a cluster until the grid reaches one CTA an SM:
    the least split that does or, where the grid stays within two CTAs an
    SM, the next that divides the K steps evenly.

    float32: 8x8 pixels x 128 channels where c_out is a multiple of 128,
    else 8x16 x 64 (8x8 x 64 where even the largest split of those leaves
    SMs without a CTA), and the least split of 1, 2, 4 or 8 whose grid
    holds ``F32_FILL`` CTAs an SM, else the largest.

    Splits are at most 8 and leave at least two K steps a CTA.  On the H100
    these were the fastest plans that fill the card at pspv5s's ten bs1
    sites in bf16, and at eval's bs4 and pspv5x's bs1 sites in float32
    (PERF.md).  Raises ValueError on a shape the kernel does not take."""
    if min(bsz, ho, wo, c_out) < 1:
        raise ValueError(f"conv3x3: empty output {(bsz, ho, wo, c_out)}")
    if dtype not in _DTYPES:
        raise ValueError(f"conv3x3: dtype {dtype}")
    if not takes(c_in, c_out, stride, dilation):
        raise ValueError(f"conv3x3: needs c_in % 16 == 0, c_out % 8 == 0, stride 1 or 2 "
                         f"and dilation 1-3, got {c_in}, {c_out}, {stride}, {dilation}")
    row = 128 // dtype.itemsize             # channels in a 128-byte row
    bk = next(k for k in (row, row // 2, row // 4) if c_in % k == 0)
    wide = c_out % 128 == 0
    nk = 9 * c_in // bk
    cap = max(1, min(MAX_SPLIT, nk // 2))

    def tiles(bm, bn):          # an 8 x bm/8 rectangle of one image x bn channels
        return bsz * math.ceil(ho / 8) * math.ceil(wo / (bm // 8)) * math.ceil(c_out / bn)

    if dtype == torch.float32:
        top = 1 << (cap.bit_length() - 1)   # the largest power-of-two split
        bm, bn = (64, 128) if wide else (128, 64)
        if tiles(bm, bn) * top < SMS:
            bm, bn = 64, 64
        n_tiles = tiles(bm, bn)
        split = next((s for s in (1, 2, 4, 8) if s <= top and n_tiles * s >= F32_FILL * SMS),
                     top)
    else:
        bm, bn = 64, 128 if wide and tiles(64, 128) >= SMS / 2 else 64
        for big in ((128, 128), (128, 64)):
            if (big[1] == 64 or wide) and tiles(*big) >= SMS:
                bm, bn = big
                break
        n_tiles = tiles(bm, bn)
        split = 1
        if n_tiles < SMS:
            least = min(cap, math.ceil(SMS / n_tiles))
            split = next((s for s in range(least, cap + 1)
                          if nk % s == 0 and n_tiles * s <= 2 * SMS), least)
    return Plan(bm, bn, bk, split, n_tiles, n_tiles * split, math.ceil(nk / split))


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  stride: int = 1, dilation: int = 1,
                  act: bool = True) -> torch.Tensor:
    """x (B, H, W, Ci), w (Co, 3, 3, Ci) OHWI, b (Co,) -> (B, Ho, Wo, Co),
    with torch autopad (pad = dilation)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2).to(x.dtype),
                 b.to(x.dtype), stride, dilation, dilation)
    if act:
        y = F.silu(y)
    return y.permute(0, 2, 3, 1)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int = 1, dilation: int = 1, act: bool = True) -> torch.Tensor:
    """K2 on a CUDA tensor, :func:`conv3x3_plain` on a CPU tensor.

    Kernel inputs: x contiguous NHWC float32 or bfloat16 with Ci % 16 == 0
    and Co % 8 == 0, w contiguous OHWI of x's dtype, b contiguous float32;
    :func:`plan` raises on any other shape."""
    if not build.on_device(x, "conv3x3"):
        return conv3x3_plain(x, w, b, stride, dilation, act)
    build.require(x.dim() == 4 and x.is_contiguous(), "conv3x3: x must be contiguous NHWC")
    bsz, h, wd, ci = x.shape
    build.require(x.dtype in _DTYPES, f"conv3x3: dtype {x.dtype}")
    co = w.shape[0]
    build.require(tuple(w.shape) == (co, 3, 3, ci) and w.is_contiguous()
                  and w.dtype == x.dtype and w.device == x.device,
                  f"conv3x3: weight {tuple(w.shape)} {w.dtype}")
    build.require(tuple(b.shape) == (co,) and b.dtype == torch.float32
                  and b.is_contiguous() and b.device == x.device,
                  "conv3x3: bias must be contiguous float32 (c_out,)")
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    return _launch(x, w, b, stride, dilation, act,
                   plan(bsz, ho, wo, ci, co, x.dtype, stride, dilation))


def _launch(x, w, b, stride, dilation, act, p: Plan) -> torch.Tensor:
    """One K2 launch with the plan ``p`` (checked arguments)."""
    bsz, h, wd, ci = x.shape
    co = w.shape[0]
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    y = torch.empty((bsz, ho, wo, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        fn = build.function("mk_conv3x3", _ARGTYPES)
        err = fn(build.ptr(x), build.ptr(w), build.ptr(b), build.ptr(y),
                 bsz, h, wd, ci, ho, wo, co, stride, dilation, int(act),
                 _DTYPES[x.dtype], p.bm, p.bn, p.bk, p.split, build.stream_of(x))
    build.check(err, "conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
