"""K6: fused x8 bilinear upsample + weighted softmax cross-entropy.

Counterpart of ``seg_ce_up8`` (multiyolov5_tpu/ops/pallas/seg_ce_kernel.py:256),
forward and backward.  The kernels are ``csrc/seg_ce.cu``; their design
notes are there.  :func:`seg_ce` is the loss the train step calls: on a CUDA
tensor it runs the forward kernel under a ``torch.autograd.Function`` whose
backward is the backward kernel; on a CPU tensor it runs the plain version,
:func:`seg_ce_plain`, with autograd's backward.  Unlike the JAX function,
the logits are planar (B, C, h, w), the seg head's own layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .upsample_argmax import _bilinear_matrix

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P, _P, _P] + [_I] * 6 + [_P] * 4 + [_I] + [_P] * 3 + [_I, _P]
_BWD_ARGTYPES = [_P] * 6 + [_I] * 6 + [_P] * 8 + [_I, _P, _I, _P]
FWD_THREADS = 256          # label pixels per forward block (csrc/seg_ce.cu)


def tap_tables(n_in: int, n_out: int) -> Tuple[np.ndarray, ...]:
    """The align-corners resize ``n_in -> n_out`` as 2-tap tables.

    Returns (lo (n_out,) int32: each output index's first input index,
    wt (n_out, 2) float32: its two weights, first (n_in,) int32: each input
    index's first output index whose taps touch it, count (n_in,) int32: how
    many do).  The weights come from the float64 matrix of
    ``F.interpolate(bilinear, align_corners=True)``."""
    if n_in < 2 or n_out < 2:
        raise ValueError(f"seg_ce: resize {n_in} -> {n_out} needs >= 2 on both sides")
    m = _bilinear_matrix(n_in, n_out)
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.minimum(np.floor(src).astype(np.int64), n_in - 2)
    rows = np.arange(n_out)
    wt = np.stack([m[rows, lo], m[rows, lo + 1]], 1)
    idx = np.arange(n_in)
    first = np.searchsorted(lo, idx - 1, side="left")
    count = np.searchsorted(lo, idx, side="right") - first
    return (lo.astype(np.int32), wt.astype(np.float32), first.astype(np.int32),
            count.astype(np.int32))


@functools.lru_cache(maxsize=64)
def _device_tables(h: int, w: int, H: int, W: int,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(hlo, hwt, hfirst, hcount, wlo, wwt, wfirst, wcount) on ``device``."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in (*tap_tables(h, H), *tap_tables(w, W)))


def seg_ce_plain(z: torch.Tensor, y: torch.Tensor, weight: Optional[torch.Tensor] = None,
                 ignore_index: int = -1) -> torch.Tensor:
    """Mean weighted CE of ``resize_bilinear(z, y.shape[1:])`` against ``y``:
    the sum of w[y] * nll over labels other than ``ignore_index``, over
    max(sum of their w[y], 1), so all-ignored labels give 0.  float32 math,
    the gradient reaches ``z`` by autograd in ``z``'s dtype."""
    up = F.interpolate(z.float(), size=tuple(y.shape[-2:]), mode="bilinear",
                       align_corners=True)
    yl = y.long()
    valid = yl != ignore_index
    w = None if weight is None else weight.to(up.device, torch.float32)
    num = F.cross_entropy(up, yl, weight=w, ignore_index=ignore_index, reduction="sum")
    den = (valid.sum().float() if w is None
           else (w[torch.where(valid, yl, 0)] * valid).sum())
    return num / den.clamp(min=1.0)


def _check(z: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> None:
    build.require(z.is_cuda and z.dim() == 4 and z.is_contiguous() and z.dtype in _DTYPES,
                  "seg_ce: z must be a contiguous CUDA (B, C, h, w) float32/bfloat16")
    build.require(y.dtype == torch.int32 and y.is_contiguous() and y.dim() == 3
                  and y.shape[0] == z.shape[0] and y.device == z.device,
                  "seg_ce: y must be contiguous (B, H, W) int32 on z's device")
    build.require(w.dtype == torch.float32 and w.shape == (z.shape[1],)
                  and w.device == z.device, "seg_ce: weight must be (C,) float32")


def seg_ce_forward(z: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   ignore_index: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (stats (2,) float32 = (loss, D), per-pixel
    logsumexp (B, H, W) float32) for int32 labels and a (C,) weight."""
    _check(z, y, w)
    bsz, c, h, wd = z.shape
    H, W = y.shape[1:]
    hlo, hwt, _, _, wlo, wwt, _, _ = _device_tables(h, wd, H, W, z.device)
    lse = torch.empty(y.shape, dtype=torch.float32, device=z.device)
    partials = torch.empty((bsz * H * -(-W // FWD_THREADS), 2), dtype=torch.float32,
                           device=z.device)
    stats = torch.empty(2, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        fn = build.function("mk_seg_ce_fwd", _FWD_ARGTYPES)
        err = fn(build.ptr(z), build.ptr(y), build.ptr(w), bsz, c, h, wd, H, W,
                 build.ptr(hlo), build.ptr(hwt), build.ptr(wlo), build.ptr(wwt),
                 int(ignore_index), build.ptr(lse), build.ptr(partials),
                 build.ptr(stats), _DTYPES[z.dtype], build.stream_of(z))
    build.check(err, "seg_ce_forward")
    seg_ce_forward.launches += 1
    return stats, lse


def seg_ce_backward(z: torch.Tensor, y: torch.Tensor, w: torch.Tensor, lse: torch.Tensor,
                    stats: torch.Tensor, grad: torch.Tensor,
                    ignore_index: int = -1) -> torch.Tensor:
    """The backward kernel: dz (z's shape and dtype) for the upstream
    gradient ``grad`` (a float32 scalar on the device) of the forward's loss."""
    _check(z, y, w)
    build.require(lse.shape == y.shape and lse.dtype == torch.float32
                  and stats.shape == (2,) and grad.numel() == 1
                  and grad.dtype == torch.float32,
                  "seg_ce_backward: lse, stats and grad must come from the forward")
    bsz, c, h, wd = z.shape
    H, W = y.shape[1:]
    tabs = _device_tables(h, wd, H, W, z.device)
    dz = torch.empty_like(z)
    with torch.cuda.device(z.device):
        fn = build.function("mk_seg_ce_bwd", _BWD_ARGTYPES)
        err = fn(build.ptr(z), build.ptr(y), build.ptr(lse), build.ptr(w),
                 build.ptr(grad), build.ptr(stats), bsz, c, h, wd, H, W,
                 *map(build.ptr, tabs), int(ignore_index), build.ptr(dz),
                 _DTYPES[z.dtype], build.stream_of(z))
    build.check(err, "seg_ce_backward")
    seg_ce_backward.launches += 1
    return dz


seg_ce_forward.launches = 0
seg_ce_backward.launches = 0


class _SegCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, y, w, ignore_index):
        stats, lse = seg_ce_forward(z, y, w, ignore_index)
        ctx.save_for_backward(z, y, w, lse, stats)
        ctx.ignore_index = ignore_index
        return stats[0]

    @staticmethod
    def backward(ctx, grad):
        z, y, w, lse, stats = ctx.saved_tensors
        dz = seg_ce_backward(z, y, w, lse, stats, grad.float().reshape(1),
                             ctx.ignore_index)
        return dz, None, None, None


def seg_ce(z: torch.Tensor, y: torch.Tensor, weight: Optional[torch.Tensor] = None,
           ignore_index: int = -1) -> torch.Tensor:
    """K6 on a CUDA tensor, :func:`seg_ce_plain` on a CPU tensor.

    z: (B, C, h, w) 1/8-res logits (any strides; float32 or bfloat16);
    y: (B, H, W) integer labels, ``ignore_index`` where unlabelled; weight:
    optional (C,) class weights.  Returns the float32 scalar loss."""
    if not build.on_device(z, "seg_ce"):
        return seg_ce_plain(z, y, weight, ignore_index)
    z = z.contiguous()
    y = y.to(device=z.device, dtype=torch.int32).contiguous()
    w = (torch.ones(z.shape[1], dtype=torch.float32, device=z.device) if weight is None
         else weight.to(z.device, torch.float32).contiguous())
    return _SegCE.apply(z, y, w, int(ignore_index))
