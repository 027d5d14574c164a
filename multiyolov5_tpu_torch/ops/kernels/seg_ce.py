"""K6: fused x8 bilinear upsample + weighted softmax cross-entropy.

Counterpart of ``seg_ce_up8`` (multiyolov5_tpu/ops/pallas/seg_ce_kernel.py:256),
forward and backward.  The kernels are ``csrc/seg_ce.cu``; their design
notes are there.  :func:`seg_ce` is the loss the train step calls: on a CUDA
tensor it runs the forward kernel under a ``torch.autograd.Function`` whose
backward is the backward kernel; on a CPU tensor it runs the plain version,
:func:`seg_ce_plain`, with autograd's backward.  The kernels read the
logits channels last, (B, h, w, C) in memory, as the train step's seg head
leaves them; the wrapper takes (B, C, h, w) of either layout and returns
dz in z's.

Data parallelism: with a ``group`` (parallel/comm.py) each rank holds a
slice of the global batch and the loss is the global mean.  The forward
kernel returns ``stats = (loss, D)`` and the backward kernel scales by
``1 / stats[1]``, so the wrapper all-reduces ``D``, returns this rank's
term ``loss * max(D, 1) / max(D_global, 1)`` and hands the backward a
``stats`` whose ``[1]`` is ``D_global``: the kernels are unchanged.  The
plain version divides by the same global denominator.

:func:`plan` picks both launches' tiles, threads and shared memory on the
host from the tap tables (:func:`tile_ranges` says which label pixels a
tile walks, as the kernels compute it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .upsample_argmax import _bilinear_matrix

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 3 + [_I] * 6 + [_P] * 8 + [_I] * 6 + [_P] * 3 + [_I, _P]
_BWD_ARGTYPES = [_P] * 6 + [_I] * 6 + [_P] * 8 + [_I] * 7 + [_P, _I, _P]
MAX_THREADS = 160            # a CTA's threads (csrc/seg_ce.cu MAX_THREADS)
SMEM_LIMIT = 226 * 1024      # dynamic shared memory a CTA may take (SMEM_MAX)
FWD_CLASSES = (8, 20, 32)    # classes a forward thread holds, the kernel's instantiations
BWD_CLASSES = (4, 8, 10, 20)  # classes a backward thread takes
MAX_CLASSES = FWD_CLASSES[-1]
# Tiles in input cells, tried in order until one fits: forward (ti, tj),
# backward (ti, tj, class groups wanted).  Order: the fastest first at the
# train step's shapes on an H100 (PERF.md, prof_seg_ce_torch.py --sweep).
# The small tiles last take the widest resizes, whose label columns a tile
# would not fit in shared memory at 8 x 8.
FWD_PLANS = ((4, 32), (8, 16), (4, 16), (8, 32), (4, 8), (8, 8))
BWD_PLANS = ((8, 8, 2), (4, 16, 2), (8, 8, 1), (8, 16, 1), (4, 8, 2), (4, 8, 1), (8, 16, 2),
             (16, 8, 2), (4, 4, 1), (2, 2, 1), (1, 1, 1))


class Pass(NamedTuple):
    """One launch of a pass: a CTA a ``ti`` x ``tj`` tile of input cells
    (forward) or of dz (backward) of one image, ``groups`` groups of ``cb``
    classes a label column, ``cols`` the most label columns a tile walks,
    ``threads`` threads (a (group, column) item each, in turns past
    MAX_THREADS), ``smem`` bytes of dynamic shared memory, ``ctas`` CTAs."""
    ti: int
    tj: int
    cb: int
    groups: int
    cols: int
    threads: int
    smem: int
    ctas: int


class Plan(NamedTuple):
    fwd: Pass
    bwd: Pass


def tap_tables(n_in: int, n_out: int, dtype=np.float32) -> Tuple[np.ndarray, ...]:
    """The align-corners resize ``n_in -> n_out`` as 2-tap tables.

    Returns (lo (n_out,) int32: each output index's first input index,
    wt (n_out, 2) ``dtype``: its two weights, first (n_in,) int32: each input
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
    return (lo.astype(np.int32), wt.astype(dtype), first.astype(np.int32),
            count.astype(np.int32))


def tile_ranges(n_in: int, n_out: int, t: int, backward: bool) -> List[Tuple[int, int, int, int]]:
    """A pass's tiles along one axis, as csrc/seg_ce.cu computes them: (first
    input index, inputs, first label index, label end) per tile of ``t``.

    Backward: tiles of the n_in inputs (dz elements); its labels are those
    whose taps touch the tile.  Forward: tiles of the n_in - 1 cells between
    neighbouring inputs; its labels are those whose first tap lies in them."""
    _, _, first, count = tap_tables(n_in, n_out)
    end = first + count
    n = n_in if backward else n_in - 1
    out = []
    for i0 in range(0, n, t):
        k = min(t, n - i0)
        start = first[i0] if backward else first[i0 + 1]
        out.append((i0, k, int(start), int(end[i0 + k - 1])))
    return out


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(backward: bool, cp: int, ti: int, tj: int, cols: int) -> int:
    """Dynamic shared memory of one CTA, as csrc/seg_ce.cu make_layout counts
    it, with the classes padded to ``cp`` (the forward's cb, the backward's
    groups x cb): floats, the cp class weights; forward, the (ti + 1) x
    (tj + 1) x cp z tile; backward, two weights a label column, the (ti + 2)
    x (tj + 2) x cp z tile and the ti x cols x cp row partials."""
    if not backward:
        return 4 * (cp + (ti + 1) * (tj + 1) * cp)
    return 4 * (cp + 2 * cols + (ti + 2) * (tj + 2) * cp + ti * cols * cp)


def _pass(backward: bool, bsz: int, c: int, h: int, w: int, H: int, W: int, ti: int, tj: int,
          groups: int) -> Optional[Pass]:
    """The launch at one tile, or None where it does not fit."""
    cols = max(e - s for _, _, s, e in tile_ranges(w, W, tj, backward))
    rows_n = len(tile_ranges(h, H, ti, backward))
    cols_n = len(tile_ranges(w, W, tj, backward))
    if backward:
        want = -(-c // groups)
        cb = next((k for k in BWD_CLASSES if k >= want), BWD_CLASSES[-1])
        groups = -(-c // cb)
    else:
        cb, groups = next(k for k in FWD_CLASSES if k >= c), 1
    # a thread a (class group, label column) item, in turns past MAX_THREADS
    threads = min(_up(groups * cols, 32), MAX_THREADS)
    smem = smem_bytes(backward, cb * groups, ti, tj, cols)
    if smem > SMEM_LIMIT:
        return None
    return Pass(ti, tj, cb, groups, cols, threads, smem, bsz * rows_n * cols_n)


@functools.lru_cache(maxsize=64)
def plan(bsz: int, c: int, h: int, w: int, H: int, W: int, dtype: torch.dtype,
         fwd: Optional[Tuple[int, int]] = None,
         bwd: Optional[Tuple[int, int, int]] = None) -> Plan:
    """Both launches for (bsz, c, h, w) logits against (bsz, H, W) labels:
    the first of ``FWD_PLANS`` and of ``BWD_PLANS`` that fits (or the tile
    ``fwd`` = (ti, tj), ``bwd`` = (ti, tj, groups)).  Raises ValueError on a
    shape or tile the kernels do not take."""
    if dtype not in _DTYPES:
        raise ValueError(f"seg_ce: dtype {dtype}")
    if min(h, w, H, W) < 2:
        raise ValueError(f"seg_ce: resize {(h, w)} -> {(H, W)} needs >= 2 on both sides")
    if bsz < 1 or not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"seg_ce: batch {bsz}, {c} classes (kernel takes 1..{MAX_CLASSES})")
    picked = []
    for backward, tiles in ((False, [t + (1,) for t in ([fwd] if fwd else FWD_PLANS)]),
                            (True, [bwd] if bwd else BWD_PLANS)):
        p = next((q for q in (_pass(backward, bsz, c, h, w, H, W, *t) for t in tiles)
                  if q is not None), None)
        if p is None:
            raise ValueError(f"seg_ce: no {'backward' if backward else 'forward'} tile fits "
                             f"{c} classes at {(h, w)} -> {(H, W)}")
        picked.append(p)
    return Plan(*picked)


@functools.lru_cache(maxsize=64)
def _device_tables(h: int, w: int, H: int, W: int,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(hlo, hwt, hfirst, hcount, wlo, wwt, wfirst, wcount) on ``device``."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in (*tap_tables(h, H), *tap_tables(w, W)))


def seg_ce_plain(z: torch.Tensor, y: torch.Tensor, weight: Optional[torch.Tensor] = None,
                 ignore_index: int = -1, group=None) -> torch.Tensor:
    """Mean weighted CE of ``resize_bilinear(z, y.shape[1:])`` against ``y``:
    the sum of w[y] * nll over labels other than ``ignore_index``, over
    max(sum of their w[y], 1), so all-ignored labels give 0.  float32 math
    (float64 for float64 logits), the gradient reaches ``z`` by autograd in
    ``z``'s dtype.  With a ``group``, the sum is this rank's and the
    denominator the group's (module docstring)."""
    up = F.interpolate(z.to(torch.promote_types(z.dtype, torch.float32)),
                       size=tuple(y.shape[-2:]), mode="bilinear", align_corners=True)
    yl = y.long()
    valid = yl != ignore_index
    w = None if weight is None else weight.to(up.device, up.dtype)
    num = F.cross_entropy(up, yl, weight=w, ignore_index=ignore_index, reduction="sum")
    den = (valid.sum().to(up.dtype) if w is None
           else (w[torch.where(valid, yl, 0)] * valid).sum())
    if group is not None:
        den = group.sum(den)
    return num / den.clamp(min=1.0)


def _check(z: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> None:
    build.require(z.is_cuda and z.dim() == 4 and z.dtype in _DTYPES
                  and z.is_contiguous(memory_format=torch.channels_last),
                  "seg_ce: z must be a channels-last CUDA (B, C, h, w) float32/bfloat16")
    build.require(y.dtype == torch.int32 and y.is_contiguous() and y.dim() == 3
                  and y.shape[0] == z.shape[0] and y.device == z.device,
                  "seg_ce: y must be contiguous (B, H, W) int32 on z's device")
    build.require(w.dtype == torch.float32 and w.shape == (z.shape[1],)
                  and w.device == z.device, "seg_ce: weight must be (C,) float32")


def _plan_of(z: torch.Tensor, y: torch.Tensor, p: Optional[Plan]) -> Plan:
    return p if p is not None else plan(*z.shape[:2], *z.shape[2:], *y.shape[1:], z.dtype)


def seg_ce_forward(z: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   ignore_index: int = -1,
                   p: Optional[Plan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on channels-last z: (stats (2,) float32 = (loss,
    D), per-pixel logsumexp (B, H, W) float32) for int32 labels and a (C,)
    weight, under ``p`` (default: :func:`plan`'s)."""
    _check(z, y, w)
    bsz, c, h, wd = z.shape
    H, W = y.shape[1:]
    f = _plan_of(z, y, p).fwd
    lse = torch.empty(y.shape, dtype=torch.float32, device=z.device)
    partials = torch.empty((f.ctas, 2), dtype=torch.float32, device=z.device)
    stats = torch.empty(2, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        tabs = _device_tables(h, wd, H, W, z.device)
        fn = build.function("mk_seg_ce_fwd", _FWD_ARGTYPES)
        err = fn(build.ptr(z), build.ptr(y), build.ptr(w), bsz, c, h, wd, H, W,
                 *map(build.ptr, tabs), int(ignore_index), f.ti, f.tj, f.cb, f.cols, f.threads,
                 build.ptr(lse), build.ptr(partials), build.ptr(stats), _DTYPES[z.dtype],
                 build.stream_of(z))
    build.check(err, "seg_ce_forward")
    seg_ce_forward.launches += 1
    return stats, lse


def seg_ce_backward(z: torch.Tensor, y: torch.Tensor, w: torch.Tensor, lse: torch.Tensor,
                    stats: torch.Tensor, grad: torch.Tensor, ignore_index: int = -1,
                    p: Optional[Plan] = None) -> torch.Tensor:
    """The backward kernel: dz (z's shape, dtype and channels-last layout)
    for the upstream gradient ``grad`` (a float32 scalar on the device) of
    the forward's loss, under ``p`` (default: :func:`plan`'s)."""
    _check(z, y, w)
    build.require(lse.shape == y.shape and lse.dtype == torch.float32
                  and stats.shape == (2,) and grad.numel() == 1
                  and grad.dtype == torch.float32,
                  "seg_ce_backward: lse, stats and grad must come from the forward")
    bsz, c, h, wd = z.shape
    H, W = y.shape[1:]
    b = _plan_of(z, y, p).bwd
    dz = torch.empty_like(z, memory_format=torch.channels_last)
    with torch.cuda.device(z.device):
        tabs = _device_tables(h, wd, H, W, z.device)
        fn = build.function("mk_seg_ce_bwd", _BWD_ARGTYPES)
        err = fn(build.ptr(z), build.ptr(y), build.ptr(lse), build.ptr(w),
                 build.ptr(grad), build.ptr(stats), bsz, c, h, wd, H, W,
                 *map(build.ptr, tabs), int(ignore_index), b.ti, b.tj, b.cb, b.groups,
                 b.cols, b.threads, build.ptr(dz), _DTYPES[z.dtype], build.stream_of(z))
    build.check(err, "seg_ce_backward")
    seg_ce_backward.launches += 1
    return dz


seg_ce_forward.launches = 0
seg_ce_backward.launches = 0


def _global_stats(stats: torch.Tensor, group) -> torch.Tensor:
    """The forward kernel's ``(loss, D)`` of a rank's slice -> (its term of
    the global mean, D over ``group``): what the backward kernel reads."""
    d = stats[1]
    d_all = group.sum(d)
    return torch.stack([stats[0] * d.clamp(min=1.0) / d_all.clamp(min=1.0), d_all])


class _SegCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, y, w, ignore_index, group):
        zc = z.contiguous(memory_format=torch.channels_last)
        stats, lse = seg_ce_forward(zc, y, w, ignore_index)
        if group is not None:
            stats = _global_stats(stats, group)
        ctx.save_for_backward(zc, y, w, lse, stats)
        ctx.ignore_index = ignore_index
        ctx.copied = zc.data_ptr() != z.data_ptr()
        return stats[0]

    @staticmethod
    def backward(ctx, grad):
        z, y, w, lse, stats = ctx.saved_tensors
        dz = seg_ce_backward(z, y, w, lse, stats, grad.float().reshape(1),
                             ctx.ignore_index)
        return (dz.contiguous() if ctx.copied else dz), None, None, None, None


def seg_ce(z: torch.Tensor, y: torch.Tensor, weight: Optional[torch.Tensor] = None,
           ignore_index: int = -1, group=None) -> torch.Tensor:
    """K6 on a CUDA tensor, :func:`seg_ce_plain` on a CPU tensor.

    z: (B, C, h, w) 1/8-res logits (float32 or bfloat16; channels last, as
    the train step's seg head gives them, or any other strides at the cost
    of one copy, and dz then comes back contiguous); y: (B, H, W) integer
    labels, ``ignore_index`` where unlabelled; weight: optional (C,) class
    weights; group: the ranks whose slices make the global batch (None or
    a group of one: this batch alone).  Returns the float32 scalar loss."""
    if group is not None and group.size == 1:
        group = None
    if not build.on_device(z, "seg_ce"):
        return seg_ce_plain(z, y, weight, ignore_index, group)
    y = y.to(device=z.device, dtype=torch.int32).contiguous()
    w = (torch.ones(z.shape[1], dtype=torch.float32, device=z.device) if weight is None
         else weight.to(z.device, torch.float32).contiguous())
    return _SegCE.apply(z, y, w, int(ignore_index), group)
