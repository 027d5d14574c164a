"""K4: fused (chained) bilinear upsample + channel argmax -> uint8 class map.

Counterpart of ``upsample_argmax_planar``
(multiyolov5_tpu/ops/pallas/upsample_argmax_kernel.py:309).  The kernel is
``csrc/upsample_argmax.cu``; its design notes are there.  The plain version
is the chained resize + argmax that the JAX package runs off the TPU
(upsample_argmax_kernel.py:340-346), computed in float32.

:func:`plan` picks the launch on the host from the band tables: the output
tile a CTA owns, the run of columns a thread owns, the class chunk and the
input window the CTA stages (:func:`windows` computes the window as the
kernel reads it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .conv3x3 import SMS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ([_P] + [_I] * 4 + [_P, _P, _I] * 2 + [_I, _I, _P, _I] + [_I] * 9 + [_P])
MAX_TAPS = 8
MAX_CLASSES = 256            # the class map is uint8
MAX_THREADS = 256            # a CTA's threads (csrc/upsample_argmax.cu MAX_THREADS)
SMEM_LIMIT = 227 * 1024      # dynamic shared memory a CTA may take
SMEM_BUDGET = 64 * 1024      # the class chunk is cut to keep a CTA under this
# (run, span) pairs the kernel is instantiated for: a thread's run of output
# columns and the input columns it may span
SPANS = {16: (4,), 8: (4, 8), 4: (8,), 1: (8,)}
# Tile families (columns, run, rows from the most): the first family whose
# runs' taps fit one of the run's spans is taken, with the most rows a CTA
# (in passes over one staged window and one set of column weights) that
# still gives FILL CTAs an SM, else its fewest.  Runs of 16 are the fastest
# at the paths' shapes on an H100 (PERF.md, prof_mask_torch.py --sweep: bs1
# takes 32 rows, bs4 and bs8 64); shorter runs take the wider bands of
# other resizes, and the last family any band of <= MAX_TAPS.
PLANS = ((256, 16, (64, 32, 16)), (256, 8, (16, 8)), (256, 4, (4,)), (32, 1, (8,)))
TILES = tuple((tr, tc, run) for tc, run, trs in PLANS for tr in trs)   # (rows, columns, run)
FILL = 1.75


class Plan(NamedTuple):
    """One K4 launch: CTAs of ``tr`` x ``tc`` output pixels of one image,
    ``threads`` threads (a run of ``run`` columns each, its taps within
    ``span`` input columns; the tile's rows in passes of threads x run / tc),
    ``cb`` classes a chunk, a staged window of ``wr`` input rows x ``wx``
    columns, ``smem`` bytes, ``ctas`` CTAs."""
    tr: int
    tc: int
    run: int
    span: int
    cb: int
    wr: int
    wx: int
    threads: int
    smem: int
    ctas: int


def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 matrix of F.interpolate(bilinear, align_corners=True)."""
    m = np.zeros((n_out, n_in), np.float64)
    if n_in == 1:
        m[:, 0] = 1.0
        return m
    src = (np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
           if n_out > 1 else np.zeros((1,)))
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 2)
    frac = src - i0
    rows = np.arange(n_out)
    m[rows, i0] = 1.0 - frac
    m[rows, i0 + 1] += frac
    return m


@functools.lru_cache(maxsize=64)
def band_tables(n_in: int, n_out: int, via: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (n_out, n_in) map ``resize(via -> n_out) . resize(n_in -> via)``
    composed in float64, as per-row (first column, float32 band weights),
    both read-only (they are cached)."""
    m = _bilinear_matrix(via, n_out) @ _bilinear_matrix(n_in, via)
    nz = m != 0
    lo = nz.argmax(1)
    hi = n_in - 1 - nz[:, ::-1].argmax(1)
    taps = int((hi - lo).max()) + 1
    lo = np.minimum(lo, n_in - taps)
    w = np.take_along_axis(m, lo[:, None] + np.arange(taps)[None], 1)
    lo, w = lo.astype(np.int32), w.astype(np.float32)
    lo.setflags(write=False)
    w.setflags(write=False)
    return lo, w


def tiles(n_out: int, t: int) -> List[Tuple[int, int]]:
    """(first output index, outputs) of each tile of ``t`` along an axis,
    the last one ragged."""
    return [(i, min(t, n_out - i)) for i in range(0, n_out, t)]


def windows(lo: np.ndarray, taps: int, t: int, run: int = 1) -> Tuple[int, int, int]:
    """Along one axis, for tiles of ``t`` outputs cut in runs of ``run``:
    (the input indices a tile's taps reach from its first output's first
    tap, the most input indices one run's taps span, the furthest a run's
    first tap lies from its tile's)."""
    extent = span = offset = 0
    for i, k in tiles(lo.shape[0], t):
        extent = max(extent, int(lo[i + k - 1]) + taps - int(lo[i]))
        for j in range(i, i + k, run):
            e = min(j + run, i + k) - 1
            span = max(span, int(lo[e]) + taps - int(lo[j]))
            offset = max(offset, int(lo[j]) - int(lo[i]))
    return extent, span, offset


def smem_bytes(tr: int, th: int, cb: int, wr: int, wx: int) -> int:
    """Dynamic shared memory of one CTA, as csrc/upsample_argmax.cu
    smem_bytes counts it: each tile row's first input row and ``th``
    weights and the (cb, wr, wx) staged window, 4 bytes each."""
    return 4 * (tr * (1 + th) + cb * wr * wx)


def _tile(bsz: int, c: int, h: int, w: int, out_hw: Tuple[int, int], hlo, th: int, wlo,
          tw: int, tr: int, tc: int, run: int) -> Optional[Plan]:
    """The launch at one tile, or None where its runs' taps fit no span."""
    threads = min(MAX_THREADS, tr * tc // run)
    if (run not in SPANS or tc % run or threads % 32 or threads % (tc // run)
            or tr % (threads // (tc // run))):
        raise ValueError(f"upsample_argmax: tile {(tr, tc, run)}")
    wr = windows(hlo, th, tr)[0]
    cols, need, offset = windows(wlo, tw, tc, run)
    span = next((s for s in SPANS[run] if s >= need), None)
    if span is None:
        return None
    wx = max(cols, offset + span)     # a run reads span columns from its first tap
    per_class = 4 * wr * wx
    fixed = 4 * tr * (1 + th)
    cb = min(c, max(1, (SMEM_BUDGET - fixed) // per_class))
    smem = smem_bytes(tr, th, cb, wr, wx)
    if smem > SMEM_LIMIT:
        return None
    ctas = bsz * len(tiles(out_hw[0], tr)) * len(tiles(out_hw[1], tc))
    return Plan(tr, tc, run, span, cb, wr, wx, threads, smem, ctas)


@functools.lru_cache(maxsize=256)
def plan(bsz: int, c: int, h: int, w: int, out_hw: Tuple[int, int],
         via_hw: Tuple[int, int],
         tile: Optional[Tuple[int, int, int]] = None) -> Plan:
    """The launch for (bsz, c, h, w) logits resized through ``via_hw`` to
    ``out_hw``: in the first family of ``PLANS`` whose runs' taps fit one of
    the run's spans, the most rows a CTA that still gives ``FILL`` CTAs an
    SM (or the tile ``tile`` = (rows, columns, run)), with the classes in
    chunks that keep a CTA under ``SMEM_BUDGET`` (all of them where they
    fit).  Raises ValueError on a shape or tile the kernel does not take."""
    H0, W0 = out_hw
    if bsz < 1 or not 1 <= c <= MAX_CLASSES or min(h, w, H0, W0) < 1:
        raise ValueError(f"upsample_argmax: ({bsz}, {c}, {h}, {w}) -> {out_hw} "
                         f"(1..{MAX_CLASSES} classes)")
    hlo, hw = band_tables(h, H0, via_hw[0])
    wlo, ww = band_tables(w, W0, via_hw[1])
    th, tw = hw.shape[1], ww.shape[1]
    if max(th, tw) > MAX_TAPS:
        raise ValueError(f"upsample_argmax: bands of {th} x {tw} taps (kernel takes "
                         f"<= {MAX_TAPS})")
    geo = (bsz, c, h, w, out_hw, hlo, th, wlo, tw)
    if tile is not None:
        p = _tile(*geo, *tile)
        if p is None:
            raise ValueError(f"upsample_argmax: tile {tile} does not fit {out_hw}")
        return p
    for tc, run, trs in PLANS:
        fits = [p for p in (_tile(*geo, tr, tc, run) for tr in trs) if p is not None]
        if fits:
            return next((p for p in fits if p.ctas >= FILL * SMS), fits[-1])
    raise ValueError(f"upsample_argmax: no tile fits ({c}, {h}, {w}) -> {out_hw}")


def dense_weights(lo: np.ndarray, wts: np.ndarray, run: int, span: int) -> np.ndarray:
    """The column weights as the kernel's threads read them: output column
    j's band spread over the ``span`` input columns from its run's first
    column's first tap (zero outside the band, and past the last column),
    as (run, span, runs) float32, runs = ceil(n_out / run), so that
    neighbouring runs sit side by side."""
    n_out, taps = wts.shape
    runs = -(-n_out // run)
    j = np.arange(n_out)
    d = lo - lo[j // run * run]
    if d.max(initial=0) + taps > span:
        raise ValueError(f"upsample_argmax: a run of {run} spans more than {span} columns")
    dense = np.zeros((runs * run, span), np.float32)
    for k in range(taps):
        dense[j, d + k] = wts[:, k]
    return np.ascontiguousarray(dense.reshape(runs, run, span).transpose(1, 2, 0))


@functools.lru_cache(maxsize=64)
def _device_tables(h: int, w: int, out_hw: Tuple[int, int], via_hw: Tuple[int, int],
                   run: int, span: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(hlo, hw, wlo, dense column weights) on ``device``, built once per
    geometry and run."""
    hlo, hw = band_tables(h, out_hw[0], via_hw[0])
    wlo, ww = band_tables(w, out_hw[1], via_hw[1])
    return tuple(torch.from_numpy(np.array(a)).to(device)
                 for a in (hlo, hw, wlo, dense_weights(wlo, ww, run, span)))


def upsample_argmax_plain(x: torch.Tensor, out_hw, via_hw) -> torch.Tensor:
    """x (B, C, h, w) -> (B, H0, W0) uint8: float32 align-corners bilinear
    resize to ``via_hw`` (the seg head's x8), then to ``out_hw`` (the
    frame), argmax over classes."""
    y = x.float()
    for hw in (via_hw, out_hw):
        y = F.interpolate(y, size=tuple(hw), mode="bilinear", align_corners=True)
    return y.argmax(1).to(torch.uint8)


def launch(x: torch.Tensor, out_hw, via_hw, p: Optional[Plan] = None) -> torch.Tensor:
    """One K4 launch on a CUDA tensor, with the plan ``p`` or :func:`plan`'s."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    via_hw = (int(via_hw[0]), int(via_hw[1]))
    build.require(x.dim() == 4 and x.is_contiguous() and x.dtype in _DTYPES
                  and x.device.type == "cuda",
                  "upsample_argmax: x must be contiguous (B, C, h, w) float32/bfloat16 "
                  "on the card")
    bsz, c, h, w = x.shape
    build.require(c <= MAX_CLASSES, f"upsample_argmax: {c} classes do not fit uint8")
    p = p or plan(bsz, c, h, w, out_hw, via_hw)
    hlo, hw, wlo, wdt = _device_tables(h, w, out_hw, via_hw, p.run, p.span, x.device)
    tw = band_tables(w, out_hw[1], via_hw[1])[1].shape[1]
    out = torch.empty((bsz, *out_hw), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        fn = build.function("mk_upsample_argmax", _ARGTYPES)
        err = fn(build.ptr(x), bsz, c, h, w, build.ptr(hlo), build.ptr(hw),
                 hw.shape[1], build.ptr(wlo), build.ptr(wdt), tw,
                 out_hw[0], out_hw[1], build.ptr(out), _DTYPES[x.dtype], p.tr, p.tc,
                 p.run, p.span, p.cb, p.wr, p.wx, p.threads, p.smem, build.stream_of(x))
    build.check(err, f"upsample_argmax {p}")
    upsample_argmax.launches += 1
    return out


def upsample_argmax(x: torch.Tensor, out_hw, via_hw) -> torch.Tensor:
    """K4 on a CUDA tensor (planned by :func:`plan`),
    :func:`upsample_argmax_plain` on a CPU tensor."""
    if not build.on_device(x, "upsample_argmax"):
        return upsample_argmax_plain(x, out_hw, via_hw)
    return launch(x, out_hw, via_hw)


upsample_argmax.launches = 0
