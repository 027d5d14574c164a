"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the seven Hopper kernels of ``multiyolov5_tpu_torch/csrc`` (K1 in two
modes), holds each against its plain PyTorch version at the shapes of the
paths, and drives five paths with seeded random weights (yolov5s_city_seg
unless named), on the card and, for reference, on the CPU:

* serving: ``Engine`` on three frames (K1-K4);
* batched serving: ``InferenceServer`` (max_batch 8, img_size 1024) on
  seeded 2048x1024 BGR frames from four client threads (K1, K2, K7, K5,
  K4), each result against ``Engine`` on the same letterboxed batch, the
  float32 server against a CPU server, and a pspv5m (yolov5m_city_seg) bs2
  forward against the CPU's;
* eval: ``evaluate_detection`` (multi-label NMS over up to 30000
  candidates, mAP; K1, K2, K5) and ``seg_validation`` (mIoU; K1, K2, K4)
  on two seeded bs4 batches letterboxed from 2048x1024;
* training: the dual-task train step (det bs8 832x832 + seg bs8 512x1024,
  SGD, EMA; K6 forward and backward), one float32 step against the CPU's,
  a scheduled 20-step bf16 run whose EMA checkpoint ``Engine`` serves;
  K6 prints its plan, whose byte counts ops/kernels/seg_ce.py must give as
  the kernels do, and on the steps' own arguments must give bitwise equal
  dz from two backward launches and bitwise equal loss and dz from planar
  and channels-last logits.
* the other model families [9]: K1's float mode (B1c) against its plain
  version at s and x width; ``Engine`` at bs1 for the Base, BiSe and Lab
  seg heads, pspv5x (``yolov5x_city_seg``), detection-only ``yolov5s`` and
  P6 ``yolov5s6`` at full width, card against CPU; ``seg_validation`` of
  BiSe on float batches off the k/255 lattice (K1's float mode, K4); an
  ``InferenceServer`` on ``yolov5s``; ``yolov5l_city_seg`` at bs2, where K7
  must not launch (c_ 64).

It checks that every kernel ran on its path, holds each kernel against its
plain version on the arguments its path gave it, and times the paths and
each kernel beside its bound and, where one PyTorch call computes the same
function, that call in the same dtype.  [1] counts the tensor-core (HMMA)
instructions in K1's, K2's and K7's two forms each (bf16 and 3xTF32)
(cuobjdump of the built library); [2] prints K2's launch plan
(tile, cluster split, CTAs) at each pspv5s site and requires one CTA an SM
at each, and K7's plan at each case, whose layout's byte count
ops/kernels/c3.py must give as the kernel does.  K5 (greedy NMS, a
thread-block cluster an image) prints its plan at every list shape it is
held at (the eval path's lists, synthetic lists of 1025-262144 rows and a
batch of eight 30000-row lists in [5], the bs8 server's lists in [8]),
where ops/kernels/nms_greedy.py's shared-memory count must equal the
kernel's, and [6] times it at eval's (4, 30000) lists, (4, 1024), (8,
1024) and the one-list serving case; it times K2's float32 form at eval's
10 bs4 sites and pspv5x's 22 bs1 sites beside cuDNN float32 (TF32 off),
its 3xTF32 bound and the CUDA cores' float32 bound.  [5] also holds K3's
keep mask and packed output bit for bit on seeded, chained, all-invalid
and ragged lists (n 1, 33, 1000, 1024), and K4's class map at bs1, eval's
bs4, the bs8 server's shape and a ragged geometry in both dtypes, bitwise
the same on a second launch and under every tile; [6] times K3 with and
without its pack and K4 at those shapes, and [8] K4 on the server's own
bs8 logits.  Any failure raises and
exits non-zero.  The last line of stdout is the JSON ``{"ok": true,
"device": {...}}``; the line before it the card's name and power limit,
the one before that the kernels' JSON.  Longer records go to
``chiprun_out/``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
CFG = "yolov5s_city_seg"
IN_HW, ORIG_HW = (512, 1024), (1024, 2048)     # bench.py:145-148 geometry
CONF = 0.001                                   # a full 1024-candidate NMS list
SEED = 0
N_FRAMES = 3
DEVICE = "cuda"
# batched serving [8]: serving.py's defaults but conf (a full NMS list), on
# square 1024x1024 letterboxed frames as the JAX server serves them
SERVE_IMG, SERVE_BS, SERVE_WAIT_MS = 1024, 8, 100
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_TAIL = 4, 4, 3
M_CFG = "yolov5m_city_seg"
X_CFG = "yolov5x_city_seg"     # pspv5x: [6] times K2's float32 form at its 22 bs1 sites

# bounds, each stated with its reason
F32_REL = 1e-4     # float32 vs float32: summation order only (TF32 off)
BF16_REL = 2e-2    # bf16 output (and input) rounding: 2^-8 relative, a few ulps
MASK_SHARE = 1e-4  # float32 rounding can flip a pixel whose top-2 logits tie within ~1e-6
NET_REL = 1e-3     # float32 through ~60 convs: per-layer reassociation, amplified
BOX_PX = 1.0       # boxes are rounded to whole frame pixels on both sides
SCORE_ABS = 1e-4
MATCH_SHARE = 0.99
# End to end, the card's and the CPU's network outputs differ by float32
# reassociation (bounded by NET_REL above), which can reorder near-tied
# candidates at the top-k and greedy-NMS cuts.  Measured on the CPU at this
# geometry and seed: 1e-4 relative noise on the candidates and seg logits
# leaves >= 99.3% of the detections matched, scores within 3e-4, and moves
# < 1e-5 of the mask pixels.
E2E_MATCH_SHARE = 0.98
E2E_SCORE_ABS = 1e-3
E2E_MASK_SHARE = 1e-3
# bf16 against fp32 on these random weights: the JAX package's own bf16
# engine, given the same seeded weights, differs from its fp32 one by 0.14
# of the seg logits' scale and by 0.0068 mean |diff| on obj/cls (CPU,
# 128x256 input).  The bounds leave room for the larger input; a bf16 path
# that is wrong rather than rounded lands far above them.
BF16_SEG_REL = 0.25
BF16_OBJCLS_MEAN = 0.03
BF16_MASK_SHARE = 0.05

# the eval path: cli/test.py's defaults on bench.py:277-306's geometry
EVAL_BS, EVAL_BATCHES = 4, 2
EVAL_CONF, EVAL_IOU, EVAL_MAX_NMS = 0.001, 0.6, 30000
RATIO_PAD = ((IN_HW[0] / ORIG_HW[0], IN_HW[1] / ORIG_HW[1]), (0.0, 0.0))
# Card against CPU, each on its own network outputs: float32 reassociation
# (NET_REL) can reorder candidates whose scores tie within ~1e-7 at the
# 30000-candidate and greedy cuts, and move a box by ~1e-4 px across an IoU
# threshold of the matching.  Each such change moves one detection's TP
# flags; with ~30 labels per image over 8 images that is of order 1e-3 of P,
# R or AP, so the bound allows a few.  On identical network outputs the eval
# (top-k, K5, matching, AP) must give identical detections and metrics.
EVAL_METRIC_ABS = 5e-3
# pixAcc and mIoU move by at most the share of flipped pixels (E2E_MASK_SHARE)
# and, for mIoU, by that share over the smallest class's pixel share
SEG_METRIC_ABS = 2e-3

# the train path [7]: bench.py:bench_train's geometry (:64-84) with
# load_hyp("scratch"), and its lr, bias lr and momentum (:96-98)
TRAIN_BS, TRAIN_DET_HW, TRAIN_SEG_HW = 8, (832, 832), (512, 1024)
TRAIN_TARGETS, TRAIN_MAX_T = 20, 128
TRAIN_STEP_ARGS = (0.01, 0.01, 0.9)
TRAIN_RUN_STEPS = 20     # the scheduled run, as cli/train.py:379-381 drives it
TRAIN_REPS, TRAIN_REP_STEPS = 5, 5
# K6 against its plain version on the step's own arguments: both read the
# same logits and compute in float32, so the loss differs by summation order
# only; dz by that and, in bf16, one rounding of each side's float32 value
SEG_CE_LOSS_REL = 1e-4
SEG_CE_DZ_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # of max |dz|
# One float32 step, card against CPU (TF32 off): reassociation in cuDNN's
# and oneDNN's convolutions and their backward.  On the CPU, the same step
# at full width (det 320x320, seg 128x256, bs2) in float32 against float64
# gave losses within 1e-7 relative and every tensor's change within 9e-4 of
# that change (median 5e-5).  cuDNN's float32 convolutions differ from the
# CPU's by more than float32 from float64 does: the serving network's
# outputs differ by 1.2e-4 of their scale ([3]).  So the losses are held at
# 1e-4, and the changes at 50x the rehearsal's worst tensor.
TRAIN_LOSS_REL = 1e-4
TRAIN_UPDATE_REL = 5e-2  # of each tensor's own change, + 2 float32 ulps of its values

# the other model families [9], each at full width and depth, bs1
FAMILY_CFGS = ("yolov5s_city_seg_base", "yolov5s_city_seg_bise", "yolov5s_city_seg_lab",
               X_CFG, "yolov5s", "yolov5s6")
BISE_CFG, DET_CFG, L_CFG = "yolov5s_city_seg_bise", "yolov5s", "yolov5l_city_seg"
FAMILY_REPS, FAMILY_ITERS = 5, 10
# [9] holds each network's float32 output against the same network in
# float64 on the CPU: rounding errors grow with depth and activation
# scale, past NET_REL on the deepest model.  Measured by this phase at
# 1024x512, seed 0, on an H100 machine: the CPU's own float32 boxes are
# 4.8e-3 off float64 on pspv5x (past NET_REL), 3.5e-5 to 2.6e-4 on the
# s-size models; the card's error was 0.95-2.9x the CPU's across the six
# configurations and their outputs (cuDNN's and K2's summation orders).
# So the card is held to 4x the CPU's own error, never tighter than NET_REL.
F64_FACTOR = 4.0
# bf16 against fp32: phase [3]'s bounds come from the JAX package's own
# bf16 drift on pspv5s.  The deeper pspv5x drifts further (on an H100
# machine, seed 0: seg logits 0.26 of their scale, obj/cls mean 0.065,
# against pspv5s's 0.08-0.11 and 0.009-0.011), so each configuration is
# held to 2x the drift of bf16 itself on its network, measured by the CPU's
# bf16 engine against its fp32 one, and never tighter than [3]'s bounds.
BF16_FACTOR = 2.0
STEM_BATCHES = (1, 4)

# H100 SXM peaks (NVIDIA's data sheet, at 700 W) for the bounds
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
BF16_FLOP_S = 989e12
# exp2 on the SFUs: 16 results per clock per SM (CUDA C++ programming
# guide, arithmetic throughput for compute capability 9.0), 132 SMs at the
# 1.98 GHz boost clock
SFU_OP_S = 132 * 16 * 1.98e9
# float32 operations of one IoU test: K3's division-free form (2 min, 2 max,
# 2 sub, 2 clamps, 3 mul, 1 add, 1 compare), K5's division form (the same
# overlap, the candidate's area, 2 add, 1 sub, 1 div, 1 compare)
K3_OPS_PER_TEST = 13
K5_OPS_PER_TEST = 17
# float32 operations K6 needs per (label pixel, class), besides its two exps
# (the forward's logsumexp, the backward's softmax): the forward's 2x2
# interpolation (6 mul, 3 add) and online logsumexp (3); the backward's
# interpolation (9), p - lse, - onehot, * w (3) and the four tap products
# and sums (8)
K6_OPS_PER_PIXEL_CLASS = 12 + 20


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call between CUDA events, host gaps included:
    for work that synchronises with the host (the plain NMS)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call: ``iters`` calls captured in one
    CUDA graph and replayed, so the host's launch time does not count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def diffs(got: torch.Tensor, want: torch.Tensor):
    """(max |diff|, max |diff| / max(max |want|, 1))."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1.0)


def bound_ms(nbytes: float, flops: float, peak: float):
    """(least ms for the work on an H100, "bytes" or "operations")."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


@contextlib.contextmanager
def replaced(owner, name: str, fn):
    """Set ``owner.name`` to ``fn`` for the duration."""
    real = getattr(owner, name)
    setattr(owner, name, fn)
    try:
        yield
    finally:
        setattr(owner, name, real)


def spied(owner, name: str, before=None, after=None):
    """Wrap ``owner.name`` for the duration: ``before(*args)`` is called
    with the arguments, ``after(out)`` with the result."""
    real = getattr(owner, name)

    def wrapper(*args, **kw):
        if before:
            before(*args, **kw)
        out = real(*args, **kw)
        if after:
            after(out)
        return out

    return replaced(owner, name, wrapper)


def recorder(store: list):
    """A ``before`` hook that keeps a copy of each call's arguments."""
    def before(*args, **kw):
        store.append((tuple(a.clone() if torch.is_tensor(a) else a for a in args), kw))
    return before


def check(name: str, value: float, bound: float, ok: bool = None) -> None:
    ok = value <= bound if ok is None else ok
    log(f"  {name}: {value:.3e} (bound {bound:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {value} above bound {bound}")


def phase_card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    from multiyolov5_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.library()
    path, nvcc_log = build.build_info()
    log(f"[1] card: {smi}; kernels built in {time.perf_counter() - t0:.1f} s "
        f"({os.path.relpath(path, ROOT)})")
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as fh:
        fh.write(nvcc_log)
    mma = tensor_core_ops(path)
    for name in ("stem_tc", "stem_tf32", "conv3x3_tma", "conv3x3_tf32", "c3_bf16", "c3_tf32"):
        n = sum(v for k, v in mma.items() if name in k)
        log(f"  HMMA/HGMMA instructions in the SASS of {name} (all instantiations): {n}")
        if n == 0:
            raise AssertionError(f"{name} has no tensor-core instruction")
    return smi


def tensor_core_ops(lib) -> dict:
    """{kernel symbol: HMMA/HGMMA instructions} in ``cuobjdump -sass`` of the
    built library."""
    exe = next((c for c in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump")
                if c and os.path.exists(c)), None)
    if exe is None:
        raise RuntimeError("cuobjdump not found")
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
        elif fn and ("HMMA" in line or "HGMMA" in line):
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def record_path_inputs(eng, frame):
    """One engine call with recording wrappers around K2 and K3: the conv
    sites' shapes and the NMS input of the real path."""
    from multiyolov5_tpu_torch.models import blocks
    from multiyolov5_tpu_torch.ops import nms as nms_mod
    sites, nms_inputs = [], []
    real_conv, real_nms = blocks.conv3x3, nms_mod.nms_packed

    def conv_rec(x, w, b, stride=1, dilation=1, act=True):
        sites.append((tuple(x.shape), w.shape[0], stride, dilation, act, w, b))
        return real_conv(x, w, b, stride, dilation, act)

    def nms_rec(boxes, scores, iou, max_det):
        nms_inputs.append((boxes.clone(), scores.clone(), iou))
        return real_nms(boxes, scores, iou, max_det)

    blocks.conv3x3, nms_mod.nms_packed = conv_rec, nms_rec
    try:
        eng(frame, ORIG_HW, conf=CONF)
    finally:
        blocks.conv3x3, nms_mod.nms_packed = real_conv, real_nms
    return sites, nms_inputs


def c3_case(gen, shape, ch, n, dt, shortcut=True):
    """A seeded NHWC input and K7 arguments (fan-in scaled OHWI weights,
    float32 biases) of one C3 with c2 = c1."""
    c1 = shape[-1]

    def wt(*s):
        return (torch.randn(*s, generator=gen, device=DEVICE) / np.sqrt(np.prod(s[1:]))).to(dt)

    def bias(c):
        return torch.randn(c, generator=gen, device=DEVICE) * 0.1

    mws = [(wt(ch, 1, 1, ch), bias(ch), wt(ch, 3, 3, ch), bias(ch)) for _ in range(n)]
    args = (wt(ch, 1, 1, c1), bias(ch), wt(ch, 1, 1, c1), bias(ch), wt(c1, 1, 1, 2 * ch),
            bias(c1), mws, shortcut)
    return torch.randn(shape, generator=gen, device=DEVICE).to(dt), args


def c3_work(x, args):
    """(bytes, flops) of one C3: x and y once, the weights and biases once;
    2 flops a MAC of cv1, cv2, cv3 and each bottleneck's 1x1 and 3x3."""
    c1, ch, c2, n = x.shape[-1], args[0].shape[0], args[4].shape[0], len(args[6])
    px = x.numel() // c1
    tensors = list(args[:6]) + [t for m in args[6] for t in m]
    nbytes = x.element_size() * (x.numel() + px * c2) + sum(
        t.numel() * t.element_size() for t in tensors)
    return nbytes, 2 * px * (2 * c1 * ch + 2 * ch * c2 + n * 10 * ch * ch)


def c3_bound(x, args, cuda_cores: bool = False):
    """(least ms, "bytes" or "operations") of K7 on ``x`` (c3_work's bytes
    and flops) at the arithmetic its form does: bfloat16 on the bf16 tensor
    cores; float32 as 3xTF32, three TF32 products a MAC at the TF32 peak,
    or with ``cuda_cores`` one float32 FMA a MAC at the CUDA cores' peak
    (the first form's arithmetic)."""
    nbytes, flops = c3_work(x, args)
    if x.dtype == torch.bfloat16:
        return bound_ms(nbytes, flops, BF16_FLOP_S)
    return bound_ms(nbytes, flops, FP32_FLOP_S) if cuda_cores else bound_ms(
        nbytes, 3 * flops, TF32_FLOP_S)


def conv_bound(x, co: int, stride: int, cuda_cores: bool = False):
    """(least ms, "bytes" or "operations") of K2 on ``x`` -> ``co`` channels
    at ``stride``: x, the OHWI weight and the output in x's type and the
    float32 bias each moved once; 2 flops a MAC at the arithmetic of x's
    form: bf16 on the bf16 tensor cores; float32 as 3xTF32, three TF32
    products a MAC at the TF32 peak, or with ``cuda_cores`` one float32 FMA
    a MAC at the CUDA cores' peak (the first form's arithmetic)."""
    bsz, h, w, ci = x.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    nbytes = x.element_size() * (x.numel() + co * 9 * ci + bsz * ho * wo * co) + 4 * co
    flops = 2 * bsz * ho * wo * co * 9 * ci
    if x.dtype == torch.bfloat16:
        return bound_ms(nbytes, flops, BF16_FLOP_S)
    return bound_ms(nbytes, flops, FP32_FLOP_S) if cuda_cores else bound_ms(
        nbytes, 3 * flops, TF32_FLOP_S)


def time_k2_f32(calls):
    """K2's float32 form at each ``(x, w, b, stride, dilation, act)`` of
    ``calls`` beside cuDNN float32 (TF32 off) and both bounds; returns
    (rows, sums)."""
    import torch.nn.functional as F

    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops.kernels.conv3x3 import plan as conv_plan
    rows = []
    for x, wt, b, s, d, act in calls:
        xc, wc = x.permute(0, 3, 1, 2), wt.permute(0, 3, 1, 2)
        bsz, hh, ww, ci = x.shape
        co = wt.shape[0]
        ho, wo = (hh - 1) // s + 1, (ww - 1) // s + 1
        rows.append({
            "x": list(x.shape), "c_out": co, "stride": s, "dilation": d,
            "plan": plan_text(conv_plan(bsz, ho, wo, ci, co, x.dtype, s, d)),
            "ms": graph_ms(lambda: K.conv3x3(x, wt, b, s, d, act)),
            # few repetitions: cuDNN fp32 without TF32 takes ~75 ms at FFM's site
            "plain_ms": graph_ms(lambda: K.conv3x3_plain(x, wt, b, s, d, act), iters=3,
                                 replays=2),
            "library_ms": graph_ms(lambda: F.conv2d(xc, wc, b, s, d, d), iters=3, replays=2),
            "bound_ms": conv_bound(x, co, s)[0],
            "cuda_core_bound_ms": conv_bound(x, co, s, cuda_cores=True)[0]})
    sums = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "cuda_core_bound_ms")}
    for r in rows:
        log(f"    {tuple(r['x'])} -> {r['c_out']} s{r['stride']} d{r['dilation']} "
            f"{r['plan']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, cuDNN fp32 "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} (3xTF32; CUDA-core fp32 "
            f"{r['cuda_core_bound_ms']:.5f})")
    return rows, sums


def c3_module(args):
    """A fused eval ``C3`` module on the card (channels_last) holding K7's
    arguments as its conv weights: the unfused sequence the model runs off
    K7 (5 cuDNN convs, cat, add), the library yardstick."""
    from multiyolov5_tpu_torch.models.blocks import C3
    wcv1, bcv1, wcv2, bcv2, wcv3, bcv3, mws, shortcut = args
    mod = C3(wcv1.shape[-1], wcv3.shape[0], n=len(mws), shortcut=shortcut, fused=True)
    convs = [mod.cv1.conv, mod.cv2.conv, mod.cv3.conv] + [
        c for b in mod.m for c in (b.cv1.conv, b.cv2.conv)]
    pairs = [(wcv1, bcv1), (wcv2, bcv2), (wcv3, bcv3)] + [
        p for m in mws for p in ((m[0], m[1]), (m[2], m[3]))]
    with torch.no_grad():
        for conv, (w, b) in zip(convs, pairs):
            conv.weight.copy_(w.permute(0, 3, 1, 2))
            conv.bias.copy_(b)
    return mod.eval().to(device=wcv1.device, dtype=wcv1.dtype,
                         memory_format=torch.channels_last)


def c3_sequence_ms(mod, x):
    """Device ms of ``mod``'s unfused sequence on NHWC ``x``."""
    xc = x.permute(0, 3, 1, 2)

    def sequence():
        with torch.inference_mode():
            return mod.cv3(torch.cat([mod.m(mod.cv1(xc)), mod.cv2(xc)], 1))

    return graph_ms(sequence)


def c3_row(eng):
    """The engine's row-2 C3 module, the one K7 runs."""
    from multiyolov5_tpu_torch.models.blocks import C3
    mod = eng.model.model[2]
    if not (isinstance(mod, C3) and mod.c3_kernel):
        raise AssertionError("row 2 is not a C3 on the K7 route")
    return mod


def hold_c3(eng32, eng16):
    """K7 against c3_plain at the batched paths' shapes: pspv5s row 2 at bs8
    1024x1024 (the engines' weights), pspv5m row 2 at bs2 (c_ 48, two
    bottlenecks), no shortcut, and an H x W that is no multiple of the tile;
    at each, ops/kernels/c3.py's layout count must equal the kernel's
    (mk_c3_smem_bytes) at every plan.  Returns the float32 max |diff| at
    the pspv5s serving shape."""
    import ctypes

    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops.kernels import build
    from multiyolov5_tpu_torch.ops.kernels.c3 import PLANS, plan, smem_bytes
    smem_c = build.function("mk_c3_smem_bytes", [ctypes.c_int] * 9)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    side = SERVE_IMG // 4
    out = None
    for eng, dt, bound in ((eng32, torch.float32, F32_REL), (eng16, torch.bfloat16, BF16_REL)):
        args = c3_row(eng).kernel_args()
        cases = [("pspv5s row 2", torch.randn((SERVE_BS, side, side, args[0].shape[-1]),
                                              generator=g, device=DEVICE).to(dt), args),
                 ("pspv5m row 2", *c3_case(g, (2, side, side, 96), 48, 2, dt)),
                 ("no shortcut", *c3_case(g, (2, 64, 128, 64), 32, 1, dt, False)),
                 ("odd H x W", *c3_case(g, (3, 37, 53, 64), 32, 1, dt))]
        for name, x, a in cases:
            widths = (x.shape[-1], a[0].shape[0], a[4].shape[0], len(a[6]))
            for pl in PLANS[dt]:
                py, cu = smem_bytes(*widths, *pl, dt), smem_c(*widths, *pl,
                                                              int(dt == torch.bfloat16))
                if py != cu:
                    raise AssertionError(f"c3 {widths} plan {pl} {dt}: "
                                         f"smem_bytes {py} != mk_c3_smem_bytes {cu}")
            got = K.c3(x, *a)
            torch.cuda.synchronize()
            d, rel = diffs(got, K.c3_plain(x, *a))
            p = plan(*x.shape, *widths[1:], dt)
            log(f"  c3 {str(dt)[6:]} {name} {tuple(x.shape)} c_ {a[0].shape[0]} n {len(a[6])}: "
                f"max|diff| {d:.3e}; plan {p.th}x{p.tw} tile, {p.nbuf} weight buffer(s) of "
                f"{p.rows or 'all'} rows, {p.smem} B, {p.ctas} CTAs (layout bytes = "
                "mk_c3_smem_bytes at every plan)")
            check(f"c3 {str(dt)[6:]} {name} max|diff|/max(max|ref|,1)", rel, bound)
            if out is None:
                out = d
    return out


def plan_text(p) -> str:
    """A K2 launch plan (ops/kernels/conv3x3.py plan) in words."""
    return (f"tile 8x{p.bm // 8} px x {p.bn} ch, BK {p.bk}, split {p.split}, {p.tiles} tiles, "
            f"{p.ctas} CTAs, {p.k_steps} K steps a CTA")


def phase_kernels(eng32, eng16, frames):
    """[2] each kernel against its plain version at the path's shapes."""
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops.kernels.conv3x3 import SMS
    from multiyolov5_tpu_torch.ops.kernels.conv3x3 import plan as conv_plan
    dev = torch.device(DEVICE)
    log("[2] kernels vs plain at the pspv5s 1024x512 path shapes")
    res = {}
    frame = torch.from_numpy(frames[0][None]).to(dev)

    # K1
    w = eng32.stem_weights
    for dt, bound in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
        got = K.stem(frame, *w, out_dtype=dt)
        torch.cuda.synchronize()
        d, rel = diffs(got, K.stem_plain(frame, *w, out_dtype=dt))
        log(f"  stem {str(dt)[6:]} max|diff| {d:.3e}")
        check(f"stem {str(dt)[6:]} max|diff|/max(max|ref|,1)", rel, bound)
        res.setdefault("stem", d)

    # K2 at every site of the path (shapes and fused weights of the engines)
    sites32, nms_in = record_path_inputs(eng32, frames[0])
    sites16, _ = record_path_inputs(eng16, frames[0])
    g = torch.Generator(device=dev).manual_seed(SEED)
    for sites, dt, bound in ((sites32, torch.float32, F32_REL),
                             (sites16, torch.bfloat16, BF16_REL)):
        worst_abs = worst_rel = 0.0
        for shape, co, s, d, act, wt, b in sites:
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            got = K.conv3x3(x, wt, b, s, d, act)
            torch.cuda.synchronize()
            da, dr = diffs(got, K.conv3x3_plain(x, wt, b, s, d, act))
            worst_abs, worst_rel = max(worst_abs, da), max(worst_rel, dr)
        log(f"  conv3x3 {str(dt)[6:]} max|diff| {worst_abs:.3e} over {len(sites)} sites")
        check(f"conv3x3 {str(dt)[6:]} max|diff|/max(max|ref|,1)", worst_rel, bound)
        res.setdefault("conv3x3", worst_abs)
        # the launch plan of each site: at bs1 every site fills the card
        for shape, co, s, d, act, wt, b in sites:
            ho, wo = (shape[1] - 1) // s + 1, (shape[2] - 1) // s + 1
            p = conv_plan(shape[0], ho, wo, shape[3], co, dt, s, d)
            log(f"    {str(dt)[6:]} {shape} -> {co} s{s} d{d}: {plan_text(p)}")
            check(f"conv3x3 {str(dt)[6:]} {shape} -> {co} s{s}: SMs without a CTA",
                  max(0, SMS - p.ctas), 0)
    # c_in 48, the BK = 16 path: SegMaskLab's detail conv at 1/8 res
    x = torch.randn((1, IN_HW[0] // 8, IN_HW[1] // 8, 48), generator=g, device=dev)
    wt = (torch.randn((48, 3, 3, 48), generator=g, device=dev) / np.sqrt(9 * 48))
    b = torch.randn(48, generator=g, device=dev) * 0.1
    for dt, bound in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
        xd, wd = x.to(dt), wt.to(dt)
        got = K.conv3x3(xd, wd, b)
        torch.cuda.synchronize()
        d, rel = diffs(got, K.conv3x3_plain(xd, wd, b))
        p = conv_plan(*xd.shape, 48, dt)
        log(f"  conv3x3 {str(dt)[6:]} c_in 48 {tuple(x.shape)} {plan_text(p)}: "
            f"max|diff| {d:.3e}")
        check(f"conv3x3 {str(dt)[6:]} c_in 48 max|diff|/max(max|ref|,1)", rel, bound)

    # K3 on seeded overlapping box sets at N = 1024, and on the path's input
    rng = np.random.RandomState(SEED)
    diff = 0
    cases = []
    for img in (300, 800, 2000):
        xy = rng.rand(1024, 2) * img
        wh = rng.rand(1024, 2) * 150 + 4
        cls = rng.randint(0, 10, (1024, 1)) * 4096.0
        boxes = np.concatenate([xy - wh / 2 + cls, xy + wh / 2 + cls], 1).astype(np.float32)
        scores = np.sort(rng.rand(1024).astype(np.float32))[::-1].copy()
        scores[900:] = 0
        cases.append((torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev), 0.45))
    cases += nms_in
    for boxes, scores, iou in cases:
        got = K.nms(boxes, scores, iou)
        idx, valid = K.nms_packed(boxes, scores, iou, 300)
        torch.cuda.synchronize()
        want = K.nms_plain(boxes, scores, iou)
        want_idx, want_valid = K.nms_packed_plain(boxes, scores, iou, 300)
        diff += int((got != want).sum().item() + (idx != want_idx).sum().item()
                    + (valid != want_valid).sum().item())
    check(f"nms keep-mask and packed entries differing, {len(cases)} sets of "
          f"N={len(cases[0][1])}", diff, 0)
    res["nms"] = float(diff)

    # K4 on seeded logits of the head's shape
    seg_hw = (IN_HW[0] // 8, IN_HW[1] // 8)
    x = torch.randn((1, 19, *seg_hw), generator=g, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        got = K.upsample_argmax(xd, ORIG_HW, via_hw=IN_HW)
        torch.cuda.synchronize()
        share = (got != K.upsample_argmax_plain(xd, ORIG_HW, via_hw=IN_HW)).float().mean().item()
        check(f"upsample_argmax {str(dt)[6:]} mismatched pixel share", share, MASK_SHARE)
        if dt == torch.float32:
            res["upsample_argmax"] = share

    # K7 at the batched forward's shapes
    res["c3"] = hold_c3(eng32, eng16)
    return res, sites16, nms_in


def match_dets(a: np.ndarray, r: np.ndarray, box_px: float = BOX_PX):
    """Each det of ``a`` is matched when a same-class det of ``r`` lies
    within ``box_px`` in max |box diff|; of those, the one nearest in score
    is its pair.  Returns (matched share, max box |diff| and max score
    |diff| over matched pairs).  Boxes clipped to zero area are common with
    random weights, so the match is by coordinates, not IoU, and several
    dets can share one box."""
    if len(a) == 0:
        return (1.0 if len(r) == 0 else 0.0), 0.0, 0.0
    matched, box_d, score_d = 0, 0.0, 0.0
    for d in a:
        same = r[r[:, 5] == d[5]]
        dist = np.abs(same[:, :4] - d[:4]).max(1)
        near = dist <= box_px
        if not near.any():
            continue
        sdiff = np.abs(same[near, 4] - d[4])
        j = int(sdiff.argmin())
        matched += 1
        box_d = max(box_d, float(dist[near][j]))
        score_d = max(score_d, float(sdiff[j]))
    return matched / len(a), box_d, score_d


def compare_runs(name, got, ref, match_share, box_px, score_abs, mask_share,
                 match_px=BOX_PX):
    n_got = sum(len(d) for d in got[0])
    n_ref = sum(len(d) for d in ref[0])
    shares, boxes, scores = zip(*(match_dets(a, r, match_px)
                                  for a, r in zip(got[0], ref[0])))
    if any((a is None) != (r is None) for a, r in zip(got[1], ref[1])):
        raise AssertionError(f"{name}: a class map on one side only")
    mism = float(np.mean([(a != r).mean() if a is not None else 0.0
                          for a, r in zip(got[1], ref[1])]))
    log(f"  {name}: detections {n_got} vs {n_ref}")
    for d, m in zip(*got):
        if not (np.isfinite(d).all() and d.shape[1] == 6
                and (m is None or (m.shape == ORIG_HW and m.dtype == np.uint8))):
            raise AssertionError(f"{name}: malformed output")
    if match_share is None:
        log(f"  {name} detections matched within {match_px:g} px: "
            f"{min(shares):.3e} (reported, no bound)")
    else:
        check(f"{name} detections matched share (1 - share)", 1 - min(shares),
              1 - match_share)
    if box_px is not None:
        check(f"{name} matched box max|diff| px", max(boxes), box_px)
        check(f"{name} matched score max|diff|", max(scores), score_abs)
    check(f"{name} mask mismatched share", mism, mask_share)


def phase_end_to_end(eng32, eng16, cpu_eng, frames):
    """[3] the serving path on the card against the CPU plain path."""
    from multiyolov5_tpu_torch.ops import kernels as K
    log(f"[3] Engine({CFG}, seed {SEED}) on {N_FRAMES} frames {IN_HW} -> {ORIG_HW}, conf {CONF}")
    K.reset_launches()
    card = [eng32(f, ORIG_HW, conf=CONF) for f in frames]
    torch.cuda.synchronize()
    launches = K.launch_counts()
    log(f"  launches on the card path: {launches}")
    want = {"stem": N_FRAMES, "conv3x3": 10 * N_FRAMES, "nms": N_FRAMES,
            "upsample_argmax": N_FRAMES, "c3": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"bs1 serving launches {launches}, want {want}")

    cpu = [cpu_eng(f, ORIG_HW, conf=CONF) for f in frames]
    post_card, post_cpu = [], []
    for f in frames:
        z_card, seg_card = eng32.forward(torch.from_numpy(f[None]).to(DEVICE))
        z_cpu, seg_cpu = cpu_eng.forward(torch.from_numpy(f[None]))
        z_card, seg_card = z_card.cpu(), seg_card.cpu()
        check("network fp32 card vs CPU: boxes max|diff|/max(max|ref|,1)",
              diffs(z_card[:, :4], z_cpu[:, :4])[1], NET_REL)
        check("network fp32 card vs CPU: obj/cls max|diff|",
              diffs(z_card[:, 4:], z_cpu[:, 4:])[0], NET_REL)
        check("network fp32 card vs CPU: seg logits max|diff|/max(max|ref|,1)",
              diffs(seg_card, seg_cpu)[1], NET_REL)
        post_card.append(eng32.postprocess(z_card.to(DEVICE), seg_card.to(DEVICE),
                                           IN_HW, ORIG_HW, conf=CONF))
        post_cpu.append(cpu_eng.postprocess(z_card, seg_card, IN_HW, ORIG_HW, conf=CONF))
    merge = lambda runs: ([r[0][0] for r in runs], [r[1][0] for r in runs])  # noqa: E731
    compare_runs("post-processing (NMS, unmap, mask) card vs CPU on the card's "
                 "network outputs", merge(post_card), merge(post_cpu), MATCH_SHARE,
                 BOX_PX, SCORE_ABS, MASK_SHARE)
    compare_runs("end to end fp32 card vs CPU", merge(card), merge(cpu),
                 E2E_MATCH_SHARE, BOX_PX, E2E_SCORE_ABS, E2E_MASK_SHARE)
    for f in frames:
        x = torch.from_numpy(f[None]).to(DEVICE)
        (z16, seg16), (z32, seg32) = eng16.forward(x), eng32.forward(x)
        check("network bf16 vs fp32 card: seg logits max|diff|/max(max|ref|,1)",
              diffs(seg16, seg32)[1], BF16_SEG_REL)
        check("network bf16 vs fp32 card: obj/cls mean |diff|",
              (z16[:, 4:].float() - z32[:, 4:]).abs().mean().item(), BF16_OBJCLS_MEAN)
    half = [eng16(f, ORIG_HW, conf=CONF) for f in frames]
    # bf16 moves boxes by pixels and reorders near-tied scores at the top-k
    # and NMS cuts, so of the outputs only the class map is bounded; the
    # detections are reported, matched within 16 px
    compare_runs("end to end bf16 card vs fp32 card", merge(half), merge(card),
                 None, None, None, BF16_MASK_SHARE, match_px=16.0)
    return launches


def eval_batches(eng, rng):
    """Seeded in-memory loaders in the batch contracts of the JAX package's
    loaders.  Detection: (imgs uint8, targets (B, T, 5) [cls, xywh
    normalized], tmask, paths, shapes), the labels a jittered subset of
    ``eng``'s own detections plus boxes no detection covers, so mAP is
    neither 0 nor 1.  Segmentation: (imgs float in [0, 1], masks int32 at
    ORIG_HW): seeded uint8 labels, 70% ``eng``'s class map, 30% random
    classes, 10% 255, with 255 mapped to the loader's ignore -1."""
    from multiyolov5_tpu_torch.ops.kernels import upsample_argmax
    from multiyolov5_tpu_torch.ops.nms import non_max_suppression
    det, seg = [], []
    h, w = IN_HW
    nc = eng.spec.nc
    for b in range(EVAL_BATCHES):
        imgs = (rng.rand(EVAL_BS, *IN_HW, 3) * 255).astype(np.uint8)
        z, logits = eng.forward(torch.from_numpy(imgs).to(DEVICE))
        dets = non_max_suppression(z.transpose(1, 2), EVAL_CONF, EVAL_IOU, multi_label=True,
                                   max_nms=EVAL_MAX_NMS)
        targets = np.zeros((EVAL_BS, 40, 5), np.float32)
        tmask = np.zeros((EVAL_BS, 40), bool)
        for i, d in enumerate(dets):
            pick = d[rng.choice(len(d), min(30, len(d)), replace=False)]
            xyxy = pick[:, :4] + rng.randn(len(pick), 4) * 6
            extra = rng.rand(6, 2) * [w - 80, h - 80]
            xyxy = np.concatenate([xyxy, np.concatenate([extra, extra + 80], 1)])
            cls = np.concatenate([pick[:, 5], rng.randint(0, nc, 6)])
            xywh = np.stack([(xyxy[:, 0] + xyxy[:, 2]) / 2 / w, (xyxy[:, 1] + xyxy[:, 3]) / 2 / h,
                             (xyxy[:, 2] - xyxy[:, 0]) / w, (xyxy[:, 3] - xyxy[:, 1]) / h], 1)
            targets[i, :len(cls)] = np.concatenate([cls[:, None], xywh], 1)
            tmask[i, :len(cls)] = True
        det.append((imgs, targets, tmask, [f"b{b}_{i}.png" for i in range(EVAL_BS)],
                    [(ORIG_HW, RATIO_PAD)] * EVAL_BS))
        cmap = upsample_argmax(logits.float().contiguous(), ORIG_HW, via_hw=IN_HW).cpu().numpy()
        masks = np.where(rng.rand(*cmap.shape) < 0.3,
                         rng.randint(0, logits.shape[1], cmap.shape), cmap).astype(np.uint8)
        masks[rng.rand(*cmap.shape) < 0.1] = 255
        masks = masks.astype(np.int32)
        masks[masks == 255] = -1
        seg.append((imgs.astype(np.float32) / 255.0, masks))
    return det, seg


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its printed lines kept out of stdout."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def run_eval(eng, det_b, seg_b, kernels: bool):
    """evaluate_detection then seg_validation, recording every network
    output ("net") and the detections ("dets"); with ``kernels``, also the
    arguments of each kernel the path calls (K1 "stem", uint8 frames in
    evaluate_detection and float ones in seg_validation, K2 "conv3x3", K7
    "c3", K5 "nms_greedy" and, in seg_validation, K4 "upsample_argmax")."""
    from multiyolov5_tpu_torch import engine as engine_mod
    from multiyolov5_tpu_torch import evaluation as E
    from multiyolov5_tpu_torch.models import blocks
    from multiyolov5_tpu_torch.ops import nms as nms_mod
    rec = {k: [] for k in ("net", "dets", "stem", "conv3x3", "c3", "nms_greedy",
                           "upsample_argmax")}
    spies = [spied(engine_mod.Engine, "forward", after=rec["net"].append),
             spied(E, "non_max_suppression", after=rec["dets"].extend)]
    if kernels:
        spies += [spied(engine_mod, "stem", before=recorder(rec["stem"])),
                  spied(blocks, "conv3x3", before=recorder(rec["conv3x3"])),
                  spied(blocks, "c3", before=recorder(rec["c3"])),
                  spied(nms_mod, "nms_greedy", before=recorder(rec["nms_greedy"])),
                  spied(E, "upsample_argmax", before=recorder(rec["upsample_argmax"]))]
    with contextlib.ExitStack() as stack:
        for sp in spies:
            stack.enter_context(sp)
        det = quiet(E.evaluate_detection, eng, det_b, conf_thres=EVAL_CONF,
                    iou_thres=EVAL_IOU)
        seg = quiet(E.seg_validation, eng, seg_b, nclass=eng.spec.n_segcls)
    return det, seg, rec


def hold_eval_kernels(rec):
    """Each kernel against its plain version on the arguments the counted
    eval run gave it; returns the float32 max |diff| (K1 in each mode, K2,
    K7), the mismatched pixel share (K4) and the picks differing (K5)."""
    from multiyolov5_tpu_torch.ops import kernels as K
    errs = {}
    calls = dict(rec, stem=[c for c in rec["stem"] if not c[0][0].is_floating_point()],
                 stem_float=[c for c in rec["stem"] if c[0][0].is_floating_point()])
    for name, plain in (("stem", K.stem_plain), ("stem_float", K.stem_plain),
                        ("conv3x3", K.conv3x3_plain), ("c3", K.c3_plain)):
        worst_abs = worst_rel = 0.0
        for args, kw in calls[name]:
            got = getattr(K, name)(*args, **kw)
            torch.cuda.synchronize()
            da, dr = diffs(got, plain(*args, **kw))
            worst_abs, worst_rel = max(worst_abs, da), max(worst_rel, dr)
        shapes = sorted({tuple(a[0].shape) for a, _ in calls[name]})
        log(f"  {name} float32 at the eval path's {len(calls[name])} calls {shapes}: "
            f"max|diff| {worst_abs:.3e}")
        check(f"{name} eval max|diff|/max(max|ref|,1)", worst_rel, F32_REL)
        errs[name] = worst_abs
    share = 0.0
    for args, kw in rec["upsample_argmax"]:
        got = K.upsample_argmax(*args, **kw)
        torch.cuda.synchronize()
        share = max(share, (got != K.upsample_argmax_plain(*args, **kw)).float().mean().item())
    shapes = [(tuple(a[0].shape), a[1]) for a, _ in rec["upsample_argmax"]]
    check(f"upsample_argmax at seg_validation's {shapes} mismatched pixel share",
          share, MASK_SHARE)
    errs["upsample_argmax"] = share
    errs["nms_greedy"] = float(hold_k5(rec["nms_greedy"], "the eval path's lists"))
    return errs


def k5_plan_text(bsz: int, n: int) -> str:
    from multiyolov5_tpu_torch.ops.kernels.nms_greedy import plan
    p = plan(bsz, n)
    return (f"plan: {p.cluster} CTA{'s' if p.cluster > 1 else ''} an image, "
            f"{p.rows} rows a CTA, {p.smem} B shared, boxes in "
            f"{'shared' if p.resident else 'device'} memory")


def hold_k5(calls, what: str) -> int:
    """K5 against its plain version on each call's arguments, its plan
    printed at each list shape; fails unless every pick is equal."""
    import ctypes

    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops.kernels import build
    from multiyolov5_tpu_torch.ops.kernels.nms_greedy import plan
    diff = 0
    for args, kw in calls:
        idx, valid = K.nms_greedy(*args, **kw)
        torch.cuda.synchronize()
        want_idx, want_valid = K.nms_greedy_plain(*args, **kw)
        diff += int((idx != want_idx).sum()) + int((valid != want_valid).sum())
    shapes = [tuple(a[1].shape) for a, _ in calls]
    smem_c = build.function("mk_nms_greedy_smem_bytes", [ctypes.c_int] * 2)
    for shape in sorted(set(shapes)):
        p = plan(*shape)
        log(f"  nms_greedy {shape} {k5_plan_text(*shape)}")
        check(f"nms_greedy {shape}: plan's shared memory - the kernel's",
              abs(p.smem - smem_c(p.rows, int(p.resident))), 0)
    check(f"nms_greedy picks differing from plain at {what} {shapes}", diff, 0)
    return diff


def greedy_tests(boxes, scores, idx, valid, iou):
    """IoU tests K5 makes on these inputs: for each pick, the rows after it
    that are still active, and the pick itself."""
    total = 0
    for b in range(boxes.shape[0]):
        p = idx[b][valid[b]].long()
        x1, y1, x2, y2 = boxes[b].unbind(1)
        area = (x2 - x1) * (y2 - y1)
        iw = (torch.minimum(x2[None], x2[p][:, None]) -
              torch.maximum(x1[None], x1[p][:, None])).clamp_min(0)
        ih = (torch.minimum(y2[None], y2[p][:, None]) -
              torch.maximum(y1[None], y1[p][:, None])).clamp_min(0)
        inter = iw * ih
        over = inter / (area[None] + area[p][:, None] - inter + 1e-9) > iou
        gone = torch.cat([torch.zeros_like(over[:1]), over.cumsum(0)[:-1] > 0])
        after = torch.arange(boxes.shape[1], device=boxes.device)[None] > p[:, None]
        total += int(((scores[b] > 0)[None] & ~gone & after).sum()) + len(p)
    return total


def k3_lists():
    """(name, boxes, scores, iou) on the card: K3's seeded sets of [2] (N
    1024, 10 class offsets, images of 300, 800 and 2000 px, 900 valid), the
    deepest chain (unit boxes a quarter apart: each overlaps the next only,
    every other row kept), a list with every row invalid, and lists of 1,
    33 and 1000 rows (n no multiple of 32)."""
    rng = np.random.RandomState(SEED)
    out = []
    for img, n in ((300, 1024), (800, 1024), (2000, 1024), (300, 1), (300, 33), (800, 1000)):
        xy = rng.rand(n, 2) * img
        wh = rng.rand(n, 2) * 150 + 4
        cls = rng.randint(0, 10, (n, 1)) * 4096.0
        boxes = np.concatenate([xy - wh / 2 + cls, xy + wh / 2 + cls], 1).astype(np.float32)
        scores = np.sort(rng.rand(n).astype(np.float32))[::-1].copy()
        scores[max(n * 900 // 1024, 1):] = 0
        out.append((f"seeded {img} px n {n}", boxes, scores))
    x = np.arange(1024, dtype=np.float32) * 0.25
    out.append(("chain n 1024", np.stack([x, 0 * x, x + 1, 0 * x + 1], 1),
                np.linspace(1.0, 0.5, 1024).astype(np.float32)))
    out.append(("all invalid n 1024", out[0][1], np.zeros(1024, np.float32)))
    return [(name, torch.from_numpy(b).to(DEVICE), torch.from_numpy(sc).to(DEVICE), 0.45)
            for name, b, sc in out]


def k3_plan_text(n: int) -> str:
    from multiyolov5_tpu_torch.ops.kernels.nms import plan
    p = plan(n)
    return (f"plan: a cluster of {p.ctas} CTA{'s' if p.ctas > 1 else ''} builds the mask, "
            f"CTA 0 sweeps ({p.smem} B shared)")


def hold_k3():
    """[5] K3's keep mask and packed output against the plain versions on
    ``k3_lists``, max_det 300 and below the kept count; the plan's shared
    memory against the kernel's.  Returns the entries differing (0)."""
    import ctypes

    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops.kernels import build
    from multiyolov5_tpu_torch.ops.kernels.nms import plan
    smem_c = build.function("mk_nms_smem_bytes", [ctypes.c_int])
    diff = 0
    for name, boxes, scores, iou in k3_lists():
        n = boxes.shape[0]
        want = K.nms_plain(boxes, scores, iou)
        got = K.nms(boxes, scores, iou)
        d = int((got != want).sum())
        kept = int(want.sum())
        for max_det in sorted({300, max(kept // 2, 1)}):
            idx, valid = K.nms_packed(boxes, scores, iou, max_det)
            want_idx, want_valid = K.nms_packed_plain(boxes, scores, iou, max_det)
            d += int((idx != want_idx).sum()) + int((valid != want_valid).sum())
        torch.cuda.synchronize()
        p = plan(n)
        log(f"  nms {name}: {kept} kept, keep and packed entries differing {d}; "
            f"{k3_plan_text(n)}")
        check(f"nms {name}: plan's shared memory - the kernel's",
              abs(p.smem - smem_c(n)), 0)
        diff += d
    check("nms keep-mask and packed entries differing from plain on K3's lists", diff, 0)
    return diff


def k4_plan_text(p) -> str:
    rows = p.threads * p.run // p.tc
    return (f"plan: {p.tr}x{p.tc} px tiles in passes of {rows} rows, runs of {p.run} over "
            f"{p.span} columns, {p.cb} classes a chunk, window {p.wr}x{p.wx}, {p.smem} B "
            f"shared, {p.ctas} CTAs of {p.threads} threads")


def k4_bound(x, out_hw, via_hw):
    """K4's least time on an H100: the logits read once and the class map
    written once, or the separable work in float32 on the CUDA cores: per
    image and class the W pass on h rows (2 tw h W0), the H pass (2 th H0
    W0) and one compare a pixel."""
    from multiyolov5_tpu_torch.ops.kernels.upsample_argmax import band_tables
    bsz, c, h, w = x.shape
    h0, w0 = out_hw
    th = band_tables(h, h0, via_hw[0])[1].shape[1]
    tw = band_tables(w, w0, via_hw[1])[1].shape[1]
    ops = bsz * c * (2 * tw * h * w0 + 2 * th * h0 * w0 + h0 * w0)
    return bound_ms(x.element_size() * x.numel() + bsz * h0 * w0, ops, FP32_FLOP_S)


def k4_cases():
    """(name, logits, out_hw, via_hw) on the card, seeded: bs1 serving's,
    seg_validation's bs4, the bs8 server's (letterboxed square frames) and a
    ragged geometry whose tiles straddle both frame edges."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    seg_hw = (IN_HW[0] // 8, IN_HW[1] // 8)
    out = []
    for name, shape, out_hw, via_hw in (
            ("bs1", (1, 19, *seg_hw), ORIG_HW, IN_HW),
            (f"bs{EVAL_BS}", (EVAL_BS, 19, *seg_hw), ORIG_HW, IN_HW),
            (f"bs{SERVE_BS}", (SERVE_BS, 19, SERVE_IMG // 8, SERVE_IMG // 8), ORIG_HW,
             (SERVE_IMG, SERVE_IMG)),
            ("ragged", (2, 19, 37, 61), (301, 517), (296, 488))):
        x = torch.randn(shape, generator=g, device=DEVICE)
        for dt in (torch.float32, torch.bfloat16):
            out.append((f"{name} {str(dt)[6:]}", x.to(dt), out_hw, via_hw))
    return out


def hold_k4():
    """[5] K4 against its plain version on ``k4_cases``: the mismatched
    pixel share within MASK_SHARE, the class map bitwise the same on a
    second launch and under every tile of ``TILES`` that takes the
    geometry, the plan's shared memory the kernel's.  Returns the worst
    share."""
    import ctypes

    import importlib

    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops.kernels import build
    k4 = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.upsample_argmax")
    smem_c = build.function("mk_upsample_argmax_smem_bytes", [ctypes.c_int] * 5)
    worst = 0.0
    for name, x, out_hw, via_hw in k4_cases():
        p = k4.plan(x.shape[0], x.shape[1], *x.shape[2:], out_hw, via_hw)
        th = k4.band_tables(x.shape[2], out_hw[0], via_hw[0])[1].shape[1]
        check(f"upsample_argmax {name}: plan's shared memory - the kernel's",
              abs(p.smem - smem_c(p.tr, th, p.cb, p.wr, p.wx)), 0)
        got = K.upsample_argmax(x, out_hw, via_hw)
        again = K.upsample_argmax(x, out_hw, via_hw)
        share = (got != K.upsample_argmax_plain(x, out_hw, via_hw)).float().mean().item()
        plans = differ = 0
        for tile in k4.TILES:
            try:
                q = k4.plan(x.shape[0], x.shape[1], *x.shape[2:], out_hw, via_hw, tile=tile)
            except ValueError:
                continue
            plans += 1
            differ += int((k4.launch(x, out_hw, via_hw, q) != got).sum())
        torch.cuda.synchronize()
        log(f"  upsample_argmax {name} {tuple(x.shape)} -> {out_hw}: {k4_plan_text(p)}")
        check(f"upsample_argmax {name} mismatched pixel share", share, MASK_SHARE)
        check(f"upsample_argmax {name}: pixels differing on a second launch and under "
              f"{plans} plans", int((got != again).sum()) + differ, 0)
        worst = max(worst, share)
    return worst


def phase_eval(eng32, eng16, cpu_eng):
    """[5] the eval path on the card against the CPU, each kernel against
    its plain version on the arguments the path gave it, and K5 on
    synthetic lists."""
    from multiyolov5_tpu_torch import evaluation as E
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.ops import kernels as K
    log(f"[5] eval path: evaluate_detection + seg_validation, {EVAL_BATCHES} batches of "
        f"bs{EVAL_BS} {IN_HW} from {ORIG_HW}, conf {EVAL_CONF}, iou {EVAL_IOU}, "
        f"multi-label, max_nms {EVAL_MAX_NMS}")
    det_b, seg_b = eval_batches(eng32, np.random.RandomState(SEED + 5))
    K.reset_launches()
    (det, _, _), seg, card = run_eval(eng32, det_b, seg_b, kernels=True)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    log(f"  launches on the eval path: {launches}")
    n_valid = [int(n) for a, _ in card["nms_greedy"] for n in (a[1] > 0).sum(1).tolist()]
    log(f"  (box, class) candidates above conf per image (N): {n_valid}")
    for k in ("stem", "stem_float", "conv3x3", "nms_greedy", "upsample_argmax"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the eval path")
    if launches["c3"] != len(card["net"]):
        raise AssertionError(f"K7 launched {launches['c3']} times in {len(card['net'])} "
                             f"bs{EVAL_BS} eval forwards, not once each")
    errs = hold_eval_kernels(card)

    (det_cpu, _, _), seg_cpu, cpu = run_eval(cpu_eng, det_b, seg_b, kernels=False)
    for (z_card, seg_card), (z_cpu, seg_cpu_l) in zip(card["net"], cpu["net"]):
        z_card, seg_card = z_card.cpu(), seg_card.cpu()
        check(f"network fp32 bs{EVAL_BS} card vs CPU: boxes max|diff|/max(max|ref|,1)",
              diffs(z_card[:, :4], z_cpu[:, :4])[1], NET_REL)
        check(f"network fp32 bs{EVAL_BS} card vs CPU: obj/cls max|diff|",
              diffs(z_card[:, 4:], z_cpu[:, 4:])[0], NET_REL)
        check(f"network fp32 bs{EVAL_BS} card vs CPU: seg logits max|diff|/max(max|ref|,1)",
              diffs(seg_card, seg_cpu_l)[1], NET_REL)
    n_card = [len(d) for d in card["dets"]]
    n_cpu = [len(d) for d in cpu["dets"]]
    log(f"  detections per image, card {n_card}, CPU {n_cpu}")
    check("eval fp32 card vs CPU: per-image detection counts differing",
          sum(a != b for a, b in zip(n_card, n_cpu)), 0)
    for name, a, b in zip(("P", "R", "mAP@.5", "mAP@.5:.95"), det, det_cpu):
        log(f"  {name}: card {a:.6f}, CPU {b:.6f}")
        check(f"eval fp32 card vs CPU: {name} |diff|", abs(a - b), EVAL_METRIC_ABS)
    for name, a, b in zip(("pixAcc", "mIoU"), seg, seg_cpu):
        log(f"  {name}: card {a:.6f}, CPU {b:.6f}")
        check(f"seg_validation fp32 card vs CPU: {name} |diff|", abs(a - b), SEG_METRIC_ABS)
    if not (0.0 < det[2] < 1.0 and 0.0 < seg[1] < 1.0):
        raise AssertionError(f"degenerate metrics: mAP@.5 {det[2]}, mIoU {seg[1]}")

    # evaluate_detection on the CPU over the card's own network outputs: the
    # NMS (sort, K5's plain version), matching and AP must reproduce the
    # card's detections and metrics exactly
    outs = iter(card["net"][:EVAL_BATCHES])
    replay_dets = []
    with replaced(Engine, "forward", lambda self, x: tuple(t.cpu() for t in next(outs))), \
            spied(E, "non_max_suppression", after=replay_dets.extend):
        replay = quiet(E.evaluate_detection, cpu_eng, det_b, conf_thres=EVAL_CONF,
                       iou_thres=EVAL_IOU)[0]
    worst = max(float(np.abs(a - b).max(initial=0.0)) if a.shape == b.shape else np.inf
                for a, b in zip(card["dets"], replay_dets))
    check("eval detections, card vs CPU on the card's network outputs: max |diff|", worst, 0.0)
    check("eval P, R, mAP, card vs CPU on the card's network outputs: max |diff|",
          max(abs(a - b) for a, b in zip(det[:4], replay[:4])), 0.0)

    (det16, _, _), seg16, _ = run_eval(eng16, det_b, seg_b, kernels=False)
    log(f"  bf16 (reported, no bound): P {det16[0]:.6f} R {det16[1]:.6f} "
        f"mAP@.5 {det16[2]:.6f} mAP@.5:.95 {det16[3]:.6f}; pixAcc {seg16[0]:.6f} "
        f"mIoU {seg16[1]:.6f}")

    # a rect eval batch shape (H = IN_HW[0] + 64): K1 and K2 take it
    frame = (np.random.RandomState(SEED + 7).rand(1, IN_HW[0] + 64, IN_HW[1], 3) * 255
             ).astype(np.uint8)
    card_out = eng32.forward(torch.from_numpy(frame).to(DEVICE))
    cpu_out = cpu_eng.forward(torch.from_numpy(frame))
    for name, sl, rel in (("boxes", slice(0, 4), True), ("obj/cls", slice(4, None), False)):
        d = diffs(card_out[0][:, sl].cpu(), cpu_out[0][:, sl])
        check(f"network fp32 card vs CPU at {frame.shape[1:3]}: {name} max|diff|"
              + ("/max(max|ref|,1)" if rel else ""), d[1] if rel else d[0], NET_REL)
    check(f"network fp32 card vs CPU at {frame.shape[1:3]}: seg logits max|diff|/max(max|ref|,1)",
          diffs(card_out[1].cpu(), cpu_out[1])[1], NET_REL)

    # K5 against its plain version on synthetic lists: one list each of
    # 1025, 4224 and 30000 rows, eight of 30000 (more 16-CTA clusters than
    # the card places at once) and one of 262144 (boxes in device memory)
    rng = np.random.RandomState(SEED + 6)
    calls = []
    for bsz, n in ((1, 1025), (1, 4224), (1, 30000), (8, 30000), (1, 262144)):
        xy = rng.rand(bsz, n, 2) * 600
        wh = rng.rand(bsz, n, 2) * 60 + 30
        off = rng.randint(0, 10, (bsz, n, 1)) * 4096.0
        boxes = torch.from_numpy(np.concatenate([xy - wh / 2 + off, xy + wh / 2 + off], 2)
                                 .astype(np.float32)).to(DEVICE)
        scores = torch.from_numpy(np.sort(rng.randint(1, 200, (bsz, n)).astype(np.float32)
                                          / 200, 1)[:, ::-1].copy()).to(DEVICE)
        calls.append(((boxes, scores, EVAL_IOU, 300), {}))
    hold_k5(calls, "synthetic lists")
    del calls
    # K3 and K4 beyond the paths' own arguments: chains, invalid and ragged
    # lists, the batched and ragged class maps, every K4 plan
    errs["nms_lists"] = hold_k3()
    errs["upsample_argmax_cases"] = hold_k4()
    return {"launches": launches, "errs": errs, "rec": card, "det_b": det_b, "n": n_valid,
            "metrics": {"fp32": {"card": list(det[:4]) + list(seg),
                                 "cpu": list(det_cpu[:4]) + list(seg_cpu)},
                        "bf16_card": list(det16[:4]) + list(seg16)}}


def k5_reading(boxes, scores, iou, max_det) -> dict:
    """K5's device ms on these lists, its plan, picks, ms a pick (a pick is
    a step of every image at once), the IoU tests the data needs and the
    bound from them; logged."""
    from multiyolov5_tpu_torch.ops import kernels as K
    bsz, n = scores.shape
    ms = graph_ms(lambda: K.nms_greedy(boxes, scores, iou, max_det), iters=5, replays=3)
    idx, valid = K.nms_greedy(boxes, scores, iou, max_det)
    tests = greedy_tests(boxes, scores, idx, valid, iou)
    bound, by = bound_ms(20 * scores.numel() + 5 * idx.numel(), K5_OPS_PER_TEST * tests,
                         FP32_FLOP_S)
    steps = int(valid.sum(1).max())
    r = {"shape": [bsz, n], "plan": k5_plan_text(bsz, n), "ms": ms, "picks": int(valid.sum()),
         "ms_per_pick": ms / max(steps, 1), "tests": tests, "bound_ms": bound, "bound_by": by}
    log(f"  nms_greedy {tuple(scores.shape)} iou {iou}: {ms:.4f} ms, {r['picks']} picks "
        f"({r['ms_per_pick'] * 1e3:.2f} us a step of {steps}), {tests} IoU tests, bound "
        f"{bound:.5f} ms ({by}); {r['plan']}")
    return r


def phase_timing(eng32, eng16, frames, sites16, nms_in, ev):
    """[6] bs1 serving and bs4 eval time, and each kernel against its plain
    version, its bound and, where there is one, a PyTorch call of the same
    function."""
    import torch.nn.functional as F

    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops.kernels.conv3x3 import plan as conv_plan
    dev = torch.device(DEVICE)
    log("[6] timing: kernels on the card's clock (CUDA graph replay, no host gaps); "
        "Engine and the eval entry points on the host clock around synchronised calls")
    e2e = {}
    for name, eng in (("fp32", eng32), ("bf16", eng16)):
        for f in frames:
            eng(f, ORIG_HW)
        reps = []
        for _ in range(5):             # the host is shared: report the spread
            n = 20
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                eng(frames[i % len(frames)], ORIG_HW)
            reps.append((time.perf_counter() - t0) * 1e3 / n)
        ms = float(np.median(reps))
        e2e[name] = {"median_ms": ms, "reps_ms": reps}
        log(f"  Engine.__call__ bs1 {name}: median {ms:.3f} ms/frame ({1e3 / ms:.1f} FPS) "
            f"over 5 reps of 20, range {min(reps):.3f}-{max(reps):.3f}")

    from multiyolov5_tpu_torch.evaluation import evaluate_detection
    n_img = EVAL_BS * EVAL_BATCHES
    for name, eng in (("fp32", eng32), ("bf16", eng16)):
        def run():
            return quiet(evaluate_detection, eng, ev["det_b"], conf_thres=EVAL_CONF,
                         iou_thres=EVAL_IOU)[2]
        run()
        reps, shares = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, t_nms, _ = run()
            t_det = time.perf_counter() - t0
            reps.append(t_det * 1e3 / n_img)
            shares.append(t_nms / t_det)
        ms = float(np.median(reps))
        e2e[f"eval_{name}"] = {"median_ms_per_image": ms, "reps_ms_per_image": reps,
                               "nms_share": shares}
        log(f"  evaluate_detection bs{EVAL_BS} {name}: median {ms:.3f} ms/image over 3 reps "
            f"of {n_img} images, range {min(reps):.3f}-{max(reps):.3f}; NMS share of it "
            f"{min(shares):.3f}-{max(shares):.3f}")

    frame = torch.from_numpy(frames[0][None]).to(dev)
    w = eng16.stem_weights
    times = {"stem": (graph_ms(lambda: K.stem(frame, *w, out_dtype=torch.bfloat16)),
                      graph_ms(lambda: K.stem_plain(frame, *w, out_dtype=torch.bfloat16)))}
    # the stem's two convolutions through cuDNN in bf16, K1's bf16 form's type
    library = {"stem": stem_library_ms(frame, w, torch.bfloat16)}
    bounds = {"stem": stem_bound(frame, w, torch.bfloat16)}
    # K1 bf16 at the batched server's shape: bs8 1024x1024 frames
    fr8 = torch.randint(0, 256, (SERVE_BS, SERVE_IMG, SERVE_IMG, 3), device=dev,
                        dtype=torch.uint8, generator=torch.Generator(device=dev).manual_seed(SEED))
    stem_bs8 = {"frame": list(fr8.shape),
                "ms": graph_ms(lambda: K.stem(fr8, *w, out_dtype=torch.bfloat16), iters=5),
                "library_ms": stem_library_ms(fr8, w, torch.bfloat16),
                "bound": stem_bound(fr8, w, torch.bfloat16),
                "bound_fp32": stem_bound(fr8, w, torch.float32, cuda_cores=True)}
    log(f"  stem bf16 at bs{SERVE_BS} {SERVE_IMG}x{SERVE_IMG}: kernel {stem_bs8['ms']:.4f} ms, "
        f"cuDNN conv2d x2 (bf16) {stem_bs8['library_ms']:.4f} ms, bound "
        f"{stem_bs8['bound'][0]:.5f} ms ({stem_bs8['bound'][1]}; fp32 on the CUDA cores "
        f"{stem_bs8['bound_fp32'][0]:.5f})")

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    k_ms = p_ms = l_ms = b_ms = t_bytes = t_ops = 0.0
    per_site = []
    for shape, co, s, d, act, wt, b in sites16:
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        km = graph_ms(lambda: K.conv3x3(x, wt, b, s, d, act))
        pm = graph_ms(lambda: K.conv3x3_plain(x, wt, b, s, d, act))
        xc, wc, bc = x.permute(0, 3, 1, 2), wt.permute(0, 3, 1, 2), b.to(torch.bfloat16)
        lm = graph_ms(lambda: F.conv2d(xc, wc, bc, s, d, d))
        bsz, hh, ww, ci = shape
        ho, wo = (hh - 1) // s + 1, (ww - 1) // s + 1
        nbytes = 2 * (x.numel() + wt.numel() + bsz * ho * wo * co) + 4 * co
        flops = 2 * bsz * ho * wo * co * 9 * ci
        bm, _ = bound_ms(nbytes, flops, BF16_FLOP_S)
        per_site.append({"x": list(shape), "c_out": co, "stride": s, "dilation": d,
                         "plan": plan_text(conv_plan(bsz, ho, wo, ci, co, torch.bfloat16, s,
                                                     d)),
                         "ms": km, "plain_ms": pm, "library_ms": lm, "bound_ms": bm})
        k_ms, p_ms, l_ms, b_ms = k_ms + km, p_ms + pm, l_ms + lm, b_ms + bm
        t_bytes, t_ops = t_bytes + nbytes / HBM_BYTES_S, t_ops + flops / BF16_FLOP_S
    times["conv3x3"] = (k_ms, p_ms)
    library["conv3x3"] = l_ms
    bounds["conv3x3"] = (b_ms, "bytes" if t_bytes >= t_ops else "operations")
    log(f"  conv3x3 bf16 per site (bs1, {IN_HW[1]}x{IN_HW[0]}):")
    for r in per_site:
        log(f"    {tuple(r['x'])} -> {r['c_out']} s{r['stride']} d{r['dilation']} "
            f"{r['plan']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, cuDNN "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f}")
    # K2 in float32 at the eval path's sites (the first bs4 forward's 10
    # calls) and at pspv5x's bs1 sites (seeded weights and inputs), each
    # beside cuDNN in float32 (TF32 off) and both bounds
    log(f"  conv3x3 float32 at the eval path's {len(sites16)} bs{EVAL_BS} sites:")
    f32_sites, k2_f32 = time_k2_f32([(x, wt, b, kw.get("stride", 1), kw.get("dilation", 1),
                                      kw.get("act", True))
                                     for (x, wt, b), kw in ev["rec"]["conv3x3"][:len(sites16)]])
    log(f"  conv3x3 float32 eval sums: kernel {k2_f32['ms']:.4f} ms, plain "
        f"{k2_f32['plain_ms']:.4f}, cuDNN fp32 {k2_f32['library_ms']:.4f}, bound "
        f"{k2_f32['bound_ms']:.5f} (3xTF32; CUDA-core fp32 {k2_f32['cuda_core_bound_ms']:.5f})")
    k2_f32["sites"] = f32_sites
    from multiyolov5_tpu_torch.engine import Engine
    ex = Engine(cfg=X_CFG, device=DEVICE, half=False, seed=SEED)
    x_calls = [(torch.randn(shape, generator=g, device=dev), wt, b, s, d, act)
               for shape, co, s, d, act, wt, b in record_path_inputs(ex, frames[0])[0]]
    log(f"  conv3x3 float32 at {X_CFG}'s {len(x_calls)} bs1 sites:")
    x_sites, k2_x = time_k2_f32(x_calls)
    del ex, x_calls
    log(f"  conv3x3 float32 {X_CFG} sums: kernel {k2_x['ms']:.4f} ms, cuDNN fp32 "
        f"{k2_x['library_ms']:.4f}, bound {k2_x['bound_ms']:.5f} (3xTF32; CUDA-core fp32 "
        f"{k2_x['cuda_core_bound_ms']:.5f})")
    k2_x["sites"] = x_sites
    k2_f32[X_CFG] = k2_x
    k2_sweep = sweep_k2_plans(sites16)

    boxes, scores, iou = nms_in[0]
    # the plain NMS synchronises every fixpoint round: host clock between events
    times["nms"] = (graph_ms(lambda: K.nms(boxes, scores, iou)),
                    cuda_ms(lambda: K.nms_plain(boxes, scores, iou), iters=5, warmup=1))
    n = boxes.shape[0]
    bounds["nms"] = bound_ms(21 * n, K3_OPS_PER_TEST * n * (n - 1) / 2 + 3 * n, FP32_FLOP_S)
    # K3 with its pack (nms_packed, the serving path's call), and the keep
    # mask alone on the deepest chain and on an all-invalid list
    k3 = {"plan": k3_plan_text(n), "mask_ms": times["nms"][0],
          "packed_ms": graph_ms(lambda: K.nms_packed(boxes, scores, iou, 300)),
          "packed_plain_ms": cuda_ms(lambda: K.nms_packed_plain(boxes, scores, iou, 300),
                                     iters=5, warmup=1),
          "packed_bound_ms": bound_ms(21 * n + 9 * 300, K3_OPS_PER_TEST * n * (n - 1) / 2
                                      + 3 * n, FP32_FLOP_S)[0],
          "kept": int(K.nms_plain(boxes, scores, iou).sum())}
    for name, b, sc, t in k3_lists()[-2:]:
        k3[name.split(" n ")[0].replace(" ", "_") + "_ms"] = graph_ms(lambda: K.nms(b, sc, t))
    log(f"  nms (K3) on the serving list ({n} rows, {k3['kept']} kept): mask "
        f"{k3['mask_ms']:.4f} ms, with its pack {k3['packed_ms']:.4f} ms (plain "
        f"{k3['packed_plain_ms']:.4f}); chain {k3['chain_ms']:.4f} ms, all invalid "
        f"{k3['all_invalid_ms']:.4f} ms; {k3['plan']}")

    seg = torch.randn((1, 19, IN_HW[0] // 8, IN_HW[1] // 8), generator=g,
                      device=dev).to(torch.bfloat16)
    times["upsample_argmax"] = (
        graph_ms(lambda: K.upsample_argmax(seg, ORIG_HW, via_hw=IN_HW)),
        graph_ms(lambda: K.upsample_argmax_plain(seg, ORIG_HW, via_hw=IN_HW)))
    bounds["upsample_argmax"] = k4_bound(seg, ORIG_HW, IN_HW)

    # K4 as seg_validation launched it (the B5b row): bs4 float32 logits,
    # and at the bs8 server's shape (bf16, square letterboxed frames)
    from multiyolov5_tpu_torch.ops.kernels.upsample_argmax import plan as k4_plan
    (seg, out_hw), kw = ev["rec"]["upsample_argmax"][0]
    seg8 = torch.randn((SERVE_BS, 19, SERVE_IMG // 8, SERVE_IMG // 8), generator=g,
                       device=dev).to(torch.bfloat16)
    k4_eval = {}
    for name, x, o_hw, v_hw in (("eval", seg, out_hw, kw["via_hw"]),
                                ("bs8", seg8, ORIG_HW, (SERVE_IMG, SERVE_IMG))):
        k4_eval[name] = {
            "x": list(x.shape), "dtype": str(x.dtype)[6:],
            "plan": k4_plan_text(k4_plan(x.shape[0], x.shape[1], *x.shape[2:], tuple(o_hw),
                                         tuple(v_hw))),
            "ms": graph_ms(lambda: K.upsample_argmax(x, o_hw, via_hw=v_hw)),
            "plain_ms": graph_ms(lambda: K.upsample_argmax_plain(x, o_hw, via_hw=v_hw)),
            "bound": k4_bound(x, o_hw, v_hw)}
        r = k4_eval[name]
        log(f"  upsample_argmax {tuple(x.shape)} {r['dtype']} -> {tuple(o_hw)}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
            f"({r['bound'][1]}); {r['plan']}")

    # K5 at the eval path's candidate lists (the first batch's launch)
    (boxes, scores, iou, max_det), _ = ev["rec"]["nms_greedy"][0]
    k5 = {"eval": k5_reading(boxes, scores, iou, max_det)}
    times["nms_greedy"] = (k5["eval"]["ms"], cuda_ms(
        lambda: K.nms_greedy_plain(boxes, scores, iou, max_det), iters=1, warmup=1))
    bounds["nms_greedy"] = (k5["eval"]["bound_ms"], k5["eval"]["bound_by"])

    # Short lists: the first 1024 rows of each image's list, through K3 (one
    # call an image, keep masks packed by the kernel) and through one K5
    # launch, as a (4, 1024) list and inside the (4, 30000) list with the
    # rows past 1024 invalid (what an eval image with <= 1024 candidates
    # above conf gives)
    sb, ss = boxes[:, :1024].contiguous(), scores[:, :1024].contiguous()
    cut = scores.clone()
    cut[:, 1024:] = 0.0
    k5["short"] = k5_reading(sb, ss, iou, max_det)
    short = {
        "k3_x4_ms": graph_ms(lambda: [K.nms_packed(sb[i], ss[i], iou, max_det)
                                      for i in range(sb.shape[0])]),
        "k5_1024_ms": k5["short"]["ms"],
        "k5_30000_ms": graph_ms(lambda: K.nms_greedy(boxes, cut, iou, max_det)),
    }
    k3_idx = torch.stack([K.nms_packed(sb[i], ss[i], iou, max_det)[0]
                          for i in range(sb.shape[0])])
    k5_idx = K.nms_greedy(boxes, cut, iou, max_det)[0]
    short["picks_differing_k3_k5"] = int((k3_idx != k5_idx.long()).sum())
    short["picks"] = int((k5_idx >= 0).sum())
    # and at bs1 on the serving path's list, where nms_planar runs K3
    b1, s1, iou1 = nms_in[0]
    short["serving_k3_ms"] = graph_ms(lambda: K.nms_packed(b1, s1, iou1, 300))
    short["k3"] = k3
    k5["serving"] = k5_reading(b1[None].contiguous(), s1[None].contiguous(), iou1, 300)
    short["serving_k5_ms"] = k5["serving"]["ms"]
    # K5 at eight 1024-row lists (both eval batches' first rows: a bs8
    # batch's shape on eval's rows; [8] reads the bs8 server's own lists)
    (b2, s2, _, _), _ = ev["rec"]["nms_greedy"][1]
    k5["eval_rows_x8"] = k5_reading(torch.cat([sb, b2[:, :1024]]).contiguous(),
                           torch.cat([ss, s2[:, :1024]]).contiguous(), iou, max_det)
    short["k5"] = k5
    log(f"  serving list {tuple(s1.shape)}: K3 with its pack {short['serving_k3_ms']:.4f} ms, "
        f"K5 {short['serving_k5_ms']:.4f} ms")
    log(f"  short lists {tuple(ss.shape)}: K3 (packed) x{sb.shape[0]} "
        f"{short['k3_x4_ms']:.4f} ms, K5 (4, 1024) {short['k5_1024_ms']:.4f} ms, K5 "
        f"{tuple(scores.shape)} with 1024 valid {short['k5_30000_ms']:.4f} ms; picks "
        f"{short['picks']}, differing K3 vs K5 {short['picks_differing_k3_k5']} (reported)")
    # K7 at bs8 1024x1024 serving's row-2 C3 (bf16), at the eval path's
    # (float32, the counted eval run's own arguments) and at pspv5m's
    # (float32, c_ 48, two bottlenecks, bs2 1024x1024, seeded weights);
    # "library" is the unfused sequence the module runs otherwise (5 cuDNN
    # convs, cat, add; TF32 off): no single PyTorch call computes a C3
    c3_times = {}
    side = SERVE_IMG // 4
    (x_ev, *a_ev), _ = ev["rec"]["c3"][0]
    x_m, a_m = c3_case(g, (2, side, side, 96), 48, 2, torch.float32)
    for name, mod, x, args in (
            ("serving", c3_row(eng16), None, None),
            ("eval", c3_row(eng32), x_ev, tuple(a_ev)),
            ("pspv5m", c3_module(a_m), x_m, a_m)):
        args = args or mod.kernel_args()
        if x is None:
            x = torch.randn((SERVE_BS, side, side, args[0].shape[-1]), generator=g,
                            device=dev).to(torch.bfloat16)
        nbytes, flops = c3_work(x, args)
        c3_times[name] = {
            "x": list(x.shape), "dtype": str(x.dtype)[6:],
            "c_": args[0].shape[0], "n": len(args[6]),
            "ms": graph_ms(lambda: K.c3(x, *args)),
            "plain_ms": graph_ms(lambda: K.c3_plain(x, *args)),
            "library_ms": c3_sequence_ms(mod, x),
            "bound": c3_bound(x, args),
            "bytes": nbytes, "flops": flops}
        t = c3_times[name]
        if x.dtype == torch.float32:
            t["cuda_core_bound"] = c3_bound(x, args, cuda_cores=True)
        log(f"  c3 {name} {tuple(x.shape)} {t['dtype']} c_ {t['c_']} n {t['n']}: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library (sequence) "
            f"{t['library_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms ({t['bound'][1]}"
            + ("" if x.dtype == torch.bfloat16 else
               f", 3xTF32; CUDA-core fp32 {t['cuda_core_bound'][0]:.5f}")
            + f"; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    t = c3_times["serving"]
    times["c3"] = (t["ms"], t["plain_ms"])
    library["c3"] = t["library_ms"]
    bounds["c3"] = t["bound"]

    for k, (km, pm) in times.items():
        lib = library.get(k)
        log(f"  {k}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {bounds[k][0]:.5f} ms "
            f"({bounds[k][1]}), library call "
            + ("none" if lib is None else f"{lib:.4f} ms")
            + (f" (sum over {len(sites16)} sites)" if k == "conv3x3" else ""))
    return (e2e, times, per_site, library, bounds, k4_eval, short, c3_times, k2_f32, k2_sweep,
            stem_bs8)


def sweep_k2_plans(sites16):
    """K2 bf16 at each distinct pspv5s bs1 site under other launch plans than
    the planner's (tile 8x8 or 8x16 px, 64 or 128 channels, splits 1, 2, 3,
    6), each held to BF16_REL against plain: the evidence for plan()'s
    choice."""
    import importlib

    from multiyolov5_tpu_torch.ops import kernels as K
    kmod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.conv3x3")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    rows, seen = [], set()
    log("  conv3x3 bf16 launch plans per distinct site (planned, then the three fastest):")
    for shape, co, s, d, act, wt, b in sites16:
        if (shape, co, s) in seen:      # the dilation does not change the plan
            continue
        seen.add((shape, co, s))
        x = torch.randn(shape, generator=g, device=DEVICE).to(torch.bfloat16)
        bsz, hh, ww, ci = shape
        ho, wo = (hh - 1) // s + 1, (ww - 1) // s + 1
        planned = kmod.plan(bsz, ho, wo, ci, co, torch.bfloat16, s, d)
        want = K.conv3x3_plain(x, wt, b, s, d, act)
        nk = 9 * ci // planned.bk
        res = []
        for bm in (64, 128):
            for bn in (64, 128) if co % 128 == 0 else (64,):
                tiles = bsz * -(-ho // 8) * -(-wo // (bm // 8)) * -(-co // bn)
                for split in (1, 2, 3, 6):
                    if split > max(1, nk // 2) or tiles * split > 3 * 132:
                        continue
                    p = kmod.Plan(bm, bn, planned.bk, split, tiles, tiles * split,
                                  -(-nk // split))
                    got = kmod._launch(x, wt, b, s, d, act, p)
                    torch.cuda.synchronize()
                    check(f"conv3x3 plan {bm}/{bn}/{split} at {shape} max|diff|/max(max|ref|,1)",
                          diffs(got, want)[1], BF16_REL)
                    res.append({"bm": bm, "bn": bn, "split": split, "ctas": tiles * split,
                                "ms": graph_ms(lambda: kmod._launch(x, wt, b, s, d, act, p),
                                               iters=10, replays=3)})
        res.sort(key=lambda r: r["ms"])
        mine = next(r for r in res if (r["bm"], r["bn"], r["split"])
                    == (planned.bm, planned.bn, planned.split))
        rows.append({"x": list(shape), "c_out": co, "stride": s, "dilation": d,
                     "planned": mine, "plans": res})
        log(f"    {shape} -> {co} s{s} d{d}: planned 8x{planned.bm // 8}/{planned.bn}/"
            f"{planned.split} {mine['ms'] * 1e3:.2f} us; " + ", ".join(
                f"8x{r['bm'] // 8}/{r['bn']}/{r['split']} ({r['ctas']} CTAs) "
                f"{r['ms'] * 1e3:.2f} us" for r in res[:3]))
    return rows


def serve(server, frames, clients: int = 1):
    """Submit ``frames`` to ``server`` from ``clients`` threads (contiguous
    shares, each thread submitting its share in order) and return the
    results in frame order."""
    import threading
    futs = [None] * len(frames)
    per = -(-len(frames) // clients)

    def client(i0):
        for i in range(i0, min(i0 + per, len(frames))):
            futs[i] = server.submit(frames[i])

    threads = [threading.Thread(target=client, args=(i0,)) for i0 in range(0, len(frames), per)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [f.result(timeout=600) for f in futs]


def same_outputs(a, b) -> bool:
    """Two (dets, class map) results equal to the bit."""
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def phase_serving(eng32, eng16, cpu_eng):
    """[8] batched serving: InferenceServer on the card against Engine on the
    same letterboxed batches, K7 once per batched forward, the float32
    server against a CPU server, a pspv5m bs2 forward against the CPU's,
    and the serving readings."""
    from multiyolov5_tpu_torch.data.letterbox import letterbox
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.serving import InferenceServer
    n_main = SERVE_CLIENTS * SERVE_PER_CLIENT
    log(f"[8] batched serving: InferenceServer(max_batch {SERVE_BS}, img_size {SERVE_IMG}, "
        f"max_wait {SERVE_WAIT_MS} ms, conf {CONF}) on seeded BGR {ORIG_HW} frames: "
        f"{n_main} from {SERVE_CLIENTS} client threads, then {SERVE_TAIL}")
    rng = np.random.RandomState(SEED + 13)
    frames = [rng.randint(0, 256, (*ORIG_HW, 3)).astype(np.uint8)
              for _ in range(n_main + SERVE_TAIL)]
    res = {}

    # bf16 server; every engine call recorded with its batch and outputs,
    # and K5's and K4's arguments
    from multiyolov5_tpu_torch import engine as engine_mod
    from multiyolov5_tpu_torch.ops import nms as nms_mod
    calls, k5_calls, k4_calls = [], [], []
    real_call = Engine.__call__

    def recorded(self, x, *a, **kw):
        out = real_call(self, x, *a, **kw)
        calls.append((self, x.clone(), out))
        return out

    server = InferenceServer(engine=eng16, img_size=SERVE_IMG, max_batch=SERVE_BS,
                             max_wait_ms=SERVE_WAIT_MS, conf=CONF)
    try:
        server.warmup(ORIG_HW)
        torch.cuda.synchronize()
        K.reset_launches()
        with replaced(Engine, "__call__", recorded), \
                spied(nms_mod, "nms_greedy", before=recorder(k5_calls)), \
                spied(engine_mod, "upsample_argmax", before=recorder(k4_calls)):
            got = serve(server, frames[:n_main], SERVE_CLIENTS)
            got += serve(server, frames[n_main:])
        torch.cuda.synchronize()
        launches = K.launch_counts()
    finally:
        server.close()
    sizes = [tuple(x.shape) for _, x, _ in calls]
    log(f"  batches {sizes}; launches {launches}")
    # which batch row holds each frame: letterbox it as the server does
    where = []
    for f in frames:
        lb = letterbox(f, SERVE_IMG, auto=False, stride=eng16.stride, device=DEVICE)[0].flip(-1)
        hits = [(j, r) for j, (_, x, _) in enumerate(calls) for r in range(x.shape[0])
                if torch.equal(x[r], lb)]
        if not hits:
            raise AssertionError("a frame is in no served batch")
        where.append(hits[0])
    n_real = [1 + max(r for j, r in where if j == i) for i in range(len(calls))]
    padded = [(n, x.shape[0]) for n, (_, x, _) in zip(n_real, calls) if n < x.shape[0]]
    for (_, x, _), n in zip(calls, n_real):
        if not all(torch.equal(x[r], x[n - 1]) for r in range(n, x.shape[0])):
            raise AssertionError("a bucket is not padded with its last frame")
    if not padded:
        raise AssertionError(f"no padded bucket among the batches {sizes}")
    batched = sum(x.shape[0] > 1 for _, x, _ in calls)
    check("K7 launches - batched forwards (bs > 1)", abs(launches["c3"] - batched), 0)
    want = {"stem": len(calls), "conv3x3": 10 * len(calls), "nms": len(calls) - batched,
            "nms_greedy": batched, "upsample_argmax": len(calls)}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"server launches {launches}, want {want}")
    # each result against Engine on the same letterboxed batch, padded to its bucket
    differ = 0
    for (j, r), out in zip(where, got):
        eng, x, (dets, masks) = calls[j]
        differ += not same_outputs(out, (dets[r], masks[r]))
    for eng, x, (dets, masks) in calls:
        d2, m2 = eng16(x, ORIG_HW, conf=CONF)
        differ += sum(not same_outputs((a, b), (c, e)) for a, b, c, e in zip(dets, masks, d2, m2))
    check("bf16 server results (and their batches' rows) differing from Engine on the "
          "same padded batch", differ, 0)
    for d, m in got:
        if not (np.isfinite(d).all() and d.shape[1] == 6 and m.shape == ORIG_HW
                and m.dtype == np.uint8):
            raise AssertionError("malformed server output")
    # K5 against its plain version on the server's batched lists, and its
    # time on the first full batch's
    hold_k5(k5_calls, "the bs8 server's lists")
    full = [a for a, _ in k5_calls if a[1].shape[0] == SERVE_BS]
    res["k5"] = k5_reading(*full[0]) if full else None
    del k5_calls, full
    # K4 against its plain version on the server's launches, and its time on
    # the first full batch's logits
    share = 0.0
    for (x, out_hw), kw in k4_calls:
        cmap = K.upsample_argmax(x, out_hw, **kw)
        share = max(share, (cmap != K.upsample_argmax_plain(x, out_hw, **kw)).float().mean()
                    .item())
    check(f"upsample_argmax at the server's {sorted({tuple(a[0].shape) for a, _ in k4_calls})} "
          f"mismatched pixel share", share, MASK_SHARE)
    full = [(a, kw) for a, kw in k4_calls if a[0].shape[0] == SERVE_BS]
    res["k4"] = None
    if full:
        (x, out_hw), kw = full[0]
        res["k4"] = {"x": list(x.shape), "dtype": str(x.dtype)[6:], "share": share,
                     "ms": graph_ms(lambda: K.upsample_argmax(x, out_hw, **kw)),
                     "bound_ms": k4_bound(x, out_hw, kw["via_hw"])[0]}
        log(f"  upsample_argmax on the server's {tuple(x.shape)} {res['k4']['dtype']} "
            f"logits: {res['k4']['ms']:.4f} ms (bound {res['k4']['bound_ms']:.5f}), "
            f"mismatched share {share:.2e}")
    del k4_calls, full
    res.update(batches=sizes, padded=padded, launches=launches, stats=server.stats(),
               dets_per_frame=[len(d) for d, _ in got])

    # the float32 server on the card against one on the CPU, on 2 frames
    runs = {}
    for name, eng in (("card", eng32), ("cpu", cpu_eng)):
        rec = {"x": [], "net": []}
        srv = InferenceServer(engine=eng, img_size=SERVE_IMG, max_batch=SERVE_BS,
                              max_wait_ms=1000, conf=CONF)
        t0 = time.perf_counter()
        try:
            with spied(Engine, "__call__", before=lambda self, x, *a, **k: rec["x"].append(x)), \
                    spied(Engine, "forward", after=rec["net"].append):
                outs = serve(srv, frames[:2])
        finally:
            srv.close()
        runs[name] = (outs, rec, time.perf_counter() - t0)
    (outs_c, rec_c, _), (outs_h, rec_h, t_cpu) = runs["card"], runs["cpu"]
    log(f"  fp32 server, card vs CPU on 2 frames (the CPU server took {t_cpu:.1f} s)")
    if not (len(rec_c["x"]) == len(rec_h["x"]) == 1 and rec_c["x"][0].shape[0] == 2):
        raise AssertionError("the 2 frames were not served as one bs2 batch")
    check("letterboxed bs2 batch, card vs CPU: pixels differing",
          int((rec_c["x"][0].cpu() != rec_h["x"][0]).sum()), 0)
    (z_card, seg_card), (z_cpu, seg_cpu) = rec_c["net"][0], rec_h["net"][0]
    z_card, seg_card = z_card.cpu(), seg_card.cpu()
    check("network fp32 bs2 card vs CPU: boxes max|diff|/max(max|ref|,1)",
          diffs(z_card[:, :4], z_cpu[:, :4])[1], NET_REL)
    check("network fp32 bs2 card vs CPU: obj/cls max|diff|",
          diffs(z_card[:, 4:], z_cpu[:, 4:])[0], NET_REL)
    check("network fp32 bs2 card vs CPU: seg logits max|diff|/max(max|ref|,1)",
          diffs(seg_card, seg_cpu)[1], NET_REL)
    in_hw = (SERVE_IMG, SERVE_IMG)
    post_card = eng32.postprocess(z_card.to(DEVICE), seg_card.to(DEVICE), in_hw, ORIG_HW,
                                  conf=CONF)
    post_cpu = cpu_eng.postprocess(z_card, seg_card, in_hw, ORIG_HW, conf=CONF)
    compare_runs("server post-processing (bs2 NMS on K5, unmap, mask) card vs CPU on the "
                 "card's network outputs", post_card, post_cpu, MATCH_SHARE, BOX_PX,
                 SCORE_ABS, MASK_SHARE)
    merge = lambda outs: ([d for d, _ in outs], [m for _, m in outs])  # noqa: E731
    compare_runs("fp32 server end to end card vs CPU", merge(outs_c), merge(outs_h),
                 E2E_MATCH_SHARE, BOX_PX, E2E_SCORE_ABS, E2E_MASK_SHARE)

    # pspv5m: the float32 bs2 forward at SERVE_IMG x SERVE_IMG, card against CPU
    spec_m = load_spec(M_CFG)
    sd_m = seeded_state_dict(spec_m, SEED)
    m_card = Engine(spec=spec_m, state_dict=sd_m, device=DEVICE, half=False)
    m_cpu = Engine(spec=spec_m, state_dict=sd_m, device="cpu", half=False)
    del sd_m
    x = rec_h["x"][0]
    K.reset_launches()
    zm_card, segm_card = m_card.forward(x.to(DEVICE))
    torch.cuda.synchronize()
    m_launches = K.launch_counts()
    check(f"{M_CFG} bs2 forward: K7 launches - 1", abs(m_launches["c3"] - 1), 0)
    zm_cpu, segm_cpu = m_cpu.forward(x)
    zm_card, segm_card = zm_card.cpu(), segm_card.cpu()
    check(f"network fp32 {M_CFG} bs2 card vs CPU: boxes max|diff|/max(max|ref|,1)",
          diffs(zm_card[:, :4], zm_cpu[:, :4])[1], NET_REL)
    check(f"network fp32 {M_CFG} bs2 card vs CPU: obj/cls max|diff|",
          diffs(zm_card[:, 4:], zm_cpu[:, 4:])[0], NET_REL)
    check(f"network fp32 {M_CFG} bs2 card vs CPU: seg logits max|diff|/max(max|ref|,1)",
          diffs(segm_card, segm_cpu)[1], NET_REL)
    c3m = c3_row(m_card)
    res["pspv5m"] = {"launches": m_launches, "c3_c_": c3m.cv1.conv.out_channels,
                     "c3_n": len(c3m.m)}
    del m_card, m_cpu

    # readings, bf16: the server's frames/s, Engine at bs8 and bs1 on 1024x1024
    server = InferenceServer(engine=eng16, img_size=SERVE_IMG, max_batch=SERVE_BS,
                             max_wait_ms=SERVE_WAIT_MS, conf=CONF)
    n_burst = 4 * SERVE_BS
    burst = [frames[i % len(frames)] for i in range(n_burst)]
    reps = []
    try:
        serve(server, burst[:SERVE_BS])
        for _ in range(3):
            t0 = time.perf_counter()
            serve(server, burst, SERVE_CLIENTS)
            reps.append((time.perf_counter() - t0) * 1e3 / n_burst)
        stats = server.stats()
    finally:
        server.close()
    x8 = server.letterbox_batch(frames[:SERVE_BS])
    readings = {"server_bs8": {"ms_per_frame": reps, "frames_per_s": [1e3 / r for r in reps],
                               "stats": stats}}
    for name, xb, n in (("engine_bs8", x8, 5), ("engine_bs1", x8[:1], 10)):
        eng16(xb, ORIG_HW, conf=CONF)
        rr = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                eng16(xb, ORIG_HW, conf=CONF)
            rr.append((time.perf_counter() - t0) * 1e3 / n / xb.shape[0])
        readings[name] = {"ms_per_frame": rr}
    ms = float(np.median(reps))
    log(f"  InferenceServer bs{SERVE_BS} bf16: median {ms:.3f} ms/frame ({1e3 / ms:.1f} "
        f"frames/s) over 3 bursts of {n_burst} frames from {SERVE_CLIENTS} threads, range "
        f"{min(reps):.3f}-{max(reps):.3f}; mean batch {stats['mean_batch']:.2f}")
    for name in ("engine_bs8", "engine_bs1"):
        rr = readings[name]["ms_per_frame"]
        log(f"  Engine.__call__ {name[-3:]} bf16 at {in_hw} -> {ORIG_HW}: median "
            f"{float(np.median(rr)):.3f} ms/frame over 5 reps, range {min(rr):.3f}-{max(rr):.3f}")
    res["readings"] = readings
    return res


def stem_bound(frame, w, out_dtype, cuda_cores: bool = False):
    """(least ms, "bytes" or "operations") of K1 on ``frame`` at the
    arithmetic its form does: the frame read once, the weights once, the
    output written once; 2 flops a MAC of the two folded convs.  A bfloat16
    output: bf16 weights on the bf16 tensor cores.  A float32 output: the
    3xTF32 form's products (3 a MAC; 2 for conv1 on a uint8 or bfloat16
    frame, exact in tf32) at the TF32 peak; with
    ``cuda_cores``, one float32 FMA a MAC at the CUDA cores' peak instead,
    the first form's arithmetic."""
    bsz, h, wd, _ = frame.shape
    c_mid, c_out = w[0].shape[-1], w[2].shape[-1]
    px = bsz * (h // 4) * (wd // 4)
    mac1, mac2 = px * 9 * 48 * c_mid, px * 4 * c_mid * c_out
    nw = w[0].numel() + w[2].numel()
    nbias = 4 * (w[1].numel() + w[3].numel())
    nframe = frame.numel() * frame.element_size()
    if out_dtype == torch.bfloat16:
        return bound_ms(nframe + 2 * nw + nbias + 2 * px * c_out, 2 * (mac1 + mac2),
                        BF16_FLOP_S)
    if cuda_cores:
        return bound_ms(nframe + 4 * nw + nbias + 4 * px * c_out, 2 * (mac1 + mac2),
                        FP32_FLOP_S)
    p1 = 3 if frame.dtype == torch.float32 else 2
    return bound_ms(nframe + 4 * nw + nbias + 4 * px * c_out, 2 * (p1 * mac1 + 3 * mac2),
                    TF32_FLOP_S)


def stem_library_ms(frame, w, dtype):
    """The stem's two convolutions as cuDNN ``conv2d`` calls on the
    space-to-depth input, in ``dtype`` (TF32 off for float32)."""
    import torch.nn.functional as F

    from multiyolov5_tpu_torch.ops.kernels.stem import space_to_depth4
    x48 = space_to_depth4(frame).to(dtype)
    w1, b1, w2, b2 = (w[0].permute(3, 2, 0, 1).contiguous().to(dtype), w[1].to(dtype),
                      w[2].permute(3, 2, 0, 1).contiguous().to(dtype), w[3].to(dtype))
    y1p = F.pad(F.silu(F.conv2d(x48, w1, b1, padding=1)), (1, 0, 1, 0))
    return (graph_ms(lambda: F.conv2d(x48, w1, b1, padding=1))
            + graph_ms(lambda: F.conv2d(y1p, w2, b2)))


def hold_stem_modes(widths):
    """K1 against ``stem_plain``: its float mode (B1c) on float32 frames ->
    float32 (the 3xTF32 form) and bfloat16 frames -> bfloat16 in [0, 1] off
    the k/255 lattice, and its uint8 mode -> float32 (eval's detection
    batches) and -> bfloat16 (serving), at bs 1 and 4 on IN_HW frames; each
    case timed beside its bound at the form's arithmetic (a float32 output
    also at the CUDA cores' float32 rate), its plain version and the cuDNN
    pair in the output's dtype.  ``widths``: {name: (uint8 weights, float
    weights)} of real engines."""
    from multiyolov5_tpu_torch.ops import kernels as K
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    rows = []
    for width, (w_u8, w_f) in widths.items():
        for bsz in STEM_BATCHES:
            u8 = torch.randint(0, 256, (bsz, *IN_HW, 3), generator=g, device=DEVICE,
                               dtype=torch.uint8)
            f32 = torch.rand((bsz, *IN_HW, 3), generator=g, device=DEVICE)
            cases = [("float", f32, w_f, torch.float32, F32_REL),
                     ("float", f32.to(torch.bfloat16), w_f, torch.bfloat16, BF16_REL),
                     ("uint8", u8, w_u8, torch.float32, F32_REL),
                     ("uint8", u8, w_u8, torch.bfloat16, BF16_REL)]
            for mode, frame, w, odt, bound in cases:
                lib = stem_library_ms(frame, w, odt)
                got = K.stem(frame, *w, out_dtype=odt)
                torch.cuda.synchronize()
                d, rel = diffs(got, K.stem_plain(frame, *w, out_dtype=odt))
                name = (f"stem {mode} {width} width (c_mid {w[0].shape[-1]}) "
                        f"{str(frame.dtype)[6:]} {tuple(frame.shape)} -> {str(odt)[6:]}")
                check(f"{name} max|diff|/max(max|ref|,1)", rel, bound)
                bm, by = stem_bound(frame, w, odt)
                row = {"mode": mode, "width": width, "c_mid": w[0].shape[-1],
                       "frame": list(frame.shape), "frame_dtype": str(frame.dtype)[6:],
                       "out_dtype": str(odt)[6:], "max_abs_err": d, "rel_err": rel,
                       "ms": graph_ms(lambda: K.stem(frame, *w, out_dtype=odt), iters=10),
                       "plain_ms": graph_ms(lambda: K.stem_plain(frame, *w, out_dtype=odt),
                                            iters=10),
                       "library_ms": lib, "bound_ms": bm, "bound_by": by}
                cores = ""
                if odt == torch.float32:
                    row["cuda_core_bound_ms"] = stem_bound(frame, w, odt, cuda_cores=True)[0]
                    cores = f"; fp32 on the CUDA cores {row['cuda_core_bound_ms']:.5f}"
                rows.append(row)
                log(f"  {name}: max|diff| {d:.3e}; kernel {row['ms']:.4f} ms, plain "
                    f"{row['plain_ms']:.4f} ms, cuDNN conv2d x2 ({str(odt)[6:]}) {lib:.4f} ms, "
                    f"bound {bm:.5f} ms ({by}{cores})")
    return rows


def k2_sites(model) -> int:
    """The K2 sites of a fused model (one launch each a forward)."""
    from multiyolov5_tpu_torch.models import blocks
    return sum(1 for m in model.modules()
               if isinstance(m, (blocks.Conv, blocks.ConvBN)) and m.kernel)




def frame_ms(eng, frame):
    """Engine.__call__ ms/frame: FAMILY_REPS reps of FAMILY_ITERS calls."""
    eng(frame, ORIG_HW, conf=CONF)
    reps = []
    for _ in range(FAMILY_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FAMILY_ITERS):
            eng(frame, ORIG_HW, conf=CONF)
        reps.append((time.perf_counter() - t0) * 1e3 / FAMILY_ITERS)
    return reps


def forward64(eng, x):
    """A CPU engine's network in float64, folded stem included: the
    reference of [9]'s float32 checks."""
    import copy

    import torch.nn.functional as F

    from multiyolov5_tpu_torch.ops.kernels.stem import space_to_depth4
    model = copy.deepcopy(eng.model).double()
    w1, b1, w2, b2 = (t.double() for t in eng.stem_weights)
    with torch.inference_mode():
        y = F.silu(F.conv2d(space_to_depth4(x).double(), w1.permute(3, 2, 0, 1), b1, padding=1))
        y = F.silu(F.conv2d(F.pad(y, (1, 0, 1, 0)), w2.permute(3, 2, 0, 1), b2))
        z, seg = model(y, start_layer=2)
    return z, None if seg is None else seg.float()


def run_family(cfg, frame):
    """One configuration at bs1 on seeded weights: launches; the card's
    fp32 network against float64 and its post-processing against the CPU's;
    bf16 against fp32 beside the CPU's own bf16 drift; every K2 site
    against its plain version; ms/frame."""
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.ops import kernels as K
    spec = load_spec(cfg)
    sd = seeded_state_dict(spec, SEED)
    e32 = Engine(spec=spec, state_dict=sd, device=DEVICE, half=False)
    e16 = Engine(spec=spec, state_dict=sd, device=DEVICE, half=True)
    cpu = Engine(spec=spec, state_dict=sd, device="cpu", half=False)
    n_k2 = k2_sites(e32.model)
    seg = spec.seg_index is not None
    log(f"  {cfg}: {len(spec.rows)} rows, seg head "
        f"{spec.rows[spec.seg_index].module if seg else 'none'}, strides {spec.strides}, "
        f"stem c_mid {e32.stem_weights[0].shape[-1]}, {n_k2} K2 sites")
    x = torch.from_numpy(frame[None]).to(DEVICE)
    K.reset_launches()
    z_card, seg_card = e32.forward(x)
    card = e32.postprocess(z_card, seg_card, IN_HW, ORIG_HW, conf=CONF)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    want = {"stem": 1, "stem_float": 0, "conv3x3": n_k2, "nms": 1, "nms_greedy": 0,
            "upsample_argmax": int(seg), "c3": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{cfg} bs1 launches {launches}, want {want}")
    t0 = time.perf_counter()
    z_cpu, seg_cpu = cpu.forward(x.cpu())
    t_cpu = time.perf_counter() - t0
    ref = cpu.postprocess(z_cpu, seg_cpu, IN_HW, ORIG_HW, conf=CONF)
    if not seg and (seg_card is not None or seg_cpu is not None or card[1] != [None]):
        raise AssertionError(f"{cfg}: a detection-only model gave a seg output")
    z64, seg64 = forward64(cpu, x.cpu())
    z_card = z_card.cpu()
    net = {}
    for what, sl, rel in (("boxes", slice(0, 4), True), ("obj/cls", slice(4, None), False),
                          ("seg logits", None, True)):
        if sl is None and not seg:
            continue
        a_c, a_p, a_r = ((z_card[:, sl], z_cpu[:, sl], z64[:, sl]) if sl is not None
                         else (seg_card.cpu(), seg_cpu, seg64))
        k = 1 if rel else 0
        e_card, e_cpu, e_cc = diffs(a_c, a_r)[k], diffs(a_p, a_r)[k], diffs(a_c, a_p)[k]
        net[what] = {"card_vs_f64": e_card, "cpu_vs_f64": e_cpu, "card_vs_cpu": e_cc}
        unit = "max|diff|/max(max|ref|,1)" if rel else "max|diff|"
        log(f"  {cfg} network fp32 {what} {unit}: card vs CPU {e_cc:.3e}; against float64, "
            f"card {e_card:.3e}, CPU {e_cpu:.3e}")
        check(f"{cfg} network fp32 card vs float64: {what} {unit}", e_card,
              max(NET_REL, F64_FACTOR * e_cpu))
    compare_runs(f"{cfg} post-processing card vs CPU on the card's network outputs", card,
                 cpu.postprocess(z_card, None if seg_card is None else seg_card.cpu(), IN_HW,
                                 ORIG_HW, conf=CONF),
                 MATCH_SHARE, BOX_PX, SCORE_ABS, MASK_SHARE)
    # phase [3]'s end-to-end bounds assume networks within NET_REL of each other
    close = all(v["card_vs_cpu"] <= NET_REL for v in net.values())
    compare_runs(f"{cfg} end to end fp32 card vs CPU (the CPU forward took {t_cpu:.1f} s)"
                 + ("" if close else "; networks past NET_REL: detections reported"),
                 card, ref, E2E_MATCH_SHARE if close else None, BOX_PX if close else None,
                 E2E_SCORE_ABS, E2E_MASK_SHARE)
    z16, seg16 = e16.forward(x)
    z32, seg32 = e32.forward(x)
    # bf16's own drift on this network: the CPU's bf16 engine against its fp32
    t0 = time.perf_counter()
    cpu16 = Engine(spec=spec, state_dict=sd, device="cpu", half=True)
    zc16, segc16 = cpu16.forward(x.cpu())
    t_cpu16 = time.perf_counter() - t0
    del cpu16
    bf16 = {"card": {"objcls_mean": (z16[:, 4:].float() - z32[:, 4:]).abs().mean().item()},
            "cpu": {"objcls_mean": (zc16[:, 4:].float() - z_cpu[:, 4:]).abs().mean().item()},
            "cpu_s": t_cpu16}
    if seg:
        bf16["card"]["seg_rel"] = diffs(seg16, seg32)[1]
        bf16["cpu"]["seg_rel"] = diffs(segc16, seg_cpu)[1]
    for key, what, bound in (("seg_rel", "seg logits max|diff|/max(max|ref|,1)", BF16_SEG_REL),
                             ("objcls_mean", "obj/cls mean |diff|", BF16_OBJCLS_MEAN)):
        if key in bf16["card"]:
            got, own = bf16["card"][key], bf16["cpu"][key]
            log(f"  {cfg} network bf16 vs fp32 {what}: card {got:.3e}, CPU {own:.3e} "
                f"(the CPU's bf16 forward took {t_cpu16:.1f} s)")
            check(f"{cfg} network bf16 vs fp32 card: {what}", got,
                  max(bound, BF16_FACTOR * own))
    # every K2 site of the path, on the engines' own weights and shapes
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    worst = {}
    for eng, dt, bound in ((e32, torch.float32, F32_REL), (e16, torch.bfloat16, BF16_REL)):
        sites, _ = record_path_inputs(eng, frame)
        worst_rel = 0.0
        for shape, co, st, dl, act, wt, b in sites:
            xs = torch.randn(shape, generator=g, device=DEVICE).to(dt)
            got = K.conv3x3(xs, wt, b, st, dl, act)
            torch.cuda.synchronize()
            worst_rel = max(worst_rel, diffs(got, K.conv3x3_plain(xs, wt, b, st, dl, act))[1])
        check(f"{cfg} conv3x3 {str(dt)[6:]} at its {len(sites)} sites "
              f"(c_in {sorted({s[0][-1] for s in sites})}) max|diff|/max(max|ref|,1)",
              worst_rel, bound)
        worst[str(dt)[6:]] = worst_rel
    res = {"launches_per_frame": launches, "k2_sites": n_k2, "k2_rel_err": worst,
           "cpu_forward_s": t_cpu, "dets": len(card[0][0]), "network_fp32": net,
           "bf16_vs_fp32": bf16}
    for name, eng in (("fp32", e32), ("bf16", e16)):
        reps = frame_ms(eng, frame)
        res[f"{name}_ms"] = reps
        log(f"  {cfg} Engine.__call__ bs1 {name}: median {float(np.median(reps)):.3f} "
            f"ms/frame over {FAMILY_REPS} reps of {FAMILY_ITERS}, range "
            f"{min(reps):.3f}-{max(reps):.3f}")
    return res, (e32, e16, cpu)


def phase_families(eng32, frames):
    """[9] the other model families: K1's float mode, each configuration of
    FAMILY_CFGS at bs1, BiSe's seg_validation on float batches, an
    InferenceServer on a detection-only model, and pspv5l at bs2 off K7.
    A failed bound is reported where it happens and raised at the end of
    the phase, so one run shows every one."""
    failures = []
    real = check

    def deferred(name, value, bound, ok=None):
        try:
            real(name, value, bound, ok)
        except AssertionError as e:
            failures.append(str(e))

    with replaced(sys.modules[__name__], "check", deferred):
        res = _phase_families(eng32, frames)
    if failures:
        raise AssertionError(f"[9]: {len(failures)} bound(s) failed: {failures}")
    return res


def _phase_families(eng32, frames):
    from multiyolov5_tpu_torch import engine as engine_mod
    from multiyolov5_tpu_torch import evaluation as E
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.serving import InferenceServer
    log(f"[9] other model families at full width: {', '.join(FAMILY_CFGS)}, seed {SEED}, "
        f"bs1 {IN_HW} -> {ORIG_HW}, conf {CONF}")
    res = {"configs": {}}
    engines = {}
    for cfg in FAMILY_CFGS:
        res["configs"][cfg], engines[cfg] = run_family(cfg, frames[0])
        if cfg not in (BISE_CFG, DET_CFG, "yolov5x_city_seg"):
            del engines[cfg]

    # K1 in its float mode (and uint8 at x width) against stem_plain
    x32 = engines["yolov5x_city_seg"][0]
    res["stem"] = hold_stem_modes({"s": (eng32.stem_weights, eng32.stem_weights_float),
                                   "x": (x32.stem_weights, x32.stem_weights_float)})
    del engines["yolov5x_city_seg"]

    # seg_validation of BiSe on float batches off the k/255 lattice
    b32, _, b_cpu = engines.pop(BISE_CFG)
    rng = np.random.RandomState(SEED + 21)
    batches = []
    for _ in range(EVAL_BATCHES):
        imgs = rng.rand(EVAL_BS, *IN_HW, 3).astype(np.float32)
        _, logits = b32.forward(torch.from_numpy(imgs).to(DEVICE))
        cmap = K.upsample_argmax(logits.contiguous(), ORIG_HW, via_hw=IN_HW).cpu().numpy()
        masks = np.where(rng.rand(*cmap.shape) < 0.3,
                         rng.randint(0, logits.shape[1], cmap.shape), cmap).astype(np.int32)
        masks[rng.rand(*cmap.shape) < 0.1] = -1
        batches.append((imgs, masks))
    stems = []
    K.reset_launches()
    with spied(engine_mod, "stem", before=recorder(stems)):
        card = quiet(E.seg_validation, b32, batches, nclass=b32.spec.n_segcls)
    torch.cuda.synchronize()
    sv_launches = K.launch_counts()
    log(f"  {BISE_CFG} seg_validation on {EVAL_BATCHES} float32 bs{EVAL_BS} batches: "
        f"launches {sv_launches}")
    want = {"stem": 0, "stem_float": EVAL_BATCHES, "upsample_argmax": EVAL_BATCHES}
    if {k: sv_launches[k] for k in want} != want:
        raise AssertionError(f"seg_validation launches {sv_launches}, want {want}")
    t0 = time.perf_counter()
    cpu = quiet(E.seg_validation, b_cpu, batches, nclass=b_cpu.spec.n_segcls)
    t_cpu = time.perf_counter() - t0
    for name, a, b in zip(("pixAcc", "mIoU"), card, cpu):
        log(f"  {name}: card {a:.6f}, CPU {b:.6f} (the CPU run took {t_cpu:.1f} s)")
        check(f"{BISE_CFG} seg_validation fp32 card vs CPU: {name} |diff|", abs(a - b),
              SEG_METRIC_ABS)
    if not 0.0 < card[1] < 1.0:
        raise AssertionError(f"degenerate mIoU {card[1]}")
    worst_abs = worst_rel = 0.0
    for args, kw in stems:
        got = K.stem(*args, **kw)
        torch.cuda.synchronize()
        da, dr = diffs(got, K.stem_plain(*args, **kw))
        worst_abs, worst_rel = max(worst_abs, da), max(worst_rel, dr)
    check(f"stem float on seg_validation's {len(stems)} calls "
          f"{sorted({tuple(a[0].shape) for a, _ in stems})} max|diff|/max(max|ref|,1)",
          worst_rel, F32_REL)
    res["seg_validation"] = {"launches": sv_launches, "card": list(card), "cpu": list(cpu),
                             "stem_float_max_abs_err": worst_abs}
    del b32, b_cpu

    # InferenceServer on the detection-only model: one padded bucket
    _, d16, _ = engines.pop(DET_CFG)
    frames_bgr = [np.random.RandomState(SEED + 23 + i).randint(0, 256, (*ORIG_HW, 3))
                  .astype(np.uint8) for i in range(4)]
    calls = []
    real_call = Engine.__call__

    def recorded(self, x, *a, **kw):
        out = real_call(self, x, *a, **kw)
        calls.append((x.clone(), out))
        return out

    server = InferenceServer(engine=d16, img_size=SERVE_IMG, max_batch=SERVE_BS,
                             max_wait_ms=1000, conf=CONF)
    n_real = []
    try:
        server.warmup(ORIG_HW)
        torch.cuda.synchronize()
        K.reset_launches()
        with replaced(Engine, "__call__", recorded), \
                spied(InferenceServer, "letterbox_batch",
                      before=lambda self, fr: n_real.append(len(fr))):
            got = serve(server, frames_bgr)
        torch.cuda.synchronize()
        srv_launches = K.launch_counts()
    finally:
        server.close()
    sizes = [tuple(x.shape) for x, _ in calls]
    batched = sum(x.shape[0] > 1 for x, _ in calls)
    log(f"  {DET_CFG} InferenceServer bf16 on {len(frames_bgr)} frames: batches {sizes}, "
        f"launches {srv_launches}")
    from multiyolov5_tpu_torch.models.blocks import C3
    n_c3 = sum(isinstance(m, C3) and m.c3_kernel for m in d16.model.modules())
    check(f"{DET_CFG} server: K7 launches - batched forwards x {n_c3} K7 row(s)",
          abs(srv_launches["c3"] - batched * n_c3), 0)
    if srv_launches["upsample_argmax"] != 0 or any(m is not None for _, m in got):
        raise AssertionError("the detection-only server made a class map")
    served = [(d, m) for n, (x, (dets, masks)) in zip(n_real, calls)
              for d, m in zip(dets[:n], masks[:n])]
    differ = sum(not np.array_equal(a[0], b[0]) for a, b in zip(got, served))
    for x, (dets, _) in calls:
        d2, m2 = d16(x, ORIG_HW, conf=CONF)
        differ += sum(not np.array_equal(a, b) for a, b in zip(dets, d2)) + (m2 != [None] * len(d2))
    check(f"{DET_CFG} server results differing from Engine on the same padded batch", differ, 0)
    for d, _ in got:
        if not (np.isfinite(d).all() and d.shape[1] == 6):
            raise AssertionError("malformed server output")
    res["server"] = {"batches": sizes, "launches": srv_launches,
                     "dets_per_frame": [len(d) for d, _ in got]}
    del d16, engines

    # pspv5l at bs2: its row-2 C3 (c_ 64) is past K7's width gate
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    spec_l = load_spec(L_CFG)
    l32 = Engine(spec=spec_l, state_dict=seeded_state_dict(spec_l, SEED), device=DEVICE,
                 half=False)
    x2 = torch.from_numpy(np.stack(frames[:2])).to(DEVICE)
    K.reset_launches()
    z, seg = l32.forward(x2)
    torch.cuda.synchronize()
    l_launches = K.launch_counts()
    log(f"  {L_CFG} bs2 fp32 forward: row-2 C3 c_ {l32.model.model[2].cv1.conv.out_channels}, "
        f"launches {l_launches}")
    check(f"{L_CFG} bs2 forward: K7 launches", l_launches["c3"], 0)
    if not (bool(torch.isfinite(z).all()) and bool(torch.isfinite(seg).all())
            and z.shape[0] == 2 and seg.shape == (2, 19, IN_HW[0] // 8, IN_HW[1] // 8)):
        raise AssertionError(f"{L_CFG} bs2: outputs not finite or malformed")
    res["pspv5l_bs2"] = {"launches": l_launches}
    return res


def train_batch(rng, bs: int, nc: int, nseg: int):
    """bench.py:74-84's batch: uint8 det images with 20 targets each, padded
    to TRAIN_MAX_T; float seg images in [0, 1]; int64 labels in [-1, nseg)."""
    from multiyolov5_tpu_torch.train.losses import pad_targets
    imgs = (rng.rand(bs, *TRAIN_DET_HW, 3) * 255).astype(np.uint8)
    labels = []
    for _ in range(bs):
        lab = np.zeros((TRAIN_TARGETS, 5), np.float32)
        lab[:, 0] = rng.randint(0, nc, TRAIN_TARGETS)
        lab[:, 1:3] = rng.rand(TRAIN_TARGETS, 2) * 0.6 + 0.2
        lab[:, 3:5] = rng.rand(TRAIN_TARGETS, 2) * 0.2 + 0.05
        labels.append(lab)
    tgts, mask = pad_targets(labels, TRAIN_MAX_T)
    seg_imgs = rng.rand(bs, *TRAIN_SEG_HW, 3).astype(np.float32)
    seg_lbls = rng.randint(-1, nseg, (bs, *TRAIN_SEG_HW))
    return imgs, tgts, mask, seg_imgs, seg_lbls


def train_state(spec, sd, dtype, device, bs: int):
    """(state, step) of the port's trainer from ``sd`` with load_hyp("scratch")."""
    from multiyolov5_tpu_torch.data.hyps import load_hyp
    from multiyolov5_tpu_torch.train import trainer as T
    cfg = T.TrainConfig(hyp=load_hyp("scratch"), batch_size=bs, compute_dtype=dtype)
    ts, groups = T.create_train_state(spec, cfg, state_dict=sd, device=device)
    return ts, T.make_train_step(spec, cfg, groups)


def change_errors(got: dict, want: dict, init: dict):
    """Each entry held by its change from ``init``: (entries with
    max |u_got - u_want| > TRAIN_UPDATE_REL * max |u_want| + 2 ulp(max |want|),
    the worst and the median of max |u_got - u_want| / max |u_want| over
    entries that moved by more than 1000 ulps)."""
    eps = float(np.finfo(np.float32).eps)
    bad, rel = [], []
    for k, w in want.items():
        w = w.float().cpu()
        g, i = got[k].float().cpu(), init[k].float().cpu()
        err = (g - w).abs().max().item()
        span, top = (w - i).abs().max().item(), w.abs().max().item()
        if err > TRAIN_UPDATE_REL * span + 2 * eps * top:
            bad.append(k)
        if span > 1e3 * eps * top:
            rel.append(err / span)
    return bad, max(rel), float(np.median(rel))


def k6_bound(z, y):
    """(K6's least ms forward + backward on an H100, "bytes" or
    "operations") for logits z against labels y: two exps a (label pixel,
    class) at the SFU rate beside their float32 operations; z read three
    times and dz written once, labels and weights read by both passes."""
    b, c = z.shape[:2]
    n = b * c * y.shape[1] * y.shape[2]
    zb = z.numel() * z.element_size()
    nbytes = 3 * zb + 2 * (4 * y.numel() + 4 * c) + 4
    t_ops = max(2 * n / SFU_OP_S, K6_OPS_PER_PIXEL_CLASS * n / FP32_FLOP_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k6_plan_text(p) -> str:
    """K6's launch plan (ops/kernels/seg_ce.py plan) in words."""
    f, b = p.fwd, p.bwd
    return (f"forward {f.ti}x{f.tj}-cell tiles, {f.ctas} CTAs of {f.threads} threads, "
            f"{f.cb} classes a thread, {f.smem} B shared; backward {b.ti}x{b.tj} tiles of dz, "
            f"{b.ctas} CTAs of {b.threads} threads ({b.groups} groups of {b.cb} classes x "
            f"{b.cols} label columns), {b.smem} B shared")


def hold_k6_plan(z, y):
    """Print K6's plan for the step's (z, y) and require ops/kernels/seg_ce.py's
    shared-memory counts to equal the kernel's (mk_seg_ce_smem_bytes)."""
    import ctypes
    import importlib

    from multiyolov5_tpu_torch.ops.kernels import build
    mod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.seg_ce")
    p = mod.plan(*z.shape, *y.shape[1:], z.dtype)
    smem_c = build.function("mk_seg_ce_smem_bytes", [ctypes.c_int] * 5)
    for q, backward in ((p.fwd, False), (p.bwd, True)):
        cp = q.cb * q.groups          # the classes padded as the kernel stages them
        check(f"seg_ce {'backward' if backward else 'forward'} plan's shared memory - "
              "the kernel's", abs(q.smem - smem_c(int(backward), cp, q.ti, q.tj, q.cols)), 0)
    return p


def hold_k6_bitwise(z, y, w, upstream: float):
    """On one call's arguments: two backward launches give bitwise equal dz,
    and planar and channels-last logits bitwise equal loss and dz."""
    from multiyolov5_tpu_torch.ops import kernels as K
    zc = z.contiguous(memory_format=torch.channels_last)
    y32 = y.to(torch.int32)
    wv = (torch.ones(z.shape[1], dtype=torch.float32, device=z.device) if w is None
          else w.to(z.device, torch.float32))
    stats, lse = K.seg_ce_forward(zc, y32, wv)
    g = torch.full((1,), upstream, dtype=torch.float32, device=z.device)
    d1 = K.seg_ce_backward(zc, y32, wv, lse, stats, g)
    d2 = K.seg_ce_backward(zc, y32, wv, lse, stats, g)
    out = []
    for zz in (zc, z.contiguous()):
        zz = zz.detach().clone().requires_grad_(True)
        loss = K.seg_ce(zz, y, w)
        (loss * upstream).backward()
        out.append((loss.detach(), zz.grad.contiguous()))
    torch.cuda.synchronize()
    check("seg_ce two backward launches: dz elements not bitwise equal",
          int((d1 != d2).sum().item()), 0)
    check("seg_ce planar vs channels-last: loss and dz elements not bitwise equal",
          int((out[0][0] != out[1][0]).sum().item() + (out[0][1] != out[1][1]).sum().item()), 0)


def k6_against_plain(z, y, w, upstream: float):
    """K6 and its plain version, forward and backward, on one call's
    arguments: (|loss diff|, max |dz diff|, max |dz diff| / max |plain dz|)."""
    from multiyolov5_tpu_torch.ops import kernels as K
    out = []
    for fn in (K.seg_ce, K.seg_ce_plain):
        zz = z.detach().clone().requires_grad_(True)
        loss = fn(zz, y, w)
        (loss * upstream).backward()
        torch.cuda.synchronize()
        out.append((loss.detach().float().cpu(), zz.grad.float()))
    (lk, gk), (lp, gp) = out
    d = (gk - gp).abs().max().item()
    return abs(lk.item() - lp.item()) / abs(lp.item()), d, d / gp.abs().max().item()


def phase_train():
    """[7] the dual-task train step on the card: K6 against its plain version
    on the counted steps' arguments, the counted float32 step against the
    same step on the CPU, a scheduled 20-step run, the EMA checkpoint served
    by Engine, and timing."""
    import tempfile

    import torch.nn.functional as F

    from multiyolov5_tpu_torch.data.hyps import load_hyp
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.train import trainer as T
    from multiyolov5_tpu_torch.train.optim import WarmupCosine
    from multiyolov5_tpu_torch.utils.checkpoint import save_npz
    log(f"[7] train step: {CFG} seed {SEED}, det bs{TRAIN_BS} {TRAIN_DET_HW} uint8 "
        f"({TRAIN_TARGETS} targets an image, max {TRAIN_MAX_T}), seg bs{TRAIN_BS} "
        f"{TRAIN_SEG_HW}, hyp scratch, lr/lr_bias/momentum {TRAIN_STEP_ARGS}")
    spec = load_spec(CFG)
    sd = seeded_state_dict(spec, SEED)
    host = train_batch(np.random.RandomState(SEED + 9), TRAIN_BS, spec.nc, spec.n_segcls)
    batch = tuple(torch.as_tensor(a).to(DEVICE) for a in host)
    args = (*TRAIN_STEP_ARGS, True)
    upstream = TRAIN_BS * T.TrainConfig(hyp={}).seggain   # the step's seg loss scale
    res = {"launches": {}, "k6": {}}

    # one counted step per compute type, recording K6's arguments
    states, rec = {}, {}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        ts, step = train_state(spec, sd, dt, DEVICE, TRAIN_BS)
        rec[name] = []
        K.reset_launches()
        with spied(T, "seg_ce", before=lambda z, y, w=None, store=rec[name]: store.append(
                (z.detach().clone(), y.clone(), w))):
            ts, m = step(ts, *batch, *args)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        res["launches"][name] = counts
        log(f"  {name} step: total {m['total'].item():.5f}, det items "
            f"{[round(v, 5) for v in m['det_items'].tolist()]}, seg {m['seg_loss'].item():.5f}; "
            f"launches {counts}")
        if not np.isfinite(m["total"].item()):
            raise AssertionError(f"{name} train step: loss not finite")
        if (counts["seg_ce"], counts["seg_ce_bwd"]) != (1, 1):
            raise AssertionError(f"{name} train step: K6 forward/backward launched "
                                 f"{counts['seg_ce']}/{counts['seg_ce_bwd']} times, not once each")
        states[name] = (ts, step, m)

    # K6 against its plain version on the arguments the counted steps gave it
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        z, y, w = rec[name][0]
        dl, dabs, drel = k6_against_plain(z, y, w, upstream)
        log(f"  seg_ce {name} on the step's {tuple(z.shape)} {str(z.dtype)[6:]} logits, "
            f"{tuple(y.shape)} {str(y.dtype)[6:]} labels: loss |diff| {dl:.3e} relative, "
            f"dz max|diff| {dabs:.3e}")
        check(f"seg_ce {name} loss |diff|/|plain|", dl, SEG_CE_LOSS_REL)
        check(f"seg_ce {name} dz max|diff|/max|plain dz|", drel, SEG_CE_DZ_REL[dt])
        cl = z.is_contiguous(memory_format=torch.channels_last)
        plan = k6_plan_text(hold_k6_plan(z, y))
        log(f"  seg_ce {name}: the step's logits {'channels-last' if cl else 'planar'}; {plan}")
        hold_k6_bitwise(z, y, w, upstream)
        res["k6"][name] = {"loss_rel": dl, "dz_max_abs": dabs, "dz_rel": drel, "plan": plan}

    # the counted float32 step against the same step on the CPU
    t_cpu = time.perf_counter()
    ts_h, step_h = train_state(spec, sd, torch.float32, "cpu", TRAIN_BS)
    ts_h, m_h = step_h(ts_h, *host, *args)
    t_cpu = time.perf_counter() - t_cpu
    ts_c, _, m_c = states["fp32"]
    log(f"  fp32 bs{TRAIN_BS} step, card vs CPU (the CPU step took {t_cpu:.1f} s)")
    for k in ("total", "seg_loss", "det_items"):
        a, b = m_c[k].cpu(), m_h[k]
        check(f"train fp32 card vs CPU: {k} max|diff|/|CPU|",
              ((a - b).abs() / b.abs()).max().item(), TRAIN_LOSS_REL)
    init = {k: v.float() for k, v in sd.items()}
    mom0 = {k: torch.zeros_like(v) for k, v in ts_h.opt["momentum"].items()}
    res["card_vs_cpu"] = {}
    for what, got, want, ref in (("params+BN", ts_c.state_dict(), ts_h.state_dict(), init),
                                 ("EMA", ts_c.ema, ts_h.ema, init),
                                 ("momentum", ts_c.opt["momentum"], ts_h.opt["momentum"], mom0)):
        bad, worst, med = change_errors(got, want, ref)
        log(f"  {what}: {len(want)} tensors, change |diff|/|change| worst {worst:.3e}, "
            f"median {med:.3e}")
        check(f"train fp32 card vs CPU: {what} tensors off their change bound", len(bad), 0)
        res["card_vs_cpu"][what] = {"worst": worst, "median": med}
    del ts_h

    # a scheduled run (cli/train.py:287-294, 379-381) on one fixed batch, bf16
    ts, step = train_state(spec, sd, torch.bfloat16, DEVICE, TRAIN_BS)
    hyp = load_hyp("scratch")
    nw = min(max(round(hyp["warmup_epochs"] * TRAIN_RUN_STEPS), 800),
             max(TRAIN_RUN_STEPS // 2, 1))
    sched = WarmupCosine(lr0=hyp["lr0"], lrf=hyp["lrf"], epochs=1, warmup_iters=nw,
                         warmup_bias_lr=hyp["warmup_bias_lr"],
                         warmup_momentum=hyp["warmup_momentum"], momentum=hyp["momentum"])
    losses = []
    for ni in range(TRAIN_RUN_STEPS):
        lr, lr_bias, mom = sched.at(ni, 0)
        ts, m = step(ts, *batch, lr, lr_bias, mom,
                     ni % sched.accumulate_at(ni, 64, TRAIN_BS) == 0)
        losses.append(m["total"])
    losses = [v.item() for v in losses]
    log(f"  {TRAIN_RUN_STEPS}-step bf16 run ({ts.updates} updates, warmup {nw}): total "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {[round(v, 3) for v in losses]}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"scheduled run: loss not finite or not falling: {losses}")
    res["run"] = {"losses": losses, "updates": ts.updates, "warmup_iters": nw}

    # the EMA weights through a checkpoint into the serving path
    frame = (np.random.RandomState(SEED + 11).rand(*IN_HW, 3) * 255).astype(np.uint8)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "last.npz")
        save_npz(path, T.checkpoint_tree(ts, spec, epoch=0))
        served = Engine(path, device=DEVICE, half=True)(frame, ORIG_HW, conf=CONF)
    direct = Engine(spec=spec, state_dict={k: v.float().cpu() for k, v in ts.ema.items()},
                    device=DEVICE, half=True)(frame, ORIG_HW, conf=CONF)
    dets, mask = served[0][0], served[1][0]
    log(f"  Engine(weights=the run's EMA checkpoint): {len(dets)} detections, class map "
        f"{mask.shape} with {len(np.unique(mask))} classes")
    if not (np.isfinite(dets).all() and mask.shape == ORIG_HW
            and np.array_equal(dets, direct[0][0]) and np.array_equal(mask, direct[1][0])):
        raise AssertionError("the EMA checkpoint does not serve as the EMA weights do")
    del ts

    # timing: ms/step, img/s, peak memory; K6 beside its bound, plain, library
    log("  timing: train steps on the host clock around synchronised runs of "
        f"{TRAIN_REP_STEPS}; K6 on the card's clock (CUDA graph replay)")
    res["step"] = {}
    for name, (ts, step, _) in states.items():
        for _ in range(2):
            step(ts, *batch, *args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(ts, *batch, *args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        reps = []
        for _ in range(TRAIN_REPS):
            t0 = time.perf_counter()
            for _ in range(TRAIN_REP_STEPS):
                step(ts, *batch, *args)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3 / TRAIN_REP_STEPS)
        ms = float(np.median(reps))
        res["step"][name] = {"median_ms": ms, "reps_ms": reps, "img_per_s": TRAIN_BS / ms * 1e3,
                             "peak_bytes": peak}
        log(f"  train step bs{TRAIN_BS} {name}: median {ms:.2f} ms/step "
            f"({TRAIN_BS / ms * 1e3:.1f} img/s) over {TRAIN_REPS} reps of {TRAIN_REP_STEPS}, "
            f"range {min(reps):.2f}-{max(reps):.2f}; peak device memory {peak / 2**30:.2f} GiB")
    del states

    res["k6_times"] = {}
    for name in ("bf16", "fp32"):
        z, y, w = rec[name][0]
        z = z.contiguous(memory_format=torch.channels_last)   # the head's, as the kernels read it
        y32 = y.to(torch.int32)
        wv = torch.ones(z.shape[1], dtype=torch.float32, device=z.device)
        stats, lse = K.seg_ce_forward(z, y32, wv)
        g = torch.full((1,), upstream, dtype=torch.float32, device=z.device)

        def plain():
            zz = z.detach().requires_grad_(True)
            (K.seg_ce_plain(zz, y) * upstream).backward()

        def library():
            zz = z.detach().requires_grad_(True)
            up = F.interpolate(zz, size=tuple(y.shape[1:]), mode="bilinear", align_corners=True)
            (F.cross_entropy(up, y, ignore_index=-1) * upstream).backward()

        t = {"fwd_ms": graph_ms(lambda: K.seg_ce_forward(z, y32, wv)),
             "bwd_ms": graph_ms(lambda: K.seg_ce_backward(z, y32, wv, lse, stats, g)),
             "plain_ms": cuda_ms(plain, iters=10, warmup=2),
             "library_ms": cuda_ms(library, iters=10, warmup=2)}
        t["bound_ms"], t["bound_by"] = k6_bound(z, y)
        res["k6_times"][name] = t
        log(f"  seg_ce {name} {tuple(z.shape)} -> {tuple(y.shape[1:])}: forward "
            f"{t['fwd_ms']:.4f} ms, backward {t['bwd_ms']:.4f} ms; plain fwd+bwd "
            f"{t['plain_ms']:.4f} ms; F.interpolate + F.cross_entropy fwd+bwd "
            f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    from multiyolov5_tpu_torch.engine import Engine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_card()
    rng = np.random.RandomState(SEED)
    frames = [(rng.rand(*IN_HW, 3) * 255).astype(np.uint8) for _ in range(N_FRAMES)]
    eng32 = Engine(cfg=CFG, device=DEVICE, half=False, seed=SEED)
    eng16 = Engine(cfg=CFG, device=DEVICE, half=True, seed=SEED)
    cpu_eng = Engine(cfg=CFG, device="cpu", half=False, seed=SEED)

    errs, sites16, nms_in = phase_kernels(eng32, eng16, frames)
    launches = phase_end_to_end(eng32, eng16, cpu_eng, frames)
    ev = phase_eval(eng32, eng16, cpu_eng)
    launches["nms_greedy"] = ev["launches"]["nms_greedy"]
    errs["nms_greedy"] = ev["errs"]["nms_greedy"]
    (e2e, times, per_site, library, bounds, k4_eval, short, c3_times, k2_f32, k2_sweep,
     stem_bs8) = phase_timing(eng32, eng16, frames, sites16, nms_in, ev)
    eval_launches, eval_errs = ev["launches"], ev["errs"]
    eval_n, eval_metrics = ev["n"], ev["metrics"]
    del ev
    sv = phase_serving(eng32, eng16, cpu_eng)
    n_batched = sum(b[0] > 1 for b in sv["batches"])
    launches["c3"] = sv["launches"]["c3"]
    fam = phase_families(eng32, frames)
    del eng32, eng16, cpu_eng
    tr = phase_train()
    k6 = tr["k6_times"]["bf16"]
    train_counts = tr["launches"]["bf16"]
    launches["seg_ce"] = train_counts["seg_ce"] + train_counts["seg_ce_bwd"]
    errs["seg_ce"] = tr["k6"]["fp32"]["dz_max_abs"]
    times["seg_ce"] = (k6["fwd_ms"] + k6["bwd_ms"], k6["plain_ms"])
    bounds["seg_ce"] = (k6["bound_ms"], k6["bound_by"])
    library["seg_ce"] = k6["library_ms"]

    # K1's float mode (B1c): launches on [9]'s seg_validation run, its error
    # on that run's arguments, its times at that shape (s width, float32
    # (4, H, W, 3) frames, float32 output)
    sf = next(r for r in fam["stem"] if r["mode"] == "float" and r["width"] == "s"
              and r["frame"][0] == EVAL_BS and r["frame_dtype"] == "float32")
    launches["stem_float"] = fam["seg_validation"]["launches"]["stem_float"]
    errs["stem_float"] = fam["seg_validation"]["stem_float_max_abs_err"]
    times["stem_float"] = (sf["ms"], sf["plain_ms"])
    bounds["stem_float"] = (sf["bound_ms"], sf["bound_by"])
    library["stem_float"] = sf["library_ms"]
    # K1's uint8 mode -> float32 at eval's detection batch (s width, bs4)
    su = next(r for r in fam["stem"] if r["mode"] == "uint8" and r["width"] == "s"
              and r["frame"][0] == EVAL_BS and r["out_dtype"] == "float32")

    replaces = {
        "stem": "multiyolov5_tpu/ops/pallas/stem_kernel.py:308",
        "stem_float": "multiyolov5_tpu/ops/pallas/stem_kernel.py:415",
        "conv3x3": "multiyolov5_tpu/ops/pallas/conv3x3_kernel.py:98",
        "nms": "multiyolov5_tpu/ops/pallas/nms_fixpoint_kernel.py:77",
        "upsample_argmax": "multiyolov5_tpu/ops/pallas/upsample_argmax_kernel.py:309",
        "nms_greedy": "multiyolov5_tpu/ops/pallas/nms_kernel.py:87",
        "seg_ce": "multiyolov5_tpu/ops/pallas/seg_ce_kernel.py:256",
        "c3": "multiyolov5_tpu/ops/pallas/c3_kernel.py:391",
    }
    # launches: K1-K4 on the serving path [3], K1's float mode (stem_float)
    # on [9]'s seg_validation run, K5 on the eval path [5], K6
    # (forward + backward) in the counted bf16 train step [7], K7 in the
    # bf16 batched server's run [8] (serving_batches batched forwards);
    # eval_launches and train_launches: every kernel on those paths.
    # max_abs_err: the float32 comparison of [2] at the serving shapes; for
    # nms the keep entries that differ, for nms_greedy the picks that differ
    # on the eval path's lists, for upsample_argmax the mismatched pixel
    # share, for seg_ce max |dz diff| on the float32 train step's arguments
    # (the loss's, relative, is in chip_smoke.json).  eval_max_abs_err:
    # the same on the eval path's own arguments ([5]).  seg_ce's times are
    # forward + backward on the bf16 train step's arguments; c3's at bs8
    # 1024x1024 serving's row-2 C3, its library time the unfused cuDNN
    # sequence (5 convs, cat, add), its max_abs_err at that shape.
    kernels = [{"name": k, "route": "cuda",
                "source": f"multiyolov5_tpu_torch/csrc/{k.split('_float')[0]}.cu",
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1],
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                "library_ms": library.get(k), "eval_launches": eval_launches[k],
                "eval_max_abs_err": eval_errs.get(k),
                "train_launches": train_counts[k] + (train_counts["seg_ce_bwd"]
                                                     if k == "seg_ce" else 0),
                "err_dtype": "float32",
                "ms_dtype": ("float32" if k.startswith("nms") or k == "stem_float"
                             else "bfloat16")}
               for k in replaces]
    kk = {k["name"]: k for k in kernels}
    kk["seg_ce"].update(fwd_ms=k6["fwd_ms"], bwd_ms=k6["bwd_ms"],
                        fwd_launches=train_counts["seg_ce"],
                        bwd_launches=train_counts["seg_ce_bwd"], plan=tr["k6"]["bf16"]["plan"])
    # the float32 form (3xTF32) beside the CUDA cores' float32 bound
    kk["stem_float"].update(cuda_core_bound_ms=sf["cuda_core_bound_ms"])
    # K2's float32 form (3xTF32), summed over eval's 10 bs4 sites
    kk["conv3x3"].update(fp32_ms=k2_f32["ms"], fp32_plain_ms=k2_f32["plain_ms"],
                         fp32_library_ms=k2_f32["library_ms"], fp32_bound_ms=k2_f32["bound_ms"],
                         fp32_cuda_core_bound_ms=k2_f32["cuda_core_bound_ms"],
                         fp32_sites=len(k2_f32["sites"]))
    kk["stem"].update(fp32_ms=su["ms"], fp32_plain_ms=su["plain_ms"],
                      fp32_library_ms=su["library_ms"], fp32_bound_ms=su["bound_ms"],
                      fp32_cuda_core_bound_ms=su["cuda_core_bound_ms"],
                      fp32_frame=su["frame"])
    # K3 with its pack on the serving list, and on the chain and an
    # all-invalid list ([6]); K4 at seg_validation's bs4 float32 batch and
    # the bs8 server's shape ([6]) and on the server's own bs8 launch ([8])
    k3 = short["k3"]
    kk["nms"].update(plan=k3["plan"], packed_ms=k3["packed_ms"],
                     packed_plain_ms=k3["packed_plain_ms"],
                     packed_bound_ms=k3["packed_bound_ms"], chain_ms=k3["chain_ms"],
                     all_invalid_ms=k3["all_invalid_ms"])
    kk["upsample_argmax"].update(
        eval_ms=k4_eval["eval"]["ms"], eval_plain_ms=k4_eval["eval"]["plain_ms"],
        eval_bound_ms=k4_eval["eval"]["bound"][0], bs8_ms=k4_eval["bs8"]["ms"],
        bs8_plain_ms=k4_eval["bs8"]["plain_ms"], bs8_bound_ms=k4_eval["bs8"]["bound"][0],
        serving_bs8=sv["k4"])
    # K5's plan at eval's lists and its readings at the short lists ([6]),
    # and at the bs8 server's first full batch ([8])
    k5 = dict(short["k5"], serving_bs8=sv["k5"])
    kk["nms_greedy"].update(plan=k5["eval"]["plan"], ms_per_pick=k5["eval"]["ms_per_pick"],
                            short_lists={k: {f: k5[k][f] for f in ("shape", "plan", "ms",
                                                                   "bound_ms", "picks")}
                                         for k in ("short", "eval_rows_x8", "serving",
                                                   "serving_bs8") if k5[k]})
    # K7's float32 form (3xTF32) at eval's shape: its bound beside the CUDA
    # cores' float32 bound
    kk["c3"].update(serving_batches=n_batched, eval_ms=c3_times["eval"]["ms"],
                    eval_plain_ms=c3_times["eval"]["plain_ms"],
                    eval_library_ms=c3_times["eval"]["library_ms"],
                    eval_bound_ms=c3_times["eval"]["bound"][0],
                    eval_cuda_core_bound_ms=c3_times["eval"]["cuda_core_bound"][0])
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"card": smi, "e2e_ms": e2e, "kernels": kernels,
                   "conv3x3_sites": per_site, "conv3x3_eval_f32": k2_f32,
                   "conv3x3_plan_sweep": k2_sweep, "stem_bs8": stem_bs8,
                   "upsample_argmax_eval": k4_eval,
                   "nms_short_lists": short,
                   "eval_candidates_per_image": eval_n,
                   "eval_metrics": eval_metrics, "train": tr, "c3": c3_times,
                   "serving_bs8": sv, "families": fam}, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
