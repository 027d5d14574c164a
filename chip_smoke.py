"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the seven Hopper kernels of ``multiyolov5_tpu_torch/csrc`` (K1 in two
modes), holds each against its plain PyTorch version at the shapes of the
paths, and drives eight paths with seeded random weights (yolov5s_city_seg
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
* the detect app [10]: ``cli.detect.main`` (bf16, ``--img-size 1024
  --save-txt --save-conf``, with and without ``--submit``) on two seeded
  2048x1024 PNG frames and the smoke's weights saved as ``.npz``; every
  artifact read back with the port's PNG codec, the txt lines, ``_mask``
  and ``_pred.png`` held equal to ``Engine`` on the same frames, the app's
  ms/frame read; and each ``Engine`` argument of the app's path, card
  (fp32) against CPU under [3]'s bounds: ``classes``, ``agnostic``,
  ``multi_label`` (K3 at bs1), ``max_det`` 50, ``augment`` (TTA, K1's
  float mode) and a two-checkpoint ensemble (one K5 launch).
* the eval CLI [11]: ``cli.test.main`` (fp32, ``--img-size 1024
  --base-size 1024 --batch-size 8``) on seeded PNG trees in the Cityscapes
  layout: 8 detection frames at 2048x1024 and 2 at 1920x1080 (rect
  batches 8x544x1056 and 2x608x1056; cv2's ``INTER_AREA`` at 2 and at a
  fractional factor) with labels from the model's jittered detections on
  the CLI's own rect inputs (mAP@.5 must land inside (0.05, 0.95)), 4
  seg frames with labelId masks from its class map (testval: 512x1024
  float batches, masks at 1024x2048); K1 in both modes, K2, K7, K5 and K4
  must launch and are held against their plain versions on the arguments
  the CLI gave them; P, R, mAP, pixAcc and mIoU card against the same CLI
  on the CPU; the loaders' host ms an image beside the forward's and
  NMS's, and each loader stage's host ms on one thread.
* hub [12]: ``hub.yolov5s_city_seg`` ``AutoShape`` (fp32 and the default
  bf16) at size 1024 on a PNG path, two same-size HWC frames, a CHW and a
  gray array: K1 4, K2 40, K7 1, K3 3, K5 1, K4 4 launches in each
  dtype, each kernel held against its plain version on the arguments
  each counted call gave it; boxes and class maps (fp32) card against the
  CPU under [3]'s bounds, the bf16 network against the fp32 one under
  [3]'s bf16 bounds.  Then ``hub.create("yolov5s", channels=1 and 4,
  autoshape=False)`` (the smoke's weights copied in where names and shapes
  match), fp32 and bf16, on a bs1 uint8 frame of that many channels, as
  [9] runs a family: K1 1 (on the C-channel frame), K2 and K3 as for the
  3-channel ``yolov5s``, each held on its arguments and K1 timed there,
  the fp32 network against float64, post-processing on the card's own
  outputs and the detections end to end against the CPU's under [3]'s
  bounds, bf16 against fp32; ``AutoShape`` over such a model raises
  ``ValueError`` with no launch; and ``Model(CFG).to(card).eval().fuse().autoshape()`` on
  one image against the hub's ``AutoShape`` on the same weights.
* profiling, export and ``.pt`` [13]: the port's FLOP count (pspv5s at
  512x1024 must equal the JAX count plus the Focus conv's, which the JAX
  counter leaves out) and the achieved bf16 TFLOP/s of a bare forward at
  bs1 and bs8 (``profile_op`` and a graph replay); ``cli.profile.main`` at
  bs1 (K2) and bs8 (K2, K7) with ``--layers --trace``: every forward it
  runs launches the kernels, and the trace's report holds K2's and K7's
  symbols as many times as the traced forwards launched them;
  ``cli.export.main`` (TorchScript and torch.export, decoded and raw, bs1;
  TorchScript bs2) reloaded against the live plain build and against
  ``Engine``'s fp32 forward (K1's float mode, K2 fp32, K7 fp32 at bs2);
  the smoke's weights as a reference-style ``.pt`` and a bare
  ``state_dict`` through ``Engine`` (bitwise equal to their
  ``convert_pt`` ``.npz``), ``cli.detect.main`` and ``cli.test.main``.
* the training CLI [14]: ``cli.train.main`` (bf16, ``--img-size 832 1024
  --batch-size 8 --workers 8``, the scratch hyp with mosaic, autoanchor)
  on seeded 2048x1024 PNG trees in the Cityscapes layout: run A, two
  epochs of two steps, K6 forward and backward once a step (held against
  its plain version on the first step's arguments) and each epoch's eval
  launching K1 (both modes), K2, K7, K5 and K4 (each held on the CLI's
  arguments), results.txt in the JAX CLI's format, JSON hyp/opt,
  stripped ``last.npz`` / ``best.npz`` that ``Engine`` serves; the first
  detection and seg batches bitwise equal with 1 and 8 loader threads;
  run B interrupted at epoch 1, named by ``tools/resume.py --dry-run``
  and resumed from the momentum, EMA and update count the file held,
  bitwise; run C, one epoch of the BiSe head with ``--quad --multi-scale
  --remat --seg-loss ohem``, where K6 must not launch; the item host ms,
  the step ms, the epoch walls and one step's peak memory with and
  without remat.
* parallelism [15]: two ranks share the card over gloo (spawned
  processes, ``parallel/mesh.py``).  (a) the data-parallel step at [7]'s
  geometry (global batch 8, float32, TF32 off): K6 forward and backward
  once a step on each rank, held on each rank's arguments with the global
  D against its plain version; both ranks' states bitwise equal; losses
  and every tensor's change against the one-process step under [7]'s
  card-vs-CPU bounds; the same step at world 1 over NCCL.  (b)
  ``spatial_forward`` at n_model 2 (bs2 512x1024) against the one-process
  forward.  (c) the dp1 x sp2 step (no K6) against the one-process step.
  (d) ``cli.train.main`` with ``--num-processes 2`` and then
  ``--model-parallel 2`` (a TCP rendezvous on localhost): one run
  directory, rank 0's, whose checkpoint ``Engine`` serves.  (e)
  ``save_sharded`` by both ranks, ``load_sharded`` by both and by one
  process, bitwise.  (f) the spatial forward of yolov3-tiny (a zero pad
  and a stride-1 max pool across rows), yolov5s-transformer (C3TR on the
  gathered map) and pspv5s at 544x1024, 17 units of the stride over two
  ranks (288 + 256 rows), against the one-process forward under (b)'s
  bound.  (g) the dp1 x sp2 step at det 800x832 + seg 544x1024 (uneven
  shards) against the one-process step under (c)'s bounds; the parent
  computes (f)'s and (g)'s references while (d)'s ranks run.  Readings:
  ms a step and a frame beside one process, and each collective's calls,
  bytes and ms in one step or forward.
* the DSL's other rows [16]: the v5.0 hub configs (``models/hub``) at full
  width and depth on seeded weights.  (a) yolov3 (no folded stem: rows
  from 0 on the frame / 255) through ``Engine`` at 512x1024, fp32 and
  bf16, bs1 and a bs8 batch, against the CPU engine ([9]'s float64
  reference and bf16 drift at bs1): every K2 launch and K3 (bs1) or K5
  (bs8) held against its plain version on its own arguments; K2's bf16
  sites timed; ``evaluate_detection`` on a bs4 batch (K5).  (b)
  yolov5s-transformer at bs1 (K1, K2 at strides 1 and 2, K3) and bs2
  (K7), its C3TR row card against CPU.  (c) yolov3-spp, yolov3-tiny,
  yolov5-fpn and yolov5-panet at bs1 in fp32 against the CPU.  (d) one
  float32 train step of yolov5-panet (bs2 320x320) against the CPU's.  (e)
  pspv5s with its neck's two ``nn.Upsample`` rows bilinear (a dict cfg),
  bs1 fp32 and bf16, as [9] runs a family: K1-K4 launch as for the
  nearest model, each held on its arguments, the network against float64,
  post-processing on the card's own outputs and end to end against the
  CPU's under [3]'s bounds, bf16 against fp32.
* the host tools [17]: tools/cityscapes2yolo.py and the five subcommands
  of tools/labelme_convert.py on a seeded tree, ``load_mosaic9``,
  ``replicate``, ``cutout``, ``hist_equalize``, ``prune_params`` and
  ``wh_iou``, with no PIL or cv2; ``seg_confusion_device`` on the card at
  (2, 19, 1024, 2048) against the host ``SegMetric`` counts.
* JPEG [18]: (a) the port's codec (``data/jpeg.py``) at cv2's and PIL's
  default settings on seeded 2048x1024 and 1280x720 frames, its encoded
  bytes and its decodes held against SHA-256 constants of libjpeg-turbo's
  (tests/test_torch_jpeg.py holds the constants to cv2 and PIL); (b)
  ``cli.detect.main`` (bf16, ``--img-size 1024``) on two JPEG frames, at
  PIL's defaults and at cv2's with EXIF orientation 6, against the same
  app on PNG copies of the port's decoded, turned frames: txt lines
  equal, each ``.jpg`` artifact the bytes cv2 would write of the PNG
  run's (K1-K4 launch as on PNG); (c)
  ``cli.test.main`` (fp32) on a JPEG detection split and a ``citysbdd``
  split with BDD-style ``.jpg`` frames, metrics equal to the run on PNG
  copies (K1 both modes, K2, K7, K5, K4), and the citysbdd training
  loader's first batch; (d) the codec's host ms a frame on one thread
  beside cv2's and PIL's where they import.
* still-image forms [19]: (a) the port's PNG (Adam7 16-bit RGB, 16-bit
  gray, 4-bit palette, ``eXIf`` 6), BMP (24-bit, RLE8), MPO (two frames)
  and TIFF (LZW + predictor 2 in strips, Deflate in tiles) decoders on
  seeded 2048x1024 files, each of ``imread`` / ``read_rgb`` /
  ``read_samples`` held to SHA-256s of cv2's and PIL's arrays
  (tests/test_torch_image_callers.py holds the constants to both), and the
  BMP writer's bytes to cv2's; (b) ``cli.detect.main`` (bf16, ``--img-size
  1024``) on a BMP, an Adam7 16-bit PNG, an ``eXIf``-6 PNG and a TIFF
  against the same app on PNG copies of the port's decoded, turned frames
  (txt equal, ``.bmp`` artifacts cv2's bytes of the PNG run's pixels,
  ``.tif`` ones decoding to them, K1-K4 as on PNG), an MPO source raising
  at its first save and giving its PNG copy's txt under ``--nosave``; (c)
  ``cli.test.main`` (fp32) on a detection split of those forms and a
  Cityscapes split with Adam7 frames and 16-bit masks, metrics equal to
  the PNG copies' (K1 both modes, K2, K7, K5, K4); (d) each read's host ms
  on one frame beside cv2's and PIL's where they import.
* WebP [20]: (a) the port's codec (``data/webp.py``) on libwebp's files
  committed under tests/webp_fixtures/ (a 2048x1024 lossy frame with 4
  segments and 8 partitions, the simple filter, VP8 + a filtered VP8L
  ALPH, EXIF 6, an animation), each of ``imread`` / ``read_rgb`` /
  ``read_samples`` held to SHA-256s of cv2's and PIL's arrays
  (tests/test_torch_image_callers.py holds the constants to both), and the
  lossless writer's 2048x1024 file decoding to its input; (b)
  ``cli.detect.main`` (bf16, ``--img-size 1024 --submit --nosave``) on two
  [19] frames written as lossless WebP and the lossy fixture against PNG
  copies (txt and ``name._pred.png`` equal, K1-K4 as on PNG), and a saving
  run that writes ``w0.webp`` (the PNG run's pixels) and raises at
  ``w0._maskwebp`` as the JAX app does; (c) ``cli.test.main`` (fp32) on a
  WebP detection split and a WebP Cityscapes frame, metrics and launches
  equal the PNG copies'; (d) the host ms of one decode and one encode at
  2048x1024 beside cv2's and PIL's where they import.
  Each phase's wall seconds go to chip_smoke.json (``phase_s``).

It checks that every kernel ran on its path, holds each kernel against its
plain version on the arguments its path gave it, and times the paths and
each kernel beside its bound and, where one PyTorch call computes the same
function, that call in the same dtype.  [1] counts the tensor-core (HMMA)
instructions in K1's, K2's and K7's two forms each (bf16 and 3xTF32)
(cuobjdump of the built library) and the TMA loads (UTMALDG) of K2's
two forms and K7's bf16 form; [2] prints K2's launch plan (tile, cluster
split, CTAs) at each pspv5s site and requires one CTA an SM at each, and
K7's plan at each case (pspv5s bs8, pspv5m bs2 and bs8, no shortcut, odd
H x W), whose layout's byte count ops/kernels/c3.py must give as the
kernel does, and whose bf16 grid of persistent CTAs must not exceed its
tiles; [6] times K7 bf16 at pspv5s's and pspv5m's bs8 shapes.  K5 (greedy NMS, a
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
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
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
# the detect app [10]: cli/detect.py at full width on 2048x1024 PNG frames
APP_FRAMES, APP_IMG, APP_MAX_DET = 2, 1024, 50
# the eval CLI [11]: cli/test.py at full width (--img-size / --base-size 1024,
# --batch-size 8: detection batches of 8 and 2, seg batches of 1) on a
# seeded Cityscapes layout: 8 detection frames at 2048x1024 (INTER_AREA's
# shrink by 2) and 2 at 1920x1080 (its fractional path, a second rect bin),
# 4 seg frames at 2048x1024 with labelId masks
CLI_FRAMES, CLI_OTHER_HW, CLI_OTHER, CLI_SEG_FRAMES, CLI_BS = 8, (1080, 1920), 2, 4, 8
CLI_IMG = 1024
# hub [12]: AutoShape at size 1024 on a PNG path (1920x1080), two HWC
# 2048x1024 frames (one batched call), a CHW 1280x720 and a gray 1024x768 one
HUB_SIZE = 1024
# [12] models whose input is not 3 channels: hub.create(channels=C) of the
# detection-only yolov5s, K1 on the C-channel frame
HUB_CH_CFG, HUB_CHANNELS = "yolov5s", (1, 4)
M_CFG = "yolov5m_city_seg"
X_CFG = "yolov5x_city_seg"     # pspv5x: [6] times K2's float32 form at its 22 bs1 sites
# [13] profiling, export and .pt: cli/profile.py at bs1 (K2) and bs8 (K7 too)
PROFILE_BATCHES, PROFILE_ITERS = (1, 8), 3
# the JAX package's estimate_gflops for pspv5s at 512x1024 (bench.py:273's
# 28.79 GF/frame), which leaves out the Focus conv, and that conv's 2 x MACs
# (3x3x12 -> 32 at 256x512); the port's counter must give their sum
JAX_PSPV5S_FLOPS = 28_793_847_808
FOCUS_FLOPS = 2 * 3 * 3 * 12 * 32 * 256 * 512
FLOP_REL = 1e-9
# an exported artifact against the live plain build on the same input: the
# same cuDNN graph, so equal but for kernel choice (TF32 off)
EXPORT_REL = 1e-6

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
TRAIN_REPS, TRAIN_REP_STEPS = 1, 5
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

# the training CLI [14]: cli/train.py on pspv5s at full width on seeded PNG
# trees in the Cityscapes layout (2048x1024 frames: 16 detection training
# frames, 4 val; 8 seg training and 2 val frames with labelId masks); run A
# two epochs at --img-size 832 1024 --batch-size 8 (2 steps an epoch, so
# three batches' mosaics, one seg batch), run B two epochs interrupted at
# epoch 1 and resumed, run C one epoch of the BiSe head with quad,
# multi-scale, remat and OHEM at 512; B, C and [15] (d) train on the first
# TC_SHORT detection frames (a list file: one step an epoch)
TC_ORIG_HW = (1024, 2048)
TC_DET, TC_VAL, TC_SEG, TC_SEG_VAL = 16, 4, 8, 2
TC_SHORT = 8
TC_IMG, TC_BS, TC_WORKERS = (832, 1024), 8, 8
TC_C_CFG, TC_C_IMG = "yolov5s_city_seg_bise", (512, 1024)
TC_BOXES = 12          # seeded boxes a detection frame

# the other model families [9], each at full width and depth, bs1
FAMILY_CFGS = ("yolov5s_city_seg_base", "yolov5s_city_seg_bise", "yolov5s_city_seg_lab",
               X_CFG, "yolov5s", "yolov5s6")
BISE_CFG, DET_CFG, L_CFG = "yolov5s_city_seg_bise", "yolov5s", "yolov5l_city_seg"
FAMILY_REPS, FAMILY_ITERS = 2, 3
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

# the DSL's other rows [16]: the v5.0 hub configs at full width and depth,
# seeded weights; yolov3 at bs1 and bs8 and through the eval path (one bs4
# batch); the transformer at bs1 and bs2 (K7 on its row-2 C3); the other
# four at bs1 in float32; one float32 train step of yolov5-panet at bs2
# 320x320 (the CPU's step at full width takes seconds there)
DSL_MAIN, DSL_TR = "yolov3", "yolov5s-transformer"
DSL_OTHERS = ("yolov3-spp", "yolov3-tiny", "yolov5-fpn", "yolov5-panet")
DSL_BS, DSL_TR_BS = 8, 2
DSL_TRAIN_CFG, DSL_TRAIN_BS, DSL_TRAIN_HW = "yolov5-panet", 2, (320, 320)

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


# the time a timing loop aims at: a call slower than TIMED_MS / iters is
# timed over fewer calls (at least one a replay), which its length makes as
# accurate
TIMED_MS = 100.0


def _calls(fn, n: int) -> float:
    """Host ms a call of ``fn`` over ``n`` synchronised calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call between CUDA events, host gaps included:
    for work that synchronises with the host (the plain NMS)."""
    iters = max(1, min(iters, int(TIMED_MS / max(_calls(fn, warmup), 1e-3))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Mean device milliseconds per call: ``iters`` calls captured in one
    CUDA graph and replayed, so the host's launch time does not count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        iters = max(1, min(iters, int(TIMED_MS / max(_calls(fn, 3), 1e-3))))
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
    """[1] the card's name and power limit, the kernels' build, and the
    count of their SASS instructions started in the background
    (:func:`sass_counts`); returns (the nvidia-smi line, the count's
    process), which :func:`check_sass` reads once the other phases ran."""
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
    return smi, sass_counts(path)


def sass_counts(lib):
    """A process that prints, for each kernel symbol of ``cuobjdump -sass``
    of the built library, its HMMA/HGMMA instructions ("H") and UTMALDG
    instructions ("T"), one tab-separated line each."""
    exe = next((c for c in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump")
                if c and os.path.exists(c)), None)
    if exe is None:
        raise RuntimeError("cuobjdump not found")
    count = ("/Function : /{sub(/.*Function : /, \"\"); f = $0; next} "
             "/HMMA|HGMMA/{h[f]++; next} /UTMALDG/{t[f]++} "
             "END{for (k in h) print \"H\\t\" k \"\\t\" h[k]; "
             "for (k in t) print \"T\\t\" k \"\\t\" t[k]}")
    return subprocess.Popen(f"{exe} -sass {lib} | awk '{count}'", shell=True,
                            stdout=subprocess.PIPE, text=True)


def check_sass(proc) -> None:
    """[1]'s instruction counts: every tensor-core form has HMMA/HGMMA
    instructions, and the TMA forms UTMALDG loads."""
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"cuobjdump -sass failed ({proc.returncode})")
    mma, tma = {}, {}
    for line in out.splitlines():
        kind, fn, n = line.split("\t")
        (mma if kind == "H" else tma)[fn] = int(n)
    for name in ("stem_tc", "stem_tf32", "conv3x3_tma", "conv3x3_tf32", "c3_bf16", "c3_tf32"):
        n = sum(v for k, v in mma.items() if name in k)
        log(f"  [1] HMMA/HGMMA instructions in the SASS of {name} (all instantiations): {n}")
        if n == 0:
            raise AssertionError(f"{name} has no tensor-core instruction")
    # the kernels that load their input by TMA
    for name in ("conv3x3_tma", "conv3x3_tf32", "c3_bf16"):
        n = sum(v for k, v in tma.items() if name in k)
        log(f"  [1] UTMALDG instructions in the SASS of {name}: {n}")
        if n == 0:
            raise AssertionError(f"{name} has no TMA load")


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


def time_k2(calls):
    """K2 at each ``(x, w, b, stride, dilation, act)`` of ``calls`` beside
    cuDNN in x's type (float32 with TF32 off) and the bound (in float32
    both bounds); returns (rows, sums)."""
    import torch.nn.functional as F

    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops.kernels.conv3x3 import plan as conv_plan
    rows = []
    f32 = calls[0][0].dtype == torch.float32
    for x, wt, b, s, d, act in calls:
        xc, wc, bc = x.permute(0, 3, 1, 2), wt.permute(0, 3, 1, 2), b.to(x.dtype)
        bsz, hh, ww, ci = x.shape
        co = wt.shape[0]
        ho, wo = (hh - 1) // s + 1, (ww - 1) // s + 1
        rows.append({
            "x": list(x.shape), "c_out": co, "stride": s, "dilation": d,
            "plan": plan_text(conv_plan(bsz, ho, wo, ci, co, x.dtype, s, d)),
            "ms": graph_ms(lambda: K.conv3x3(x, wt, b, s, d, act)),
            # few repetitions: cuDNN fp32 without TF32 takes ~75 ms at FFM's site
            "plain_ms": graph_ms(lambda: K.conv3x3_plain(x, wt, b, s, d, act),
                                 **({"iters": 3, "replays": 2} if f32 else {})),
            "library_ms": graph_ms(lambda: F.conv2d(xc, wc, bc, s, d, d),
                                   **({"iters": 3, "replays": 2} if f32 else {})),
            "bound_ms": conv_bound(x, co, s)[0],
            "bound_by": conv_bound(x, co, s)[1]})
        if f32:
            rows[-1]["cuda_core_bound_ms"] = conv_bound(x, co, s, cuda_cores=True)[0]
    sums = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")
            + (("cuda_core_bound_ms",) if f32 else ())}
    for r in rows:
        log(f"    {tuple(r['x'])} -> {r['c_out']} s{r['stride']} d{r['dilation']} "
            f"{r['plan']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, cuDNN "
            f"{'fp32' if f32 else 'bf16'} {r['library_ms']:.4f}, bound {r['bound_ms']:.5f}"
            + (f" (3xTF32; CUDA-core fp32 {r['cuda_core_bound_ms']:.5f})" if f32 else ""))
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
    1024x1024 (the engines' weights), pspv5m row 2 at bs2 and bs8 (c_ 48,
    two bottlenecks), no shortcut, and an H x W that is no multiple of the
    tile; at each, ops/kernels/c3.py's layout count must equal the kernel's
    (mk_c3_smem_bytes) at every plan, and the bf16 form's grid (persistent
    CTAs) must be no larger than its tiles.  Returns the float32 max |diff|
    at the pspv5s serving shape."""
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
                 ("pspv5m row 2 bs8", *c3_case(g, (SERVE_BS, side, side, 96), 48, 2, dt)),
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
            p = plan(*x.shape, *widths[1:], dt, *([torch.cuda.get_device_properties(
                x.device).multi_processor_count] if x.is_cuda else []))
            tiles = x.shape[0] * -(-x.shape[1] // p.th) * -(-x.shape[2] // p.tw)
            if p.ctas > tiles:
                raise AssertionError(f"c3 {tuple(x.shape)} {dt}: grid {p.ctas} > {tiles} tiles")
            what = (f"weights resident, {p.smem} B, grid of {p.ctas} persistent CTAs over "
                    f"{tiles} tiles" if dt == torch.bfloat16 else
                    f"{p.nbuf} weight buffer(s) of {p.rows or 'all'} rows, {p.smem} B, "
                    f"{p.ctas} CTAs")
            log(f"  c3 {str(dt)[6:]} {name} {tuple(x.shape)} c_ {a[0].shape[0]} n {len(a[6])}: "
                f"max|diff| {d:.3e}; plan {p.th}x{p.tw} tile, {what} (layout bytes = "
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
                 match_px=BOX_PX, mask_hws=None):
    """(dets, class maps) against the reference run's; the class maps are
    ORIG_HW, or each its ``mask_hws`` entry."""
    n_got = sum(len(d) for d in got[0])
    n_ref = sum(len(d) for d in ref[0])
    shares, boxes, scores = zip(*(match_dets(a, r, match_px)
                                  for a, r in zip(got[0], ref[0])))
    if any((a is None) != (r is None) for a, r in zip(got[1], ref[1])):
        raise AssertionError(f"{name}: a class map on one side only")
    mism = float(np.mean([(a != r).mean() if a is not None else 0.0
                          for a, r in zip(got[1], ref[1])]))
    log(f"  {name}: detections {n_got} vs {n_ref}")
    for i, (d, m) in enumerate(zip(*got)):
        hw = ORIG_HW if mask_hws is None else tuple(mask_hws[i])
        if not (np.isfinite(d).all() and d.shape[1] == 6
                and (m is None or (m.shape == hw and m.dtype == np.uint8))):
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


def eval_batches(eng, rng, batches: int = EVAL_BATCHES):
    """Seeded in-memory loaders in the batch contracts of the JAX package's
    loaders.  Detection: (imgs uint8, targets (B, T, 5) [cls, xywh
    normalized], tmask, paths, shapes), the labels a jittered subset of
    ``eng``'s own detections plus boxes no detection covers, so mAP is
    neither 0 nor 1.  Segmentation (none for a detection-only model):
    (imgs float in [0, 1], masks int32 at ORIG_HW): seeded uint8 labels,
    70% ``eng``'s class map, 30% random classes, 10% 255, with 255 mapped
    to the loader's ignore -1."""
    from multiyolov5_tpu_torch.ops.kernels import upsample_argmax
    from multiyolov5_tpu_torch.ops.nms import non_max_suppression
    det, seg = [], []
    h, w = IN_HW
    nc = eng.spec.nc
    for b in range(batches):
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
        if logits is None:                  # a detection-only model
            continue
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


def hold_path_kernels(rec, what: str = "eval", bound: float = F32_REL):
    """Each kernel against its plain version on the arguments a counted run
    of a path gave it (``rec`` as ``run_eval`` records it, with K3's
    ``nms_packed`` calls under "nms" where the path reaches K3): K1 in each
    mode, K2 and K7 within ``bound`` of max(max|ref|, 1), K4's mismatched
    pixel share within MASK_SHARE, K5's picks and K3's packed entries equal.
    Returns the max |diff| (K1, K2, K7), the share (K4) and the entries
    differing (K5, K3) of each kernel the path reached."""
    from multiyolov5_tpu_torch.ops import kernels as K
    errs = {}
    calls = dict(rec, stem=[c for c in rec["stem"] if not c[0][0].is_floating_point()],
                 stem_float=[c for c in rec["stem"] if c[0][0].is_floating_point()])
    for name, plain in (("stem", K.stem_plain), ("stem_float", K.stem_plain),
                        ("conv3x3", K.conv3x3_plain), ("c3", K.c3_plain)):
        if not calls[name]:
            continue
        worst_abs = worst_rel = 0.0
        for args, kw in calls[name]:
            got = getattr(K, name)(*args, **kw)
            torch.cuda.synchronize()
            da, dr = diffs(got, plain(*args, **kw))
            worst_abs, worst_rel = max(worst_abs, da), max(worst_rel, dr)
        shapes = sorted({tuple(a[0].shape) for a, _ in calls[name]})
        log(f"  {name} at {what}'s {len(calls[name])} calls {shapes}: "
            f"max|diff| {worst_abs:.3e}")
        check(f"{name} {what} max|diff|/max(max|ref|,1)", worst_rel, bound)
        errs[name] = worst_abs
    if rec["upsample_argmax"]:
        share = 0.0
        for args, kw in rec["upsample_argmax"]:
            got = K.upsample_argmax(*args, **kw)
            torch.cuda.synchronize()
            share = max(share,
                        (got != K.upsample_argmax_plain(*args, **kw)).float().mean().item())
        shapes = [(tuple(a[0].shape), tuple(a[1])) for a, _ in rec["upsample_argmax"]]
        check(f"upsample_argmax at {what}'s {shapes} mismatched pixel share", share, MASK_SHARE)
        errs["upsample_argmax"] = share
    if rec["nms_greedy"]:
        errs["nms_greedy"] = float(hold_k5(rec["nms_greedy"], f"{what}'s lists"))
    if rec.get("nms"):
        diff = 0
        for args, kw in rec["nms"]:
            idx, valid = K.nms_packed(*args, **kw)
            torch.cuda.synchronize()
            want_idx, want_valid = K.nms_packed_plain(*args, **kw)
            diff += int((idx != want_idx).sum()) + int((valid != want_valid).sum())
        shapes = [tuple(a[1].shape) for a, _ in rec["nms"]]
        check(f"nms packed entries differing from plain at {what}'s lists {shapes}", diff, 0)
        errs["nms"] = float(diff)
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
    errs = hold_path_kernels(card)

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
    f32_sites, k2_f32 = time_k2([(x, wt, b, kw.get("stride", 1), kw.get("dilation", 1),
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
    x_sites, k2_x = time_k2(x_calls)
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
    # (float32, the counted eval run's own arguments), at pspv5m's
    # (float32, c_ 48, two bottlenecks, bs2 1024x1024, seeded weights) and
    # at pspv5m's bs8 1024x1024 (bf16, seeded weights);
    # "library" is the unfused sequence the module runs otherwise (5 cuDNN
    # convs, cat, add; TF32 off): no single PyTorch call computes a C3
    c3_times = {}
    side = SERVE_IMG // 4
    (x_ev, *a_ev), _ = ev["rec"]["c3"][0]
    x_m, a_m = c3_case(g, (2, side, side, 96), 48, 2, torch.float32)
    x_m16, a_m16 = c3_case(g, (SERVE_BS, side, side, 96), 48, 2, torch.bfloat16)
    for name, mod, x, args in (
            ("serving", c3_row(eng16), None, None),
            ("eval", c3_row(eng32), x_ev, tuple(a_ev)),
            ("pspv5m", c3_module(a_m), x_m, a_m),
            ("pspv5m_bs8_bf16", c3_module(a_m16), x_m16, a_m16)):
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


def app_lines(det, im0_shape, save_conf: bool = True):
    """The ``--save-txt`` lines ``cli/detect.py`` writes for ``det``."""
    from multiyolov5_tpu_torch.utils.boxes import xyxy2xywh
    gn = np.array(im0_shape)[[1, 0, 1, 0]]
    out = []
    for *xyxy, conf, cls in reversed(det):
        xywh = (xyxy2xywh(np.array(xyxy)[None]) / gn).ravel().tolist()
        line = (cls, *xywh, conf) if save_conf else (cls, *xywh)
        out.append(("%g " * len(line)).rstrip() % line)
    return out


def run_app(argv):
    """``cli.detect.main(argv)`` with its output kept; returns (save dir,
    the loop's seconds as the app prints them)."""
    from multiyolov5_tpu_torch.cli.detect import main as detect_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = detect_main(argv)
    return out, float(buf.getvalue().strip().splitlines()[-1].split("(")[1].rstrip("s)"))


def app_stages(argv) -> dict:
    """One more app run with its stages timed on the host clock (each
    function wrapped where the app looks it up): ms a frame in each, and
    in the rest of the app's loop."""
    import multiyolov5_tpu_torch.cli.detect as app
    import multiyolov5_tpu_torch.data.sources as sources
    from multiyolov5_tpu_torch.data import png
    from multiyolov5_tpu_torch.engine import Engine
    spent = {}

    def timed(name, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    stages = (("read (png.imread)", png, "imread"), ("letterbox", sources, "letterbox"),
              ("Engine.__call__", Engine, "__call__"),
              ("draw (plot_one_box)", app, "plot_one_box"), ("mask colours", app, "label2image"),
              ("overlay (add_weighted)", app, "add_weighted"),
              ("write (png.imwrite)", png, "imwrite"))
    with contextlib.ExitStack() as stack:
        for name, owner, attr in stages:
            stack.enter_context(replaced(owner, attr, timed(name, getattr(owner, attr))))
        _, loop_s = run_app(argv)
    out = {name: spent.get(name, 0.0) * 1e3 / APP_FRAMES for name, _, _ in stages}
    out["rest of the loop"] = loop_s * 1e3 / APP_FRAMES - sum(out.values())
    return out


def phase_app(eng32, eng16, cpu_eng, frames, card: str):
    """[10] the detect app on the card (pspv5s, bf16, --img-size 1024, on
    seeded 2048x1024 PNG frames), its artifacts read back with the port's
    PNG codec and held against ``Engine`` on the same frames; and each
    ``Engine`` argument of the app's path (classes, agnostic, multi-label,
    max_det, TTA, a 2-checkpoint ensemble) card against CPU."""
    from multiyolov5_tpu_torch.data import png
    from multiyolov5_tpu_torch.data.cityscapes import CITYSCAPES_COLORMAP, id2trainid, label2image
    from multiyolov5_tpu_torch.data.sources import LoadImages
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.utils.checkpoint import save_npz, to_jax_params
    log(f"[10] the detect app: cli.detect.main on {APP_FRAMES} seeded BGR {ORIG_HW} PNG frames, "
        f"{CFG} seed {SEED} bf16, --img-size {APP_IMG} --save-txt --save-conf, with and "
        f"without --submit")
    work = os.path.join(ROOT, "build", "chip_smoke_app")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "src"))
    spec = load_spec(CFG)
    weights = []
    for seed in (SEED, SEED + 1):
        params, state = to_jax_params(seeded_state_dict(spec, seed))
        weights.append(os.path.join(work, f"w{seed}.npz"))
        save_npz(weights[-1], {"params": params, "state": state,
                               "spec_yaml": json.dumps(spec.yaml)})
    rng = np.random.RandomState(SEED + 23)
    for i in range(APP_FRAMES):
        png.imwrite(os.path.join(work, "src", f"frame{i}.png"),
                    rng.randint(0, 256, (*ORIG_HW, 3)).astype(np.uint8))
    src = os.path.join(work, "src")
    res = {"frames": APP_FRAMES, "img_size": APP_IMG}
    for submit in (False, True):
        tag = "submit" if submit else "plain"
        argv = ["--weights", weights[0], "--source", src, "--img-size", str(APP_IMG),
                "--save-txt", "--save-conf", "--project", work, "--name", tag, "--exist-ok",
                "--device", "" if DEVICE == "cuda" else DEVICE]      # "": the app's default, the card
        argv += ["--submit"] if submit else []
        run_app(argv)                   # the geometry's first call (allocator, cuDNN)
        shutil.rmtree(os.path.join(work, tag))
        K.reset_launches()
        out, loop_s = run_app(argv)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        want = {"stem": APP_FRAMES, "stem_float": 0, "conv3x3": 10 * APP_FRAMES,
                "nms": APP_FRAMES, "upsample_argmax": APP_FRAMES, "nms_greedy": 0, "c3": 0}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"app launches {launches}, want {want}")
        n_det, n_files = 0, 0
        for path, img, im0, _ in LoadImages(src, APP_IMG, eng16.stride, auto=not submit):
            dets, maps = eng16(img[None], im0.shape[:2])
            stem = os.path.splitext(os.path.basename(path))[0]
            arts = {"annotated": f"{stem}.png", "mask": f"{stem}_mask.png",
                    "dst": f"{stem}_dst.png"}
            if submit:
                arts["pred"] = f"results/{stem}_pred.png"
            decoded = {k: png.imread(os.path.join(out, v)) for k, v in arts.items()}
            n_files += len(arts)
            if any(v.shape != im0.shape for v in decoded.values()):
                raise AssertionError(f"{tag}: an artifact of {stem} is not {im0.shape}")
            if not np.array_equal(decoded["mask"], label2image(maps[0], CITYSCAPES_COLORMAP)[..., ::-1]):
                raise AssertionError(f"{tag}: {stem}_mask.png is not Engine's class map")
            if submit and not np.array_equal(id2trainid(decoded["pred"][..., 0]), maps[0]):
                raise AssertionError(f"{tag}: {stem}_pred.png trainIds are not Engine's class map")
            with open(os.path.join(out, "labels", f"{stem}.txt")) as fh:
                lines = fh.read().splitlines()
            if lines != app_lines(dets[0], im0.shape):
                raise AssertionError(f"{tag}: labels/{stem}.txt is not Engine's detections")
            n_det += len(lines)
        res[tag] = {"letterbox": list(img.shape[:2]), "launches": launches,
                    "detections": n_det, "artifacts": n_files,
                    "ms_per_frame": loop_s * 1e3 / APP_FRAMES}
        log(f"  --submit {submit}: letterbox {img.shape[:2]}, {n_det} detections, {n_files} "
            f"images read back; txt, _mask{' and _pred' if submit else ''} equal Engine's; "
            f"launches {launches}")
        log(f"  app ms/frame (read, letterbox, Engine, draw, write {len(arts)} PNGs): "
            f"{res[tag]['ms_per_frame']:.1f} on {card}")
        if submit:                      # the stages of the run that writes every artifact
            stages = app_stages(argv)
            res[tag]["stages_ms_per_frame"] = stages
            log("  its stages, ms/frame (another run): " + ", ".join(
                f"{k} {v:.1f}" for k, v in stages.items()))

    log(f"  Engine's arguments, fp32 card vs CPU on a {IN_HW} frame -> {ORIG_HW}, conf {CONF}")
    frame = frames[0]
    ens_card = Engine(weights, device=DEVICE, half=False)
    ens_cpu = Engine(weights, device="cpu", half=False)
    cases = (("classes [0, 2, 5]", eng32, cpu_eng, dict(classes=[0, 2, 5]),
              {"nms": 1, "nms_greedy": 0}),
             ("agnostic", eng32, cpu_eng, dict(agnostic=True), {"nms": 1}),
             ("multi_label", eng32, cpu_eng, dict(multi_label=True),
              {"nms": 1, "nms_greedy": 0}),
             (f"max_det {APP_MAX_DET}", eng32, cpu_eng, dict(max_det=APP_MAX_DET), {"nms": 1}),
             ("augment", eng32, cpu_eng, dict(augment=True),
              {"stem": 1, "stem_float": 2, "conv3x3": 30, "nms": 1, "upsample_argmax": 1}),
             ("ensemble of 2", ens_card, ens_cpu, {},
              {"stem": 2, "conv3x3": 20, "nms": 0, "nms_greedy": 1, "upsample_argmax": 1}))
    res["args"] = {}
    for name, card_eng, ref_eng, kw, want in cases:
        K.reset_launches()
        card = card_eng(frame, ORIG_HW, conf=CONF, **kw)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        t0 = time.perf_counter()
        ref = ref_eng(frame, ORIG_HW, conf=CONF, **kw)
        cpu_s = time.perf_counter() - t0
        if "classes" in kw and not set(card[0][0][:, 5].astype(int)) <= set(kw["classes"]):
            raise AssertionError(f"{name}: a class outside the filter")
        if "max_det" in kw and len(card[0][0]) != kw["max_det"]:
            raise AssertionError(f"{name}: {len(card[0][0])} detections, want {kw['max_det']}")
        log(f"  {name}: launches {launches} (the CPU call took {cpu_s:.1f} s)")
        compare_runs(f"{name} fp32 card vs CPU", card, ref, E2E_MATCH_SHARE, BOX_PX,
                     E2E_SCORE_ABS, E2E_MASK_SHARE)
        res["args"][name] = {"launches": launches, "detections": len(card[0][0]),
                             "cpu_detections": len(ref[0][0])}
    shutil.rmtree(work, ignore_errors=True)
    return res


WEIGHTS_DIR = os.path.join(ROOT, "build", "chip_smoke_weights")
_WEIGHTS_WRITTEN = set()     # the npz files this run wrote


@functools.lru_cache(maxsize=None)
def smoke_weights(seed: int = SEED) -> str:
    """The smoke's seeded pspv5s weights as a native ``.npz``, written at the
    first call of a run for ``seed`` and shared by the phases that load them."""
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.utils.checkpoint import save_npz, to_jax_params
    path = os.path.join(WEIGHTS_DIR, f"w{seed}.npz")
    if path in _WEIGHTS_WRITTEN:
        return path
    spec = load_spec(CFG)
    params, state = to_jax_params(seeded_state_dict(spec, seed))
    os.makedirs(WEIGHTS_DIR, exist_ok=True)
    save_npz(path, {"params": params, "state": state, "spec_yaml": json.dumps(spec.yaml)})
    _WEIGHTS_WRITTEN.add(path)
    return path


def label_split(eng, img_dir: str, lbl_dir: str, rng, img_size: int, batch_size: int):
    """Labels for the PNG frames in ``img_dir``, made from what ``cli.test``
    will evaluate: each frame's rect letterbox from the CLI's own
    ``DetectionDataset`` (``img_size``, ``batch_size``), through ``eng`` and
    eval's NMS, unmapped with the item's ``shapes``; of the 90 best
    detections of at least 16x16 px, 30 moved by 2 px (sd) on each edge,
    plus 6 boxes none covers, so mAP@.5 is neither 0 nor 1."""
    from multiyolov5_tpu_torch.data.detection import CACHE_SUFFIX, DetectionDataset
    from multiyolov5_tpu_torch.ops.nms import non_max_suppression
    from multiyolov5_tpu_torch.utils.boxes import scale_coords
    os.makedirs(lbl_dir, exist_ok=True)
    nc = eng.spec.nc
    # cli/test.py's detection dataset, before any label exists
    ds = quiet(DetectionDataset, img_dir, img_size=img_size, batch_size=batch_size, rect=True,
               stride=eng.stride, pad=0.5)
    for i in range(len(ds)):
        img, _, path, ((h, w), ratio_pad) = ds[i]
        z, _ = eng.forward(torch.from_numpy(img[None]).to(DEVICE))
        d = non_max_suppression(z.transpose(1, 2), EVAL_CONF, EVAL_IOU, multi_label=True,
                                max_nms=EVAL_MAX_NMS)[0]
        d[:, :4] = np.clip(np.asarray(scale_coords(img.shape[:2], d[:, :4], (h, w),
                                                   ratio_pad))[:, :4], 0, [w, h, w, h])
        d = d[(d[:, 2] - d[:, 0] >= 16) & (d[:, 3] - d[:, 1] >= 16)][:90]
        pick = d[rng.choice(len(d), min(30, len(d)), replace=False)]
        xyxy = pick[:, :4] + rng.randn(len(pick), 4) * 2
        extra = rng.rand(6, 2) * [w - 160, h - 160]
        xyxy = np.clip(np.concatenate([xyxy, np.concatenate([extra, extra + 160], 1)]), 0,
                       [w, h, w, h])
        cls = np.concatenate([pick[:, 5], rng.randint(0, nc, 6)])
        stem = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(lbl_dir, f"{stem}.txt"), "w") as fh:
            for c, (x0, y0, x1, y1) in zip(cls, xyxy):
                fh.write("%d %.6f %.6f %.6f %.6f\n" % (c, (x0 + x1) / 2 / w, (y0 + y1) / 2 / h,
                                                       (x1 - x0) / w, (y1 - y0) / h))
    os.remove(lbl_dir + CACHE_SUFFIX)     # the label cache made before the labels


def cli_tree(eng, work: str, rng) -> str:
    """[11]'s seeded PNG trees under ``work``: ``det/images/val`` +
    ``det/labels/val`` (labelled by :func:`label_split` at the CLI's
    ``CLI_IMG`` and ``CLI_BS``) and the Cityscapes ``leftImg8bit/val/<city>``
    + ``gtFine/val`` labelIds (``eng``'s class map, 30% random classes, 10%
    255).  Returns the dataset file (JSON, which the CLI reads without
    PyYAML)."""
    from multiyolov5_tpu_torch.data import png
    from multiyolov5_tpu_torch.data.cityscapes import CITYSCAPES_IDMAP
    from multiyolov5_tpu_torch.data.letterbox import letterbox
    img_dir, lbl_dir = (os.path.join(work, "det", d, "val") for d in ("images", "labels"))
    os.makedirs(img_dir)
    nc = eng.spec.nc
    for i, (h, w) in enumerate([ORIG_HW] * CLI_FRAMES + [CLI_OTHER_HW] * CLI_OTHER):
        png.imwrite(os.path.join(img_dir, f"frankfurt_{i:06d}.png"),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    label_split(eng, img_dir, lbl_dir, rng, CLI_IMG, CLI_BS)
    seg_root = os.path.join(work, "citys")
    for i in range(CLI_SEG_FRAMES):
        city = ("frankfurt", "lindau")[i % 2]
        stem = f"{city}_{i:06d}_000019"
        idir = os.path.join(seg_root, "leftImg8bit", "val", city)
        mdir = os.path.join(seg_root, "gtFine", "val", city)
        os.makedirs(idir, exist_ok=True)
        os.makedirs(mdir, exist_ok=True)
        bgr = rng.randint(0, 256, (*ORIG_HW, 3)).astype(np.uint8)
        png.imwrite(os.path.join(idir, f"{stem}_leftImg8bit.png"), bgr)
        x = letterbox(bgr[..., ::-1].copy(), IN_HW, auto=False, device=DEVICE)[0]
        cmap = eng(x, ORIG_HW)[1][0]
        ids = CITYSCAPES_IDMAP[np.where(rng.rand(*ORIG_HW) < 0.3,
                                        rng.randint(0, eng.spec.n_segcls, ORIG_HW), cmap)]
        ids[rng.rand(*ORIG_HW) < 0.1] = 255
        png.imwrite(os.path.join(mdir, f"{stem}_gtFine_labelIds.png"), ids)
    data = os.path.join(work, "data.json")
    with open(data, "w") as fh:
        json.dump({"val": img_dir, "segval": seg_root, "nc": nc, "names": eng.names}, fh)
    return data


def run_cli(argv, kernels: bool):
    """``cli.test.main(argv)`` with its output kept; returns (metrics, the
    recorded arguments (as ``run_eval``'s), evaluate_detection's (t_inf,
    t_nms, seen), host seconds in the loaders' items by kind, items by
    kind, the run's seconds)."""
    import threading

    from multiyolov5_tpu_torch import engine as engine_mod
    from multiyolov5_tpu_torch import evaluation as E
    from multiyolov5_tpu_torch.cli import test as cli
    from multiyolov5_tpu_torch.data.detection import DetectionDataset
    from multiyolov5_tpu_torch.data.segmentation import CitySegmentation
    from multiyolov5_tpu_torch.models import blocks
    from multiyolov5_tpu_torch.ops import nms as nms_mod
    rec = {k: [] for k in ("net", "dets", "stem", "conv3x3", "c3", "nms_greedy",
                           "upsample_argmax", "eval")}
    spent, count, lock = {"det": 0.0, "seg": 0.0}, {"det": 0, "seg": 0}, threading.Lock()

    def timed(kind, fn):
        def wrapper(self, index, *gens):
            t0 = time.perf_counter()
            try:
                return fn(self, index, *gens)
            finally:
                with lock:
                    spent[kind] += time.perf_counter() - t0
                    count[kind] += 1
        return wrapper

    # the loaders build each item by the datasets' ``item``
    spies = [spied(cli, "evaluate_detection", after=rec["eval"].append),
             replaced(DetectionDataset, "item", timed("det", DetectionDataset.item)),
             replaced(CitySegmentation, "item", timed("seg", CitySegmentation.item))]
    if kernels:
        spies += [spied(engine_mod.Engine, "forward", after=rec["net"].append),
                  spied(E, "non_max_suppression", after=rec["dets"].extend),
                  spied(engine_mod, "stem", before=recorder(rec["stem"])),
                  spied(blocks, "conv3x3", before=recorder(rec["conv3x3"])),
                  spied(blocks, "c3", before=recorder(rec["c3"])),
                  spied(nms_mod, "nms_greedy", before=recorder(rec["nms_greedy"])),
                  spied(E, "upsample_argmax", before=recorder(rec["upsample_argmax"]))]
    with contextlib.ExitStack() as stack:
        for sp in spies:
            stack.enter_context(sp)
        t0 = time.perf_counter()
        res = quiet(cli.main, argv)
        wall = time.perf_counter() - t0
    return res, rec, rec["eval"][0][2], spent, count, wall


def host_ms(fn, reps: int = 3) -> float:
    """Median host ms of ``fn()`` over ``reps`` calls, one thread."""
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def loader_stages(work: str) -> dict:
    """Host ms of each stage of the loaders' items on one thread, on [11]'s
    first frame of each kind: the PNG reads (frame and mask), cv2's ``INTER_AREA`` by 2 and
    at 1920x1080 -> 1024x576 (``data/resize.py``), the letterbox, PIL's
    ``BILINEAR`` 2048x1024 -> 1024x512.  Beside each resampler, the
    library's own call on the same image where it imports (timed here and
    used nowhere in the port), else None."""
    from multiyolov5_tpu_torch.data import png
    from multiyolov5_tpu_torch.data.letterbox import letterbox
    from multiyolov5_tpu_torch.data.resize import resize_area, resize_bilinear_pil
    stage_ms = functools.partial(host_ms, reps=1)     # one call a stage
    det = png.imread(os.path.join(work, "det", "images", "val", "frankfurt_000000.png"))
    other = png.imread(os.path.join(work, "det", "images", "val",
                                    f"frankfurt_{CLI_FRAMES:06d}.png"))
    city = os.path.join(work, "citys", "leftImg8bit", "val", "frankfurt")
    seg_path = os.path.join(city, sorted(os.listdir(city))[0])
    seg = png.read_rgb(seg_path)
    masks = os.path.join(work, "citys", "gtFine", "val", "frankfurt")
    mask_path = os.path.join(masks, sorted(os.listdir(masks))[0])
    half = (det.shape[1] // 2, det.shape[0] // 2)
    frac = (CLI_IMG, other.shape[0] * CLI_IMG // other.shape[1])
    small = resize_area(det, half)
    out = {"png_imread_2048x1024": stage_ms(lambda: png.imread(seg_path)),
           "resize_area_by_2": stage_ms(lambda: resize_area(det, half)),
           "resize_area_fractional": stage_ms(lambda: resize_area(other, frac)),
           "letterbox_to_544x1056": stage_ms(lambda: letterbox(
               small, (math.ceil(CLI_IMG / 64 + 0.5) * 32, math.ceil(CLI_IMG / 32 + 0.5) * 32),
               auto=False, scaleup=False)),
           "png_read_rgb_2048x1024": stage_ms(lambda: png.read_rgb(seg_path)),
           "resize_bilinear_pil_to_1024x512": stage_ms(lambda: resize_bilinear_pil(seg, half)),
           "png_read_samples_mask": stage_ms(lambda: png.read_samples(mask_path)),
           "cv2_inter_area_by_2": None, "cv2_inter_area_fractional": None,
           "pil_bilinear_to_1024x512": None}
    try:
        import cv2
        out["cv2_inter_area_by_2"] = stage_ms(
            lambda: cv2.resize(det, half, interpolation=cv2.INTER_AREA))
        out["cv2_inter_area_fractional"] = stage_ms(
            lambda: cv2.resize(other, frac, interpolation=cv2.INTER_AREA))
    except ImportError:
        pass
    try:
        from PIL import Image
        im = Image.fromarray(seg)
        out["pil_bilinear_to_1024x512"] = stage_ms(lambda: im.resize(half, Image.BILINEAR))
    except ImportError:
        pass
    return out


def phase_eval_cli(eng32, card: str):
    """[11] the eval CLI at full width on the card, against the same CLI on
    the CPU; each kernel of its path held against its plain version on the
    arguments the path gave it; the loaders' host time beside the
    forward's and the NMS's."""
    from multiyolov5_tpu_torch.ops import kernels as K
    log(f"[11] the eval CLI: cli.test.main, {CFG} seed {SEED} fp32, --img-size {CLI_IMG} "
        f"--base-size {CLI_IMG} --batch-size {CLI_BS}, on {CLI_FRAMES} seeded {ORIG_HW} and "
        f"{CLI_OTHER} {CLI_OTHER_HW} detection PNG frames and {CLI_SEG_FRAMES} {ORIG_HW} "
        f"Cityscapes frames with labelId masks")
    work = os.path.join(ROOT, "build", "chip_smoke_eval")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    weights = smoke_weights()
    data = cli_tree(eng32, work, np.random.RandomState(SEED + 31))
    log(f"  trees written in {time.perf_counter() - t0:.1f} s")
    argv = ["--weights", weights, "--data", data, "--img-size", str(CLI_IMG), "--base-size",
            str(CLI_IMG), "--batch-size", str(CLI_BS), "--save-dir", os.path.join(work, "out")]
    card_argv = argv + ["--device", "" if DEVICE == "cuda" else DEVICE]  # "": the card

    from multiyolov5_tpu_torch.utils import plots
    out, plot_ms = os.path.join(work, "out"), {}
    os.makedirs(out)
    K.reset_launches()
    with timed_calls(chart_pairs(plots), plot_ms):
        plotted, rec, _, _, _, _ = run_cli(card_argv + ["--plots"], kernels=True)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    for f in ("PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png"):
        read_plot(os.path.join(out, f), (1500, 2250))
    read_plot(os.path.join(out, "confusion_matrix.png"), (2250, 3000))
    log(f"  --plots: the PR, F1, P and R curves and confusion_matrix.png decode at their "
        f"sizes; host ms " + ", ".join(f"{k} {np.median(v):.1f}" + (
            f" (x{len(v)})" if len(v) > 1 else "") for k, v in plot_ms.items()))
    log(f"  launches on the CLI's path: {launches}")
    det_shapes = sorted({tuple(a[0].shape) for a, _ in rec["stem"]
                         if not a[0].is_floating_point()})
    seg_shapes = sorted({tuple(a[0].shape) for a, _ in rec["stem"] if a[0].is_floating_point()})
    k4_shapes = sorted({(tuple(a[0].shape), tuple(a[1])) for a, _ in rec["upsample_argmax"]})
    log(f"  detection batches {det_shapes}, seg batches {seg_shapes}, K4 {k4_shapes}")
    for k in ("stem", "stem_float", "conv3x3", "c3", "nms_greedy", "upsample_argmax"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the eval CLI's path")
    # the 2:1 bin's letterbox (data/detection.py): ceil(0.5 * 1024 / 32 + 0.5)
    # * 32 x ceil(1024 / 32 + 0.5) * 32 = 544 x 1056
    rect = (CLI_BS, math.ceil(CLI_IMG / 64 + 0.5) * 32, math.ceil(CLI_IMG / 32 + 0.5) * 32, 3)
    if rect not in det_shapes or launches["c3"] != len(det_shapes) or launches["nms"]:
        raise AssertionError(f"the CLI's detection batches {det_shapes}, K7 {launches['c3']}, "
                             f"K3 {launches['nms']}: want {rect} among them, K7 once a "
                             "batched forward, no K3")
    errs = hold_path_kernels(rec, "the eval CLI")
    del rec

    got, _, (t_inf, t_nms, seen), spent, count, wall = run_cli(card_argv, kernels=False)
    for k in ("P", "R", "mAP50", "mAP", "pixAcc", "mIoU"):   # --plots leaves them as they are
        check(f"eval CLI with --plots vs without: {k} |diff|", abs(plotted[k] - got[k]),
              SEG_METRIC_ABS if k in ("pixAcc", "mIoU") else EVAL_METRIC_ABS)
    t0 = time.perf_counter()
    ref, _, _, _, _, cpu_wall = run_cli(argv + ["--device", "cpu"], kernels=False)
    for k in ("P", "R", "mAP50", "mAP", "pixAcc", "mIoU"):
        bound = SEG_METRIC_ABS if k in ("pixAcc", "mIoU") else EVAL_METRIC_ABS
        log(f"  {k}: card {got[k]:.6f}, CPU {ref[k]:.6f}")
        check(f"eval CLI fp32 card vs CPU: {k} |diff|", abs(got[k] - ref[k]), bound)
    # labels from the model's own detections on the CLI's inputs
    # (cli_tree): a sound path lands mAP@.5 well inside (0.05, 0.95)
    if not (0.05 < got["mAP50"] < 0.95 and 0.0 < got["mIoU"] < 1.0):
        raise AssertionError(f"degenerate metrics: {got}")
    times = {"loader_det_host_ms_per_image": spent["det"] * 1e3 / max(count["det"], 1),
             "loader_seg_host_ms_per_image": spent["seg"] * 1e3 / max(count["seg"], 1),
             "forward_ms_per_image": t_inf * 1e3 / seen, "nms_ms_per_image": t_nms * 1e3 / seen,
             "cli_s": wall, "cpu_cli_s": cpu_wall}
    log(f"  on {card}: detection loader {times['loader_det_host_ms_per_image']:.1f} host "
        f"ms an image (PNG read, INTER_AREA, letterbox, in each item, on the loader's 4 "
        f"threads), seg loader {times['loader_seg_host_ms_per_image']:.1f} (PNG reads, PIL "
        f"BILINEAR, labelIds); evaluate_detection forward "
        f"{times['forward_ms_per_image']:.2f} ms/image, NMS {times['nms_ms_per_image']:.2f}; "
        f"the CLI {wall:.2f} s (the CPU's {cpu_wall:.1f} s)")
    stages = loader_stages(work)
    log(f"  the loaders' stages on one host thread of {card}, ms (the libraries' own "
        f"resamplers beside, used nowhere in the port): "
        + ", ".join(f"{k} {v:.1f}" for k, v in stages.items() if v is not None))
    shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "errs": errs, "det_batches": [list(s) for s in det_shapes],
            "seg_batches": [list(s) for s in seg_shapes],
            "metrics": {"card": got, "cpu": ref}, "times": times, "loader_stages": stages,
            "plot_host_ms": plot_ms, "card": card}


def hub_inputs(work: str, rng):
    """[12]'s mixed list: a PNG path, two same-size HWC frames (one batched
    call), a CHW and a 2-D gray array; RGB, as a hub user passes them."""
    from multiyolov5_tpu_torch.data import png
    path = os.path.join(work, "street.png")
    png.imwrite(path, rng.randint(0, 256, (*CLI_OTHER_HW, 3)).astype(np.uint8))
    hwc = [rng.randint(0, 256, (*ORIG_HW, 3)).astype(np.uint8) for _ in range(2)]
    chw = rng.randint(0, 256, (3, 720, 1280)).astype(np.uint8)
    gray = rng.randint(0, 256, (768, 1024)).astype(np.uint8)
    return [path, hwc[0], chw, gray, hwc[1]]


def hub_call(shape, inputs, kernels: bool):
    """One ``AutoShape`` call on ``inputs`` with the launch counts set to 0
    just before it; with ``kernels``, the arguments of each kernel the call
    reaches (as ``run_eval`` records them, K3's ``nms_packed`` under "nms")
    and each network output ("net").  Returns (Detections, launches, the
    records, ms)."""
    from multiyolov5_tpu_torch import engine as engine_mod
    from multiyolov5_tpu_torch.models import blocks
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops import nms as nms_mod
    rec = {k: [] for k in ("net", "stem", "conv3x3", "c3", "nms", "nms_greedy",
                           "upsample_argmax")}
    spies = []
    if kernels:
        spies = [spied(engine_mod.Engine, "forward", after=rec["net"].append),
                 spied(engine_mod, "stem", before=recorder(rec["stem"])),
                 spied(blocks, "conv3x3", before=recorder(rec["conv3x3"])),
                 spied(blocks, "c3", before=recorder(rec["c3"])),
                 spied(nms_mod, "nms_packed", before=recorder(rec["nms"])),
                 spied(nms_mod, "nms_greedy", before=recorder(rec["nms_greedy"])),
                 spied(engine_mod, "upsample_argmax", before=recorder(rec["upsample_argmax"]))]
    with contextlib.ExitStack() as stack:
        for sp in spies:
            stack.enter_context(sp)
        K.reset_launches()
        t0 = time.perf_counter()
        out = shape(inputs, size=HUB_SIZE)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = K.launch_counts()
    return out, launches, rec, ms


def phase_hub(card: str):
    """[12] hub: ``yolov5s_city_seg``'s AutoShape, fp32 and bf16 (the hub's
    default), on a mixed list: each kernel held against its plain version
    on the arguments each counted call gave it, fp32 card against the CPU
    under [3]'s bounds, the bf16 network against the fp32 one under [3]'s
    bf16 bounds; then the 1- and 4-channel models (:func:`hub_channels`)
    and the ``Model`` facade's ``autoshape()`` (:func:`hub_facade`)."""
    from multiyolov5_tpu_torch import hub
    log(f"[12] hub: yolov5s_city_seg(pretrained=<the smoke's weights>) AutoShape at size "
        f"{HUB_SIZE} on a PNG path {CLI_OTHER_HW}, two HWC {ORIG_HW} frames, a CHW (720, 1280) "
        f"and a gray (768, 1024) array")
    work = os.path.join(ROOT, "build", "chip_smoke_hub")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    weights = smoke_weights()
    inputs = hub_inputs(work, np.random.RandomState(SEED + 41))
    shape32 = hub.yolov5s_city_seg(pretrained=weights, device=DEVICE, half=False)
    shape16 = hub.yolov5s_city_seg(pretrained=weights, device=DEVICE)
    ref_shape = hub.yolov5s_city_seg(pretrained=weights, device="cpu", half=False)
    # four same-size groups: three single frames (K3) and one pair (K7, K5)
    want = {"stem": 4, "stem_float": 0, "conv3x3": 40, "c3": 1, "nms": 3, "nms_greedy": 1,
            "upsample_argmax": 4}
    runs, errs = {}, {}
    for dt, shape, bound in (("fp32", shape32, F32_REL), ("bf16", shape16, BF16_REL)):
        shape(inputs, size=HUB_SIZE)            # the geometry's first call (allocator, cuDNN)
        got, launches, rec, _ = hub_call(shape, inputs, kernels=True)
        log(f"  launches ({dt}): {launches}")
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"hub {dt} launches {launches}, want {want}")
        errs[dt] = hold_path_kernels(rec, f"hub {dt}", bound)
        runs[dt] = got, rec["net"], launches
        del rec
    got, net32, launches = runs["fp32"]
    half, net16, launches16 = runs["bf16"]
    _, _, _, ms = hub_call(shape32, inputs, kernels=False)
    log(f"  {ms:.1f} ms for the list (fp32) on {card}")
    ref = ref_shape(inputs, size=HUB_SIZE)
    hws = [im.shape[:2] for im in got.imgs]
    if hws != [im.shape[:2] for im in ref.imgs] or got.files[0] != "street.jpg":
        raise AssertionError(f"hub images {hws}, files {got.files}")
    compare_runs("hub fp32 card vs CPU", (got.pred, got.masks), (ref.pred, ref.masks),
                 E2E_MATCH_SHARE, BOX_PX, E2E_SCORE_ABS, E2E_MASK_SHARE, mask_hws=hws)
    for (z16, seg16), (z32, seg32) in zip(net16, net32):
        check(f"hub network bf16 vs fp32 card {tuple(z32.shape)}: seg logits "
              "max|diff|/max(max|ref|,1)", diffs(seg16, seg32)[1], BF16_SEG_REL)
        check(f"hub network bf16 vs fp32 card {tuple(z32.shape)}: obj/cls mean |diff|",
              (z16[:, 4:].float() - z32[:, 4:]).abs().mean().item(), BF16_OBJCLS_MEAN)
    # as in [3]: bf16 moves boxes by pixels and reorders near-tied scores at
    # the top-k and NMS cuts, so the detections are reported, the class map
    # bounded; each bf16 kernel was held on its own arguments above
    compare_runs("hub bf16 card vs fp32 card", (half.pred, half.masks), (got.pred, got.masks),
                 None, None, None, BF16_MASK_SHARE, match_px=16.0, mask_hws=hws)
    chans = {ch: hub_channels(ch, weights) for ch in HUB_CHANNELS}
    facade = hub_facade(shape32, inputs[1])
    part = got.tolist()[3]
    quiet(part.save, os.path.join(work, "saved"))
    from multiyolov5_tpu_torch.data import jpeg
    with open(os.path.join(work, "saved", "image3.jpg"), "rb") as fh:   # PIL's save of it
        if fh.read() != jpeg.encode(part.imgs[0], *JPEG_SETTINGS["pil"]):
            raise AssertionError("Detections.save did not write the rendered image")
    shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "bf16_launches": launches16, "ms_fp32": ms,
            "errs": errs, "detections": [len(p) for p in got.pred], "channels": chans,
            "facade": facade, "card": card}


def hub_channels(ch: int, weights: str) -> dict:
    """[12] ``hub.create(HUB_CH_CFG, channels=ch, pretrained=<the smoke's
    weights>, autoshape=False)`` on a bs1 uint8 frame of ``ch`` channels at
    the serving geometry, through :func:`run_family` (launches, the fp32
    network against float64, post-processing on the card's own outputs and
    end to end against the CPU's under [3]'s bounds, bf16 against fp32
    beside the CPU's own drift, every K2 site); then a counted fp32 and
    bf16 call each, K1 (on the ``ch``-channel frame), K2 and K3 held
    against their plain versions on their arguments and K1 timed there;
    ``AutoShape`` over the model raises ``ValueError`` with no launch."""
    from multiyolov5_tpu_torch import hub
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import Model
    from multiyolov5_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    name = f"{HUB_CH_CFG} channels={ch}"
    make = functools.partial(hub.create, HUB_CH_CFG, pretrained=weights, channels=ch,
                             autoshape=False)
    frame = np.random.RandomState(SEED + 43 + ch).randint(0, 256, (*IN_HW, ch)).astype(
        np.uint8)
    res, (e32, e16, _) = run_family(name, frame, timing=False, make=make)
    with torch.device("meta"):
        n_k2 = k2_sites(Model(load_spec(HUB_CH_CFG), fused=True))     # 3 channels
    if not e32.fold_stem or e32.stem_weights[0].shape[2] != 16 * ch:
        raise AssertionError(f"{name}: rows 0-1 are not K1's on {ch} channels")
    log(f"  {name}: K1 on {ch} channels (conv1 K {144 * ch}), {res['k2_sites']} K2 sites "
        f"(the 3-channel model: {n_k2})")
    res.update(errs={}, launches={}, stem={})
    for dt_name, eng, bound in (("fp32", e32, F32_REL), ("bf16", e16, BF16_REL)):
        _, launches, rec, res["errs"][dt_name] = hold_recorded(eng, frame[None],
                                                               f"{name} {dt_name}", bound)
        want_launches(f"{name} bs1 {dt_name}", launches,
                      {"stem": 1, "stem_float": 0, "conv3x3": n_k2, "nms": 1,
                       "nms_greedy": 0, "c3": 0, "upsample_argmax": 0})
        res["launches"][dt_name] = launches
        (fr, *w), kw = rec["stem"][0]
        odt = kw["out_dtype"]
        bm, by = stem_bound(fr, w, odt)
        t = res["stem"][dt_name] = {
            "frame": list(fr.shape), "max_abs_err": res["errs"][dt_name]["stem"],
            "ms": graph_ms(lambda: K.stem(fr, *w, out_dtype=odt), iters=10),
            "plain_ms": graph_ms(lambda: K.stem_plain(fr, *w, out_dtype=odt), iters=10),
            "library_ms": stem_library_ms(fr, w, odt), "bound_ms": bm, "bound_by": by}
        log(f"  stem on {name}'s {dt_name} call: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f}, cuDNN conv2d x2 {t['library_ms']:.4f}, bound "
            f"{bm:.5f} ms ({by})")
    K.reset_launches()
    try:
        hub.AutoShape(e32)(frame[:, :, :1].repeat(3, 2), size=HUB_SIZE)
    except ValueError as e:
        log(f"  AutoShape over the {ch}-channel model: ValueError({e})")
    else:
        raise AssertionError(f"AutoShape over a {ch}-channel model did not raise")
    if any(K.launch_counts().values()):
        raise AssertionError(f"AutoShape's refusal launched {K.launch_counts()}")
    res["s"] = PHASE_S[f"[12] channels={ch}"] = time.perf_counter() - t0
    log(f"  channels={ch}: {res['dets']} detections (fp32); {res['s']:.1f} s")
    return res

def hub_facade(shape32, image) -> dict:
    """[12] ``Model(CFG).to(card).eval().fuse().autoshape()`` (the facade's
    seeded init is the smoke's weights) on one image against the hub's
    ``AutoShape`` on the same weights: the same launches and the same
    outputs under [3]'s post-processing bounds."""
    from multiyolov5_tpu_torch.models.model import Model
    from multiyolov5_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    shape = Model(CFG, seed=SEED).to(DEVICE).eval().fuse().autoshape()
    shape(image, size=HUB_SIZE)                # the geometry's first call
    runs = {}
    for name, sh in (("facade", shape), ("hub", shape32)):
        K.reset_launches()
        out = sh(image, size=HUB_SIZE)
        torch.cuda.synchronize()
        runs[name] = out, K.launch_counts()
    (got, launches), (want, hub_launches) = runs["facade"], runs["hub"]
    want_launches("Model(...).fuse().autoshape() on one image", launches, {
        k: hub_launches[k] for k in ("stem", "stem_float", "conv3x3", "c3", "nms",
                                     "nms_greedy", "upsample_argmax")})
    if launches["stem"] != 1 or launches["conv3x3"] != 10:
        raise AssertionError(f"the facade's AutoShape launched {launches}")
    same = all(np.array_equal(a, b) for a, b in zip(got.pred + got.masks,
                                                    want.pred + want.masks))
    log(f"  facade vs hub outputs bitwise equal: {same}")
    compare_runs("Model(...).fuse().autoshape() vs hub AutoShape (fp32 card)",
                 (got.pred, got.masks), (want.pred, want.masks), MATCH_SHARE, BOX_PX,
                 SCORE_ABS, MASK_SHARE, mask_hws=[im.shape[:2] for im in got.imgs])
    s = PHASE_S["[12] facade"] = time.perf_counter() - t0
    log(f"  facade: {len(got.pred[0])} detections; {s:.1f} s")
    return {"launches": launches, "bitwise_equal": same, "s": s}


def profile_cli(eng16, work: str, bs: int) -> dict:
    """One ``cli.profile.main`` run at bs ``bs`` with ``--layers --trace``:
    the launches one bf16 forward from row 0 makes (the kernels' counters,
    and [12]'s spies on ``blocks.conv3x3`` and ``blocks.c3``), the CLI's own
    launches (every forward it runs), its rows, and the trace's report."""
    from multiyolov5_tpu_torch.cli.profile import TRACE_FORWARDS
    from multiyolov5_tpu_torch.cli.profile import main as profile_main
    from multiyolov5_tpu_torch.models import blocks
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.tools import trace_report
    x = torch.zeros(bs, *IN_HW, 3, dtype=torch.bfloat16, device=DEVICE).permute(0, 3, 1, 2)
    calls = {"conv3x3": [], "c3": []}
    with torch.inference_mode(), spied(blocks, "conv3x3", before=recorder(calls["conv3x3"])), \
            spied(blocks, "c3", before=recorder(calls["c3"])):
        eng16.model(x)                        # the geometry's first call (allocator, cuDNN)
        for v in calls.values():
            v.clear()
        K.reset_launches()
        eng16.model(x)
        torch.cuda.synchronize()
        per = K.launch_counts()
    if {k: len(v) for k, v in calls.items()} != {k: per[k] for k in calls}:
        raise AssertionError(f"bs{bs}: spied calls {[len(v) for v in calls.values()]}, "
                             f"launches {per}")
    want = {"conv3x3": 10, "c3": int(bs > 1)}
    if {k: per[k] for k in want} != want:
        raise AssertionError(f"bs{bs} forward launches {per}, want {want}")
    trace_dir = os.path.join(work, f"trace_bs{bs}")
    K.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = profile_main(["--cfg", CFG, "--img-size", *map(str, IN_HW), "--batch-size", str(bs),
                            "--layers", "--trace", trace_dir, "--iters", str(PROFILE_ITERS)])
    torch.cuda.synchronize()
    cli = K.launch_counts()
    # warm-up (3) + timed forwards, profile_layers' warm-up + repeats (1 + 10), the trace's
    forwards = 3 + PROFILE_ITERS + 11 + TRACE_FORWARDS
    if any(cli[k] != per[k] * forwards for k in per):
        raise AssertionError(f"bs{bs}: the CLI launched {cli}, want {forwards} x {per}")
    rows = out["layers"]
    if [r[0] for r in rows] != list(range(len(eng16.spec.rows))) or min(r[3] for r in rows) < 0:
        raise AssertionError(f"bs{bs}: profile_layers rows {rows}")
    with contextlib.redirect_stdout(io.StringIO()) as rep:
        dev_rows = trace_report.report(trace_report.load_trace(out["trace"]), top=15)
    by_class = {}
    for name, us, _ in dev_rows:
        by_class[trace_report.classify(name)] = by_class.get(trace_report.classify(name), 0) + us
    total = sum(us for _, us, _ in dev_rows)
    if abs(sum(by_class.values()) - total) > 1e-6 * total:
        raise AssertionError(f"bs{bs}: class totals {by_class} do not sum to {total}")
    traced = {sym: sum(n for name, _, n in dev_rows
                       if re.search(rf"(?<!\w){sym}(?!\w)", name))
              for sym in ("conv3x3_tma", "c3_bf16")}
    want_traced = {"conv3x3_tma": TRACE_FORWARDS * per["conv3x3"],
                   "c3_bf16": TRACE_FORWARDS * per["c3"]}
    log(f"  bs{bs}: one forward launches {({k: v for k, v in per.items() if v})}; the CLI "
        f"{forwards} forwards; traced K2 {traced['conv3x3_tma']}, K7 {traced['c3_bf16']} "
        f"(want {want_traced['conv3x3_tma']}, {want_traced['c3_bf16']}) of "
        f"{sum(n for *_, n in dev_rows)} device ops, {total / TRACE_FORWARDS / 1e3:.3f} device "
        f"ms a forward")
    if traced != want_traced:
        raise AssertionError(f"bs{bs}: traced {traced}, want {want_traced}")
    with open(os.path.join(OUT_DIR, f"profile_bs{bs}.txt"), "w") as fh:
        fh.write(buf.getvalue() + rep.getvalue())
    return {"forward_ms": out["forward_s"] * 1e3, "layers_cum_ms": rows[-1][2],
            "layers": rows, "launches_per_forward": per, "cli_launches": cli,
            "traced": traced, "device_us_per_forward": total / TRACE_FORWARDS,
            "device_classes_us": by_class, "model_info": out["info"]}


def pt_tree(work: str, eng, frames) -> str:
    """A detection split of two of the frames as PNG files, labelled by
    :func:`label_split` at the ``--img-size`` IN_HW[1] and ``--batch-size`` 2
    that [13] runs ``cli.test`` with, and its dataset file."""
    from multiyolov5_tpu_torch.data import png
    img_dir, lbl_dir = (os.path.join(work, "det", d, "val") for d in ("images", "labels"))
    os.makedirs(img_dir, exist_ok=True)
    for i, f in enumerate(frames[:2]):
        png.imwrite(os.path.join(img_dir, f"f{i}.png"), np.ascontiguousarray(f[:, :, ::-1]))
    label_split(eng, img_dir, lbl_dir, np.random.RandomState(SEED + 37), IN_HW[1], 2)
    path = os.path.join(work, "data.json")
    with open(path, "w") as fh:
        json.dump({"val": img_dir}, fh)
    return path


def phase_profile_export(eng32, eng16, frames, card: str):
    """[13] profiling, export and .pt checkpoints on pspv5s at full width:
    the FLOP counter, ``cli.profile`` at bs1 and bs8 (K2; K7 at bs8) with its
    per-row times and its trace's report, ``cli.export`` (TorchScript and
    torch.export, decoded and raw) reloaded against the live plain build and
    against ``Engine``'s fp32 kernel path, and ``.pt`` weights through
    ``Engine``, ``convert_pt``, ``cli.detect`` and ``cli.test`` (on labels
    from the model's own detections on the CLI's letterboxes, so mAP@.5 is
    neither 0 nor 1)."""
    from multiyolov5_tpu_torch.cli import export as export_cli
    from multiyolov5_tpu_torch.cli.test import main as test_main
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops.resize import resize_bilinear
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.tools.convert_pt import convert
    from multiyolov5_tpu_torch.utils.profiling import estimate_gflops
    log(f"[13] profiling, export and .pt: {CFG} seed {SEED}, {IN_HW}")
    work = os.path.join(ROOT, "build", "chip_smoke_profile")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    res = {"card": card}

    spec = load_spec(CFG)
    flops = {f"{h}x{w}": estimate_gflops(spec, None, (h, w)) * 1e9
             for h, w in (IN_HW, (1024, 1024))}
    f512 = flops[f"{IN_HW[0]}x{IN_HW[1]}"]
    log(f"  estimate_gflops: {flops} FLOPs a frame (JAX's {JAX_PSPV5S_FLOPS} + the Focus "
        f"conv's {FOCUS_FLOPS} at 512x1024)")
    check("FLOPs at 512x1024 against JAX's + the Focus conv's, relative",
          abs(f512 / (JAX_PSPV5S_FLOPS + FOCUS_FLOPS) - 1), FLOP_REL)
    res["flops"] = flops

    res["profile"] = {}
    for bs in PROFILE_BATCHES:
        pr = profile_cli(eng16, work, bs)
        x = torch.zeros(bs, *IN_HW, 3, dtype=torch.bfloat16, device=DEVICE).permute(0, 3, 1, 2)
        with torch.inference_mode():
            pr["graph_ms"] = graph_ms(lambda: eng16.model(x), iters=5, replays=3)
        for key in ("forward_ms", "graph_ms"):
            pr[key.replace("ms", "tflops")] = bs * f512 / (pr[key] * 1e-3) / 1e12
        log(f"  bs{bs} bf16 forward: profile_op {pr['forward_ms']:.3f} ms "
            f"({pr['forward_tflops']:.2f} TFLOP/s, {pr['forward_tflops'] / 989:.2%} of 989); "
            f"graph replay {pr['graph_ms']:.3f} ms ({pr['graph_tflops']:.2f} TFLOP/s, "
            f"{pr['graph_tflops'] / 989:.2%}); profile_layers' last cum "
            f"{pr['layers_cum_ms']:.3f} ms; on {card}")
        res["profile"][f"bs{bs}"] = pr

    # export: the plain build, fp32, traced on the card
    weights = smoke_weights()
    exp_dir = os.path.join(work, "export")
    made = {}
    t0 = time.perf_counter()
    for raw in (False, True):
        made[raw] = quiet(export_cli.main, ["--weights", weights, "--img-size", *map(str, IN_HW),
                                            "--include", "torchscript", "export",
                                            "--output", os.path.join(exp_dir, str(raw))]
                          + (["--raw"] if raw else []))
    made["bs2"] = quiet(export_cli.main, ["--weights", weights, "--img-size", *map(str, IN_HW),
                                          "--batch-size", "2", "--include", "torchscript",
                                          "--output", os.path.join(exp_dir, "bs2")])
    res["export_s"] = time.perf_counter() - t0
    plain = export_cli.plain_model(Engine(weights, device=DEVICE, half=False))
    xs = torch.from_numpy(np.stack(frames[:2])).to(DEVICE).float() / 255   # (2, H, W, 3)
    errs = {}
    for key, paths in made.items():
        raw, x = key is True, xs[:2] if key == "bs2" else xs[:1]
        xn = x.permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            live = export_cli.ExportModel(plain, raw=raw)(xn)
            for path in paths:
                net = (torch.jit.load(path) if path.endswith(".torchscript.pt")
                       else torch.export.load(path).module())
                got = net(xn)
                if len(got) != len(live):
                    raise AssertionError(f"{path}: {len(got)} outputs, want {len(live)}")
                err = max(diffs(g, w)[1] for g, w in zip(got, live))
                errs[os.path.relpath(path, work)] = err
                check(f"{os.path.relpath(path, work)} against the live plain build, of scale",
                      err, EXPORT_REL)
        if raw:
            continue
        # the decoded output against Engine's fp32 forward: K1's float mode, K2
        # fp32 and, at bs2, K7 fp32, against the exported cuDNN graph
        K.reset_launches()
        z, seg = eng32.forward(x)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        want = {"stem_float": 1, "conv3x3": 10, "c3": int(x.shape[0] > 1)}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"Engine fp32 bs{x.shape[0]} launches {launches}, want {want}")
        zt = z.transpose(1, 2)
        check(f"export bs{x.shape[0]} vs Engine fp32 (K1 float, K2, K7: {launches['c3']}): "
              "boxes max|diff|/max(max|ref|,1)", diffs(live[0][..., :4], zt[..., :4])[1], NET_REL)
        check(f"export bs{x.shape[0]} vs Engine fp32: obj/cls max|diff|",
              diffs(live[0][..., 4:], zt[..., 4:])[0], NET_REL)
        up = resize_bilinear(seg, (seg.shape[2] * 8, seg.shape[3] * 8))
        check(f"export bs{x.shape[0]} vs Engine fp32: seg logits max|diff|/max(max|ref|,1)",
              diffs(live[1], up)[1], NET_REL)
    res["export_errs"] = errs
    log(f"  export: {sum(len(v) for v in made.values())} artifacts in {res['export_s']:.1f} s")

    # .pt weights: reference-style {model, ema} in fp16, and a bare state_dict
    sd = seeded_state_dict(spec, SEED)          # the weights of smoke_weights
    pts = {"ref_style": os.path.join(work, "ref_style.pt"),
           "bare": os.path.join(work, "bare.pt")}
    # the EMA told apart by +0.001 on every bias: on every tensor (running
    # statistics, weights) it saturates these random weights (every score 1.0)
    torch.save({"model": {k: v.half() for k, v in sd.items()},
                "ema": {k: (v + 0.001 * k.endswith(".bias")).half() for k, v in sd.items()},
                "epoch": 3}, pts["ref_style"])
    torch.save(sd, pts["bare"])
    res["pt"] = {}
    for name, pt in pts.items():
        npz = quiet(convert, pt, pt[:-3] + ".npz")
        runs = []
        for w in (pt, npz):
            eng = Engine(w, cfg=CFG, device=DEVICE, half=True)
            eng(frames[0], ORIG_HW, conf=CONF)
            K.reset_launches()
            runs.append(eng(frames[0], ORIG_HW, conf=CONF))
            torch.cuda.synchronize()
            launches = K.launch_counts()
            want = {"stem": 1, "conv3x3": 10, "nms": 1, "upsample_argmax": 1}
            if {k: launches[k] for k in want} != want:
                raise AssertionError(f"Engine({os.path.basename(w)}) launches {launches}")
        same = all(np.array_equal(a, b) for a, b in zip(runs[0][0] + runs[0][1],
                                                         runs[1][0] + runs[1][1]))
        log(f"  Engine({name}.pt) vs Engine(convert_pt): {len(runs[0][0][0])} detections, "
            f"bitwise {'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{name}: .pt and its .npz differ")
        res["pt"][name] = {"detections": len(runs[0][0][0]), "launches": launches}
    pt = pts["ref_style"]
    src = os.path.join(work, "src")
    os.makedirs(src)
    from multiyolov5_tpu_torch.data import png
    png.imwrite(os.path.join(src, "f0.png"), np.ascontiguousarray(frames[0][:, :, ::-1]))
    K.reset_launches()
    out, _ = run_app(["--weights", pt, "--cfg", CFG, "--source", src, "--img-size",
                      str(APP_IMG), "--save-txt", "--save-conf", "--project",
                      os.path.join(work, "runs"), "--name", "pt"])
    app_launches = K.launch_counts()
    arts = ["f0.png", "f0_mask.png", "f0_dst.png", "labels/f0.txt"]
    if not all(os.path.exists(os.path.join(out, a)) for a in arts):
        raise AssertionError(f"cli.detect on .pt: missing artifacts in {os.listdir(out)}")
    data = pt_tree(work, Engine(pt, cfg=CFG, device=DEVICE, half=False), frames)
    metrics = []
    for w in (pt, pt[:-3] + ".npz"):
        K.reset_launches()
        metrics.append(quiet(test_main, ["--weights", w, "--cfg", CFG, "--data", data,
                                         "--img-size", str(IN_HW[1]), "--batch-size", "2"]))
        metrics[-1] = {k: float(v) for k, v in metrics[-1].items()}
        torch.cuda.synchronize()
        test_launches = K.launch_counts()
    log(f"  cli.detect on .pt: launches {app_launches}; cli.test on .pt and on its .npz: "
        f"{metrics[0]} / {metrics[1]}, launches {test_launches}")
    if (metrics[0] != metrics[1] or not 0.05 < metrics[0]["mAP50"] < 0.95
            or test_launches["nms_greedy"] < 1):
        raise AssertionError(f"cli.test on .pt {metrics[0]} vs .npz {metrics[1]}, "
                             f"launches {test_launches}")
    res.update(app_launches=app_launches, test_launches=test_launches, test_metrics=metrics[0])
    shutil.rmtree(work, ignore_errors=True)
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
    mac1, mac2 = px * 9 * w[0].shape[2] * c_mid, px * 4 * c_mid * c_out
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
    """A CPU engine's network in float64 on uint8 frames, folded stem
    included (or from row 0 on x / 255): the reference of [9]'s and [16]'s
    float32 checks."""
    import copy

    import torch.nn.functional as F

    from multiyolov5_tpu_torch.ops.kernels.stem import space_to_depth4
    model = copy.deepcopy(eng.model).double()
    with torch.inference_mode():
        if not eng.fold_stem:
            z, seg = model(x.double().permute(0, 3, 1, 2) / 255)
            return z, None if seg is None else seg.float()
        w1, b1, w2, b2 = (t.double() for t in eng.stem_weights)
        y = F.silu(F.conv2d(space_to_depth4(x).double(), w1.permute(3, 2, 0, 1), b1, padding=1))
        y = F.silu(F.conv2d(F.pad(y, (1, 0, 1, 0)), w2.permute(3, 2, 0, 1), b2))
        z, seg = model(y, start_layer=2)
    return z, None if seg is None else seg.float()


def hold_network(name, card, cpu_out, cpu, x):
    """The card's fp32 network outputs (decoded candidates, seg logits or
    None) against float64 (:func:`forward64` of the CPU engine ``cpu`` on
    ``x``), each held to max(NET_REL, F64_FACTOR x the CPU's own float32
    error ``cpu_out``). Returns each output's three errors."""
    z64, seg64 = forward64(cpu, x.cpu())
    net = {}
    for what, i, sl, rel in (("boxes", 0, slice(0, 4), True),
                             ("obj/cls", 0, slice(4, None), False),
                             ("seg logits", 1, slice(None), True)):
        if card[i] is None:
            continue
        a_c, a_p, a_r = (t[i][:, sl].cpu() for t in (card, cpu_out, (z64, seg64)))
        k = 1 if rel else 0
        e_card, e_cpu, e_cc = diffs(a_c, a_r)[k], diffs(a_p, a_r)[k], diffs(a_c, a_p)[k]
        net[what] = {"card_vs_f64": e_card, "cpu_vs_f64": e_cpu, "card_vs_cpu": e_cc}
        unit = "max|diff|/max(max|ref|,1)" if rel else "max|diff|"
        log(f"  {name} network fp32 {what} {unit}: card vs CPU {e_cc:.3e}; against float64, "
            f"card {e_card:.3e}, CPU {e_cpu:.3e}")
        check(f"{name} network fp32 card vs float64: {what} {unit}", e_card,
              max(NET_REL, F64_FACTOR * e_cpu))
    return net


def run_family(cfg, frame, half: bool = True, timing: bool = True, make=None):
    """One configuration (a zoo or hub name) at bs1 on seeded weights, or
    the engines ``make(device, half)`` builds (``cfg`` then names them):
    launches; the card's fp32 network against float64 and its
    post-processing against the CPU's; with ``half``, bf16 against fp32
    beside the CPU's own bf16 drift; every K2 site against its plain
    version; with ``timing``, ms/frame.  ``frame`` (H, W, ch_in) uint8."""
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.ops import kernels as K
    if make is None:
        spec = load_spec(cfg)
        sd = seeded_state_dict(spec, SEED, DEVICE)     # the statistics pass on the card
        make = functools.partial(Engine, spec=spec, state_dict=sd)
    e32 = make(device=DEVICE, half=False)
    e16 = make(device=DEVICE, half=True) if half else None
    cpu = make(device="cpu", half=False)
    spec = e32.spec
    n_k2 = k2_sites(e32.model)
    seg = spec.seg_index is not None
    stem = (f"stem c_mid {e32.stem_weights[0].shape[-1]}" if e32.fold_stem
            else "no folded stem (rows from 0)")
    log(f"  {cfg}: {len(spec.rows)} rows, seg head "
        f"{spec.rows[spec.seg_index].module if seg else 'none'}, strides {spec.strides}, "
        f"{stem}, {n_k2} K2 sites")
    x = torch.from_numpy(frame[None]).to(DEVICE)
    K.reset_launches()
    z_card, seg_card = e32.forward(x)
    card = e32.postprocess(z_card, seg_card, IN_HW, ORIG_HW, conf=CONF)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    want = {"stem": int(e32.fold_stem), "stem_float": 0, "conv3x3": n_k2, "nms": 1,
            "nms_greedy": 0, "upsample_argmax": int(seg), "c3": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{cfg} bs1 launches {launches}, want {want}")
    t0 = time.perf_counter()
    z_cpu, seg_cpu = cpu.forward(x.cpu())
    t_cpu = time.perf_counter() - t0
    ref = cpu.postprocess(z_cpu, seg_cpu, IN_HW, ORIG_HW, conf=CONF)
    if not seg and (seg_card is not None or seg_cpu is not None or card[1] != [None]):
        raise AssertionError(f"{cfg}: a detection-only model gave a seg output")
    net = hold_network(cfg, (z_card, seg_card), (z_cpu, seg_cpu), cpu, x)
    z_card = z_card.cpu()
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
    res = {"launches_per_frame": launches, "k2_sites": n_k2, "cpu_forward_s": t_cpu,
           "dets": len(card[0][0]), "network_fp32": net}
    if half:
        res["bf16_vs_fp32"] = bf16_drift(cfg, spec, make, e16, e32, x, z_cpu, seg_cpu)
    # every K2 site of the path, on the engines' own weights and shapes
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    res["k2_rel_err"] = {}
    for eng, dt, bound in ((e32, torch.float32, F32_REL), (e16, torch.bfloat16, BF16_REL)):
        if eng is None:
            continue
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
        res["k2_rel_err"][str(dt)[6:]] = worst_rel
    for name, eng in (("fp32", e32), ("bf16", e16)) if timing else ():
        if eng is None:
            continue
        reps = frame_ms(eng, frame)
        res[f"{name}_ms"] = reps
        log(f"  {cfg} Engine.__call__ bs1 {name}: median {float(np.median(reps)):.3f} "
            f"ms/frame over {FAMILY_REPS} reps of {FAMILY_ITERS}, range "
            f"{min(reps):.3f}-{max(reps):.3f}")
    return res, (e32, e16, cpu)


def bf16_drift(cfg, spec, make, e16, e32, x, z_cpu, seg_cpu):
    """The card's bf16 network against its fp32 one on ``x``, held to
    BF16_FACTOR x the CPU's own bf16 drift (never tighter than [3]'s bounds);
    ``make(device, half)`` builds the CPU's bf16 engine."""
    seg = spec.seg_index is not None
    z16, seg16 = e16.forward(x)
    z32, seg32 = e32.forward(x)
    # bf16's own drift on this network: the CPU's bf16 engine against its fp32
    t0 = time.perf_counter()
    cpu16 = make(device="cpu", half=True)
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
    return bf16


def deferring_checks(label: str, fn, *args):
    """``fn(*args)`` with each failed bound reported where it happens and
    raised at the end, so one run shows every one."""
    failures = []
    real = check

    def deferred(name, value, bound, ok=None):
        try:
            real(name, value, bound, ok)
        except AssertionError as e:
            failures.append(str(e))

    with replaced(sys.modules[__name__], "check", deferred):
        res = fn(*args)
    if failures:
        raise AssertionError(f"{label}: {len(failures)} bound(s) failed: {failures}")
    return res


def phase_families(eng32, frames):
    """[9] the other model families: K1's float mode, each configuration of
    FAMILY_CFGS at bs1, BiSe's seg_validation on float batches, an
    InferenceServer on a detection-only model, and pspv5l at bs2 off K7.
    Failed bounds are raised at the end of the phase."""
    return deferring_checks("[9]", _phase_families, eng32, frames)


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
    l32 = Engine(spec=spec_l, state_dict=seeded_state_dict(spec_l, SEED, DEVICE), device=DEVICE,
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


def train_batch(rng, bs: int, nc: int, nseg: int, det_hw=None, seg_hw=None):
    """bench.py:74-84's batch: uint8 det images with 20 targets each, padded
    to TRAIN_MAX_T; float seg images in [0, 1]; int64 labels in [-1, nseg);
    at TRAIN_DET_HW / TRAIN_SEG_HW unless given."""
    from multiyolov5_tpu_torch.train.losses import pad_targets
    det_hw, seg_hw = det_hw or TRAIN_DET_HW, seg_hw or TRAIN_SEG_HW
    imgs = (rng.rand(bs, *det_hw, 3) * 255).astype(np.uint8)
    labels = []
    for _ in range(bs):
        lab = np.zeros((TRAIN_TARGETS, 5), np.float32)
        lab[:, 0] = rng.randint(0, nc, TRAIN_TARGETS)
        lab[:, 1:3] = rng.rand(TRAIN_TARGETS, 2) * 0.6 + 0.2
        lab[:, 3:5] = rng.rand(TRAIN_TARGETS, 2) * 0.2 + 0.05
        labels.append(lab)
    tgts, mask = pad_targets(labels, TRAIN_MAX_T)
    seg_imgs = rng.rand(bs, *seg_hw, 3).astype(np.float32)
    seg_lbls = rng.randint(-1, nseg, (bs, *seg_hw))
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


def train_step64(spec, sd, host, args, bs: int):
    """The train step on ``host`` on the CPU in float64 (parameters,
    buffers, gradients, momentum, EMA and the images): the reference of a
    float32 step, as forward64 is of a float32 forward."""
    from multiyolov5_tpu_torch.train import trainer as T
    ts, step = train_state(spec, sd, torch.float32, "cpu", bs)
    ts.model.double()
    for p in ts.model.parameters():
        p.grad = torch.zeros_like(p)
    ts.opt["momentum"] = {k: v.double() for k, v in ts.opt["momentum"].items()}
    ts.ema = {k: v.double() if v.is_floating_point() else v for k, v in ts.ema.items()}
    images32 = T._images
    with replaced(T, "_images", lambda a, dev: images32(a, dev).double()):
        return step(ts, *host, *args)


def within_f64(got, cpu, ref64, init) -> bool:
    """A float32 tensor ``got`` against its float64 reference ``ref64``:
    within TRAIN_UPDATE_REL of the reference's change from ``init`` + 2
    float32 ulps of its values, or within F64_FACTOR x the CPU's own
    float32 error ``cpu`` against the reference."""
    eps = float(np.finfo(np.float32).eps)
    ref64, init = ref64.double().cpu(), init.double().cpu()
    err = (got.double().cpu() - ref64).abs().max().item()
    own = (cpu.double().cpu() - ref64).abs().max().item()
    span, top = (ref64 - init).abs().max().item(), ref64.abs().max().item()
    return err <= max(TRAIN_UPDATE_REL * span + 2 * eps * top, F64_FACTOR * own)


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
        with spied(T, "seg_ce", before=lambda z, y, w=None, group=None, store=rec[name]:
                   store.append((z.detach().clone(), y.clone(), w))):
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


def tc_tree(work: str, rng, nc: int) -> str:
    """[14]'s seeded PNG trees under ``work`` and their dataset file (JSON):
    ``det/images/{train,val}`` + ``det/labels`` (TC_BOXES boxes of the
    cfg's classes a frame), ``citys/leftImg8bit/{train,val}/aachen`` +
    ``gtFine`` labelId masks (255 in places).  Frames are 32x32-px blocks
    of seeded colours plus noise, so they compress and decode quickly."""
    h, w = TC_ORIG_HW

    def frame():
        base = np.repeat(np.repeat(rng.randint(0, 256, (h // 32, w // 32, 3)), 32, 0), 32, 1)
        return np.clip(base + rng.randint(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)

    from multiyolov5_tpu_torch.data import png
    for split, n in (("train", TC_DET), ("val", TC_VAL)):
        idir, ldir = (os.path.join(work, "det", k, split) for k in ("images", "labels"))
        os.makedirs(idir)
        os.makedirs(ldir)
        for i in range(n):
            png.imwrite(os.path.join(idir, f"f{i:03d}.png"), frame())
            wh = rng.rand(TC_BOXES, 2) * 0.2 + 0.03
            xy = wh / 2 + rng.rand(TC_BOXES, 2) * (1 - wh)
            rows = np.concatenate([rng.randint(0, nc, (TC_BOXES, 1)), xy, wh], 1)
            with open(os.path.join(ldir, f"f{i:03d}.txt"), "w") as fh:
                fh.write("".join("%d %.6f %.6f %.6f %.6f\n" % tuple(r) for r in rows))
    for split, n in (("train", TC_SEG), ("val", TC_SEG_VAL)):
        idir = os.path.join(work, "citys", "leftImg8bit", split, "aachen")
        mdir = os.path.join(work, "citys", "gtFine", split, "aachen")
        os.makedirs(idir)
        os.makedirs(mdir)
        for i in range(n):
            png.imwrite(os.path.join(idir, f"aachen_{i:06d}_leftImg8bit.png"), frame())
            ids = np.repeat(np.repeat(rng.randint(0, 34, (h // 16, w // 16)), 16, 0), 16, 1)
            ids[rng.rand(h, w) < 0.05] = 255
            png.imwrite(os.path.join(mdir, f"aachen_{i:06d}_gtFine_labelIds.png"),
                        ids.astype(np.uint8))
    short = os.path.join(work, "det", "train_short.txt")
    with open(short, "w") as fh:
        fh.write("".join(os.path.join(work, "det", "images", "train", f"f{i:03d}.png\n")
                         for i in range(TC_SHORT)))
    for name, train in (("data.json", os.path.join(work, "det", "images", "train")),
                        ("data_short.json", short)):
        with open(os.path.join(work, name), "w") as fh:
            json.dump({"train": train, "val": os.path.join(work, "det", "images", "val"),
                       "segtrain": os.path.join(work, "citys"),
                       "segval": os.path.join(work, "citys"), "nc": nc,
                       "names": [f"class{i}" for i in range(nc)]}, fh)
    return os.path.join(work, "data.json")


def short_data(data: str) -> str:
    """tc_tree's dataset file that trains on the first TC_SHORT frames."""
    return os.path.join(os.path.dirname(data), "data_short.json")


class TcSteps:
    """Wraps cli.train's make_train_step: each step's K6 launches and host
    ms (synchronised), the first step's K6 arguments, and a
    KeyboardInterrupt at call ``stop_at`` (counting from 1) if given."""

    def __init__(self, cli, stop_at=None):
        self.real, self.stop_at = cli.make_train_step, stop_at
        self.k6, self.ms, self.first = [], [], None

    def __call__(self, *a, **kw):
        from multiyolov5_tpu_torch.ops import kernels as K
        from multiyolov5_tpu_torch.train import trainer as T
        step = self.real(*a, **kw)

        def wrapped(*args, **kwargs):
            if len(self.ms) + 1 == self.stop_at:
                raise KeyboardInterrupt
            before = K.launch_counts()
            t0 = time.perf_counter()
            if self.first is None:
                rec = []
                with spied(T, "seg_ce", before=lambda z, y, w=None, group=None: rec.append(
                        (z.detach().clone(), y.clone(), w))):
                    out = step(*args, **kwargs)
                self.first = rec[0] if rec else None
            else:
                out = step(*args, **kwargs)
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            after = K.launch_counts()
            self.k6.append((after["seg_ce"] - before["seg_ce"],
                            after["seg_ce_bwd"] - before["seg_ce_bwd"]))
            return out
        return wrapped


def tc_run(argv, steps, evals=None):
    """``cli.train.main(argv)`` under ``steps`` (a TcSteps), its printed
    lines kept out of stdout; with ``evals`` (a dict), each epoch's eval
    launch counts under "launches" and its kernels' arguments (as
    ``run_eval`` records them) under their names; the epochs' walls
    (the loader's iteration to the epoch's checkpoint) under "walls"."""
    from multiyolov5_tpu_torch import engine as engine_mod
    from multiyolov5_tpu_torch import evaluation as E
    from multiyolov5_tpu_torch.cli import train as cli
    from multiyolov5_tpu_torch.data.detection import DetectionLoader
    from multiyolov5_tpu_torch.models import blocks
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops import nms as nms_mod
    spies = [replaced(cli, "make_train_step", steps)]
    if evals is not None:
        for k in ("stem", "conv3x3", "c3", "nms_greedy", "upsample_argmax", "launches",
                  "walls"):
            evals.setdefault(k, [])
        epoch_eval, starts = {}, []

        def counted(fn):
            def wrapper(*a, **kw):
                before = K.launch_counts()
                out = fn(*a, **kw)
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                after = K.launch_counts()
                for k in after:
                    epoch_eval[k] = epoch_eval.get(k, 0) + after[k] - before[k]
                return out
            return wrapper

        def save(real):
            def wrapper(path, tree):
                real(path, tree)
                if path.endswith("last.npz") and "opt" in tree:     # not strip_optimizer's
                    evals["launches"].append(dict(epoch_eval))
                    epoch_eval.clear()
                    evals["walls"].append(time.perf_counter() - starts[-1])
            return wrapper

        real_iter = DetectionLoader.__iter__

        def timed_iter(self):
            if self.ds.augment:
                starts.append(time.perf_counter())
            return real_iter(self)

        spies += [replaced(cli, "seg_validation", counted(cli.seg_validation)),
                  replaced(cli, "evaluate_detection", counted(cli.evaluate_detection)),
                  replaced(cli.ckpt_lib, "save_npz", save(cli.ckpt_lib.save_npz)),
                  replaced(DetectionLoader, "__iter__", timed_iter),
                  spied(engine_mod, "stem", before=recorder(evals["stem"])),
                  spied(blocks, "conv3x3", before=recorder(evals["conv3x3"])),
                  spied(blocks, "c3", before=recorder(evals["c3"])),
                  spied(nms_mod, "nms_greedy", before=recorder(evals["nms_greedy"])),
                  spied(E, "upsample_argmax", before=recorder(evals["upsample_argmax"]))]
    with contextlib.ExitStack() as stack:
        for sp in spies:
            stack.enter_context(sp)
        return quiet(cli.main, argv)


def tc_results(run: str, n: int):
    """results.txt's rows: n of the JAX CLI's 12 columns (the epoch and 11
    numbers), all finite."""
    with open(os.path.join(run, "results.txt")) as fh:
        rows = [r.split() for r in fh.read().strip().splitlines()]
    vals = np.array(rows, float)
    if vals.shape != (n, 12) or not np.isfinite(vals).all():
        raise AssertionError(f"{run}/results.txt: {vals.shape} values, finite "
                             f"{np.isfinite(vals).all()}; want {n} rows of 12 finite numbers")
    return vals


def tc_batches(data: dict, workers: int):
    """The first detection and seg training batches that cli/train.py's
    loaders give with ``workers`` threads (run A's settings)."""
    from multiyolov5_tpu_torch.data.detection import DetectionDataset, DetectionLoader
    from multiyolov5_tpu_torch.data.hyps import load_hyp
    from multiyolov5_tpu_torch.data.segmentation import get_citys_loader
    img = TC_IMG[0]
    ds = quiet(DetectionDataset, data["train"], img_size=img, batch_size=TC_BS, augment=True,
               hyp=load_hyp("scratch"), stride=32)
    det = next(iter(DetectionLoader(ds, TC_BS, shuffle=True, workers=workers, seed=SEED)))
    seg = next(iter(get_citys_loader(root=data["segtrain"], split="train", mode="train",
                                     batch_size=TC_BS, workers=workers, base_size=TC_IMG[1],
                                     crop_size=(img, img // 2), seed=SEED)))
    return det, seg, ds


def tc_peak(spec, sd, remat: bool, batch) -> int:
    """Peak device bytes of one bf16 train step of ``spec`` (weights ``sd``;
    BiSe aux, OHEM, quad) on ``batch``, with or without remat."""
    from multiyolov5_tpu_torch.data.hyps import load_hyp
    from multiyolov5_tpu_torch.train import trainer as T
    cfg = T.TrainConfig(hyp=load_hyp("scratch"), batch_size=batch[0].shape[0], seg_aux=True,
                        seg_loss="ohem", quad=True, remat=remat)
    ts, groups = T.create_train_state(spec, cfg, state_dict=sd, device=DEVICE)
    step = T.make_train_step(spec, cfg, groups)
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    step(ts, *batch, *TRAIN_STEP_ARGS, True, rng=gen)       # warm: workspaces, kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(ts, *batch, *TRAIN_STEP_ARGS, True, rng=gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del ts, step
    return peak


# [14] run A's W&B: a recording stand-in for the wandb module, installed in
# sys.modules (the card's machine has no wandb), and the libraries the port
# must not load while the run goes (their entries in sys.modules are set to
# None for the run, so that importing any of them would raise)
NOT_LOADED = ("matplotlib", "seaborn", "cv2", "PIL", "wandb")


class RecArtifact:
    def __init__(self, name=None, type=None, metadata=None):
        self.name, self.type, self.metadata = name, type, dict(metadata or {})
        self.files, self.objects = [], {}

    def add_file(self, path, name=None):
        self.files.append((str(path), name))

    def add(self, obj, name):
        self.objects[name] = obj

    def wait(self):
        return self

    def get(self, name):
        return self.objects.get(name)

    def download(self):
        return None


class RecTable:
    def __init__(self, columns=None):
        self.columns, self.data = list(columns or []), []

    def add_data(self, *row):
        self.data.append(list(row))


class RecRun:
    def __init__(self, **kw):
        self.id, self.kw = kw.get("id") or "smoke", kw
        self.config = {}
        self.artifacts, self.used, self.finished = [], [], False

    def log_artifact(self, art, aliases=None):
        self.artifacts.append((art, list(aliases or [])))

    def use_artifact(self, art):
        self.used.append(art)
        return art

    def finish(self):
        self.finished = True


class RecordingWandb:
    """What the port's WandbLogger calls of wandb, recorded."""
    Artifact, Table = RecArtifact, RecTable

    def __init__(self):
        self.run, self.logged = None, []

    def init(self, **kw):
        self.run = RecRun(**kw)
        return self.run

    def log(self, d, step=None):
        self.logged.append(dict(d))

    @staticmethod
    def Image(src, classes=None, boxes=None):
        return ("image", src, boxes)

    @staticmethod
    def Classes(items):
        return [i["id"] for i in items]

    @staticmethod
    def JoinedTable(a, b, key):
        return ("joined", a, b, key)


@contextlib.contextmanager
def without_libraries(stand_in):
    """For the duration: every module of NOT_LOADED (and its submodules)
    unloadable, but ``stand_in`` as wandb; yields a list that holds, after,
    the modules of NOT_LOADED loaded in the meantime."""
    saved = {k: v for k, v in sys.modules.items() if k.split(".")[0] in NOT_LOADED}
    for k in saved:
        sys.modules[k] = None
    for k in NOT_LOADED:
        sys.modules[k] = None
    sys.modules["wandb"] = stand_in
    loaded = []
    try:
        yield loaded
    finally:
        loaded += sorted(k for k, v in sys.modules.items() if k.split(".")[0] in NOT_LOADED
                         and v is not None and v is not stand_in)
        for k in [k for k in sys.modules if k.split(".")[0] in NOT_LOADED]:
            del sys.modules[k]
        sys.modules.update(saved)


@contextlib.contextmanager
def timed_calls(pairs, store: dict):
    """Each (owner, name) of ``pairs`` wrapped for the duration: its host ms
    a call appended to ``store[name]``."""
    def timing(name, real):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                store.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return wrapper
    with contextlib.ExitStack() as stack:
        for owner, name in pairs:
            stack.enter_context(replaced(owner, name, timing(name, getattr(owner, name))))
        yield store


CHARTS = ("plot_images", "plot_labels", "plot_results", "plot_evolution", "plot_pr_curve",
          "plot_mc_curve", "plot_confusion_matrix")


def chart_pairs(*owners):
    """(owner, name) of every chart function that ``owners`` hold."""
    return [(o, n) for o in owners for n in CHARTS if hasattr(o, n)]


def read_plot(path: str, hw) -> None:
    """``path`` decodes through the port's readers at ``hw`` (H, W)."""
    from multiyolov5_tpu_torch.data import images
    got = images.imread(path).shape
    if got != (*hw, 3):
        raise AssertionError(f"{path}: {got}, want {(*hw, 3)}")


def hold_wandb(fw, panels_want, nb_epochs: int, n_val: int) -> dict:
    """[14] run A's W&B record against the run: two model artifacts (latest,
    epoch N, best where fitness rose), two joined result tables, the
    dataset artifacts, and per epoch one panel a val image whose boxes are
    the rows evaluate_detection counted with conf >= 0.25."""
    run = fw.run
    models = [(a, al) for a, al in run.artifacts if a.type == "model"]
    evals = [(a, al) for a, al in run.artifacts if a.type == "evaluation"]
    best = 0.0
    for e, (art, aliases) in enumerate(models):
        fit = art.metadata["fitness_score"]
        want = ["latest", f"epoch {e}"] + (["best"] if fit > best else [])
        best = max(best, fit)
        if aliases != want or art.files != [(art.metadata["original_url"], "last.npz")] \
                or art.metadata["epochs_trained"] != e + 1:
            raise AssertionError(f"model artifact {e}: aliases {aliases} (want {want}), "
                                 f"files {art.files}, metadata {art.metadata}")
    if len(models) != nb_epochs or len(evals) != nb_epochs or any(
            a.objects["result"][0] != "joined" for a, _ in evals):
        raise AssertionError(f"{len(models)} model artifacts and {len(evals)} joined tables, "
                             f"want {nb_epochs} each")
    used = [a.name for a in run.used if isinstance(a, RecArtifact)]
    if sorted(used) != ["train", "val"] or len(fw.logged) != nb_epochs or not run.finished:
        raise AssertionError(f"dataset artifacts used {used}, {len(fw.logged)} scalar logs, "
                             f"finished {run.finished}")
    panels = [row for a, _ in evals for row in a.objects["result"][2].data]
    if len(panels) != nb_epochs * n_val or len(panels) != len(panels_want):
        raise AssertionError(f"{len(panels)} panels, want {nb_epochs} x {n_val} (counted "
                             f"{len(panels_want)})")
    n_boxes = 0
    for (epoch, rid, (_, _, boxes), avg), want in zip(panels, panels_want):
        got = [[*(b["position"][k] for k in ("minX", "minY", "maxX", "maxY")),
                b["scores"]["class_score"], b["class_id"]]
               for b in boxes["predictions"]["box_data"]]
        want = [r for r in want.tolist() if r[4] >= 0.25]
        if got != [[*r[:5], int(r[5])] for r in want]:
            raise AssertionError(f"epoch {epoch} panel {rid}: {len(got)} boxes, not the "
                                 f"{len(want)} evaluate_detection counted with conf >= 0.25")
        n_boxes += len(got)
    return {"model_artifacts": [al for _, al in models], "joined_tables": len(evals),
            "panels": len(panels), "panel_boxes": n_boxes}


def phase_train_cli(card: str):
    """[14] the training CLI at full width on the card: runs A (two epochs,
    K6 each step, the eval kernels each epoch held against their plain
    versions on the CLI's arguments, results.txt, JSON hyp/opt, stripped
    checkpoints that serve), the loaders' batches across worker counts, B
    (interrupted, named by tools/resume.py, resumed from the exact saved
    state) and C (BiSe, quad, multi-scale, remat, OHEM: no K6); item host
    ms, step ms, epoch walls, peak memory with and without remat."""
    from multiyolov5_tpu_torch.cli import train as cli
    from multiyolov5_tpu_torch.data.detection import generators
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.tools import resume as resume_tool
    from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params, load_npz
    log(f"[14] the training CLI: cli.train.main, {CFG} full width, bf16, hyp scratch (mosaic), "
        f"autoanchor, --img-size {TC_IMG[0]} {TC_IMG[1]} --batch-size {TC_BS} --workers "
        f"{TC_WORKERS} --seed {SEED}, on {TC_DET} + {TC_VAL} detection and {TC_SEG} + "
        f"{TC_SEG_VAL} Cityscapes seeded {TC_ORIG_HW} PNG frames")
    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    nc = load_spec(CFG).nc
    data_path = tc_tree(work, np.random.RandomState(SEED + 41), nc)
    with open(data_path) as fh:
        data = json.load(fh)
    parts = {"trees": time.perf_counter() - t0}
    log(f"  trees written in {parts['trees']:.1f} s")
    base = ["--data", data_path, "--cfg", CFG, "--img-size", str(TC_IMG[0]), str(TC_IMG[1]),
            "--batch-size", str(TC_BS), "--seg-eval-interval", "1", "--workers",
            str(TC_WORKERS), "--seed", str(SEED), "--no-tb",
            "--device", "" if DEVICE == "cuda" else DEVICE]
    nb = TC_DET // TC_BS
    # B, C and [15] (d) pass --no-wandb: the card's machine may have a real
    # wandb, whose init reaches for the network; run A has the stand-in
    short = ["--data", short_data(data_path)] + base[2:] + ["--no-wandb"]
    res = {"card": card}

    # run A: two epochs, every step's K6 and every epoch's eval kernels; the
    # W&B options under the recording stand-in, with the plots, and none of
    # matplotlib, seaborn, cv2, PIL or a real wandb loadable
    from multiyolov5_tpu_torch import evaluation as E
    from multiyolov5_tpu_torch.utils import loggers, plots
    K.reset_launches()
    steps, evals = TcSteps(cli), {}
    fw, counted, plot_ms, wandb_ms = RecordingWandb(), [], {}, {}
    wb_calls = [(loggers.WandbLogger, n) for n in ("__init__", "log", "end_epoch", "log_model",
                                                   "log_training_progress", "finish")]
    t0 = time.perf_counter()
    with without_libraries(fw) as loaded, timed_calls(chart_pairs(cli, plots), plot_ms), \
            timed_calls(wb_calls, wandb_ms), spied(E, "_match_predictions", before=lambda d, *a:
                                                   counted.append(np.array(d, copy=True))):
        run_a, _ = tc_run(base + ["--epochs", "2", "--project", work, "--name", "a",
                                  "--upload-dataset", "--bbox-interval", "1", "--save-period",
                                  "1"], steps, evals)
    wall_a = parts["run_a"] = time.perf_counter() - t0
    if loaded:
        raise AssertionError(f"run A loaded {loaded}")
    tile = math.ceil(TC_BS ** 0.5) * min(TC_IMG[0], 640)   # 3 x 3 tiles of 832 shrunk to 640
    mosaic_hw = (tile, tile)
    for f, hw in (("labels.jpg", (1600, 1600)), ("results.png", (1200, 2400)),
                  *((f"train_batch{i}.jpg", mosaic_hw) for i in range(3))):
        read_plot(os.path.join(run_a, f), hw)
    wb = hold_wandb(fw, counted, 2, TC_VAL)
    log(f"  run A's W&B (the recording stand-in): model artifacts {wb['model_artifacts']}, "
        f"{wb['joined_tables']} joined tables, {wb['panels']} panels of {wb['panel_boxes']} "
        f"boxes, each the rows evaluate_detection counted with conf >= 0.25; labels.jpg, "
        f"train_batch0-2.jpg and results.png decode at their sizes; none of {NOT_LOADED} "
        f"loaded (wandb: the stand-in)")
    launches = K.launch_counts()
    log(f"  run A: {len(steps.ms)} steps in {wall_a:.1f} s; launches {launches}; per step "
        f"K6 (fwd, bwd) {steps.k6}; per epoch's eval {evals['launches']}")
    check("run A steps with K6 forward and backward not launched once each",
          sum(k != (1, 1) for k in steps.k6) + abs(len(steps.k6) - 2 * nb), 0)
    for e, counts in enumerate(evals["launches"]):
        for k in ("stem", "stem_float", "conv3x3", "c3", "nms_greedy", "upsample_argmax"):
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"run A epoch {e}'s eval did not launch {k}: {counts}")
    if len(evals["launches"]) != 2:
        raise AssertionError(f"run A: {len(evals['launches'])} epoch evals, want 2")
    z, y, w = steps.first
    upstream = TC_BS * cli.TrainConfig(hyp={}).seggain
    dl, dabs, drel = k6_against_plain(z, y, w, upstream)
    log(f"  seg_ce on the CLI's first step: {tuple(z.shape)} {str(z.dtype)[6:]} logits, "
        f"{tuple(y.shape)} labels: loss |diff| {dl:.3e} relative, dz max|diff| {dabs:.3e}")
    check("seg_ce (train CLI) loss |diff|/|plain|", dl, SEG_CE_LOSS_REL)
    check("seg_ce (train CLI) dz max|diff|/max|plain dz|", drel, SEG_CE_DZ_REL[z.dtype])
    errs = hold_path_kernels(evals, "the train CLI's evals")
    errs["seg_ce"] = dabs
    rows = tc_results(run_a, 2)
    for f in ("hyp.yaml", "opt.yaml"):
        with open(os.path.join(run_a, f)) as fh:
            json.load(fh)
    frame = (np.random.RandomState(SEED + 43).rand(*IN_HW, 3) * 255).astype(np.uint8)
    served = {}
    for f in ("last.npz", "best.npz"):
        path = os.path.join(run_a, "weights", f)
        tree = load_npz(path)
        if tree.get("opt") is not None or tree.get("ema_params") is not None:
            raise AssertionError(f"run A's {f} is not stripped")
        dets, masks = Engine(path, device=DEVICE, half=True)(frame, ORIG_HW, conf=CONF)
        if not (np.isfinite(dets[0]).all() and masks[0].shape == ORIG_HW):
            raise AssertionError(f"run A's {f} does not serve")
        served[f] = len(dets[0])
    log(f"  results.txt {rows.shape} (the JAX CLI's columns): epochs {rows[:, 0].tolist()}, "
        f"det loss {rows[:, 4].tolist()}, seg {rows[:, 5].tolist()}, mAP@.5 "
        f"{rows[:, 8].tolist()}, mIoU {rows[:, 10].tolist()}; last/best.npz stripped, "
        f"served ({served} detections)")
    # the charts' host ms (evolve.png on a seeded 10-generation evolve.txt)
    ev_txt = os.path.join(work, "evolve.txt")
    keys = [k for k in cli.EVOLVE_META if k in cli.load_hyp("scratch")]
    np.savetxt(ev_txt, np.random.RandomState(SEED + 47).rand(10, 5 + len(keys)))
    with timed_calls(chart_pairs(plots), plot_ms):
        quiet(plots.plot_evolution, ev_txt, keys)
    read_plot(os.path.join(work, "evolve.png"), (2400, 2400))
    epoch_wb = sum(sum(wandb_ms.get(k, [])) for k in ("log", "end_epoch", "log_model",
                                                      "log_training_progress")) / 1e3
    wb.update(host_ms=wandb_ms, epoch_share=epoch_wb / sum(evals["walls"]))
    log(f"  on {card}: host ms a plot: " + ", ".join(
        f"{k} {np.median(v):.1f}" + (f" (x{len(v)})" if len(v) > 1 else "")
        for k, v in plot_ms.items()) + f"; the W&B wiring {epoch_wb:.3f} s of the epochs' "
        f"{sum(evals['walls']):.1f} s ({100 * wb['epoch_share']:.2f}%), its set-up (the "
        f"dataset artifacts) {sum(wandb_ms.get('__init__', [0])) / 1e3:.2f} s")
    res["run_a"] = {"launches": launches, "eval_launches": evals["launches"],
                    "k6_per_step": steps.k6, "step_ms": steps.ms, "epoch_walls_s": evals["walls"],
                    "wall_s": wall_a, "results": rows.tolist(), "errs": errs,
                    "k6": {"loss_rel": dl, "dz_max_abs": dabs, "dz_rel": drel},
                    "wandb": wb, "plot_host_ms": plot_ms}
    del evals, steps

    # the loaders: the first batches with 1 and TC_WORKERS threads
    t0 = time.perf_counter()
    (d1, s1, ds), (d8, s8, _) = tc_batches(data, 1), tc_batches(data, TC_WORKERS)
    same = (all(np.array_equal(a, b) for a, b in zip(d1[:3], d8[:3]))
            and np.array_equal(s1[0], s8[0]) and np.array_equal(s1[1], s8[1]))
    lab = d1[1][d1[2]]
    ok = bool(len(lab)) and (lab[:, 1:] >= 0).all() and (lab[:, 1:] <= 1).all() \
        and (lab[:, 3:] > 0).all()
    log(f"  loaders: first det batch {d1[0].shape} ({len(lab)} labels), seg batch "
        f"{s1[0].shape}: 1 and {TC_WORKERS} workers bitwise equal {same}; labels in [0, 1], "
        f"w, h > 0: {ok}")
    if not (same and ok):
        raise AssertionError("the loaders' first batches differ across worker counts, or a "
                             "label is out of [0, 1] or empty")
    det_ms = host_ms(lambda: ds.item(0, *generators(SEED, 0, 0)), reps=1)
    from multiyolov5_tpu_torch.data.segmentation import get_citys_loader
    seg_ds = get_citys_loader(root=data["segtrain"], split="train", mode="train",
                              batch_size=TC_BS, base_size=TC_IMG[1],
                              crop_size=(TC_IMG[0], TC_IMG[0] // 2)).ds
    seg_ms = host_ms(lambda: seg_ds.item(0, generators(SEED, 0, 0)[0]), reps=1)
    step_ms = float(np.median(res["run_a"]["step_ms"][1:]))
    log(f"  on {card}: one det training item (mosaic, {TC_IMG[0]}) {det_ms:.1f} host ms, one "
        f"seg training item {seg_ms:.1f} host ms (one thread each); step {step_ms:.1f} ms "
        f"(median after the first, synchronised); epoch walls "
        f"{[round(v, 2) for v in res['run_a']['epoch_walls_s']]} s")
    res["times"] = {"det_item_host_ms": det_ms, "seg_item_host_ms": seg_ms,
                    "step_ms": step_ms, "epoch_walls_s": res["run_a"]["epoch_walls_s"]}

    parts["loaders"] = time.perf_counter() - t0

    # run B: two epochs, interrupted at epoch 1's first step, then resumed
    t0 = time.perf_counter()
    with contextlib.suppress(KeyboardInterrupt):
        tc_run(short + ["--epochs", "2", "--project", work, "--name", "b"],
               TcSteps(cli, stop_at=TC_SHORT // TC_BS + 1))
    parts["run_b_interrupted"] = time.perf_counter() - t0
    last_b = os.path.join(work, "b", "weights", "last.npz")
    held = load_npz(last_b)
    if held["epoch"] != 0 or held.get("opt") is None:
        raise AssertionError(f"run B's last.npz: epoch {held['epoch']}, opt "
                             f"{held.get('opt') is not None}")
    cmds = quiet(resume_tool.main, ["--dir", work, "--dry-run"])
    named = [c[c.index("--weights") + 1] for c in cmds]
    if named != [last_b]:
        raise AssertionError(f"tools/resume.py named {named}, want only {last_b}")
    restored = []
    real_restore = cli._restore

    def spy(ts, tree, device):
        real_restore(ts, tree, device)
        restored.append(({k: v.detach().cpu().clone() for k, v in ts.opt["momentum"].items()},
                         {k: v.detach().cpu().clone() for k, v in ts.ema.items()}, ts.updates))
    with replaced(cli, "_restore", spy):
        run_b, _ = tc_run(["--resume", last_b, "--device", base[-1], "--no-wandb"],
                          TcSteps(cli))
    mom, ema, updates = restored[0]
    want_mom = from_jax_params(held["opt"], {})
    want_ema = from_jax_params(held["ema_params"], held["ema_state"])
    diff = (sum(not torch.equal(mom[k], want_mom[k]) for k in want_mom)
            + sum(not torch.equal(ema[k], want_ema[k]) for k in want_ema)
            + int(updates != int(held["updates"])) + int(set(mom) != set(want_mom)))
    rows_b = tc_results(run_b, 2)
    log(f"  run B: interrupted at epoch 1 (last.npz epoch 0, {int(held['updates'])} updates); "
        f"tools/resume.py --dry-run named it alone; --resume continued epochs "
        f"{rows_b[1:, 0].tolist()}")
    check("run B resumed: momentum, EMA and update count entries not bitwise equal to the "
          "file's", diff, 0)
    res["run_b"] = {"updates_held": int(held["updates"]), "epochs": rows_b[:, 0].tolist()}

    parts["run_b"] = time.perf_counter() - t0

    # run C: BiSe with quad, multi-scale, remat and OHEM; no K6
    t0 = time.perf_counter()
    K.reset_launches()
    steps = TcSteps(cli)
    run_c, _ = tc_run(["--no-wandb", "--data", short_data(data_path), "--cfg", TC_C_CFG,
                       "--img-size", str(TC_C_IMG[0]),
                       str(TC_C_IMG[1]), "--batch-size", str(TC_BS), "--epochs", "1",
                       "--quad", "--multi-scale", "--remat", "--seg-loss", "ohem",
                       "--seg-eval-interval", "1", "--workers", str(TC_WORKERS), "--seed",
                       str(SEED), "--no-tb", "--project", work, "--name", "c",
                       "--device", base[-1]], steps)
    rows_c = tc_results(run_c, 1)
    launches_c = K.launch_counts()
    check("run C (BiSe, OHEM): K6 launches", launches_c["seg_ce"] + launches_c["seg_ce_bwd"], 0)
    rng = np.random.RandomState(SEED + 45)
    img = TC_C_IMG[0]
    batch = (torch.from_numpy((rng.rand(TC_BS // 4, 2 * img, 2 * img, 3) * 255)
                              .astype(np.uint8)).to(DEVICE),
             *(torch.as_tensor(a).to(DEVICE) for a in train_batch(rng, TC_BS // 4, nc, 19)[1:3]),
             torch.from_numpy(rng.rand(TC_BS, img // 2, img, 3).astype(np.float32)).to(DEVICE),
             torch.from_numpy(rng.randint(-1, 19, (TC_BS, img // 2, img))).to(DEVICE))
    parts["run_c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    peaks = {}
    if DEVICE == "cuda":
        from multiyolov5_tpu_torch.models.model import seeded_state_dict
        c_spec = load_spec(TC_C_CFG)
        c_sd = seeded_state_dict(c_spec, SEED)
        peaks = {name: tc_peak(c_spec, c_sd, remat, batch)
                 for name, remat in (("remat", True), ("plain", False))}
    log(f"  run C ({TC_C_CFG}, --quad --multi-scale --remat --seg-loss ohem): results "
        f"{rows_c[0, 1:6].tolist()} (finite), K6 not launched; launches {launches_c}; one "
        f"bf16 step's peak device memory (det {tuple(batch[0].shape)}, seg "
        f"{tuple(batch[3].shape)}): with remat {peaks.get('remat', 0) / 2**30:.2f} GiB, "
        f"without {peaks.get('plain', 0) / 2**30:.2f} GiB")
    res["run_c"] = {"launches": launches_c, "results": rows_c.tolist(), "peak_bytes": peaks,
                    "step_ms": steps.ms}
    parts["peaks"] = time.perf_counter() - t0
    res["part_s"] = parts
    log("  [14]'s parts, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    for name in ("a", "b", "c"):      # [15] (d) trains on the trees; it removes them
        shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    res["tree"] = data_path
    return res


# [15] parallelism: two ranks share the one card over gloo (NCCL refuses two
# ranks on one device), at [7]'s geometry; the spatial forward at 512x1024
PAR_WORLD = 2
PAR_SPATIAL_BS, PAR_SPATIAL_HW = 2, (512, 1024)
PAR_REPS = 1
# the spatial forward against the one-process forward, both float32 on the
# card: rtol 1e-4 as the JAX package's own test (tests/test_spatial.py:110-111)
# with an absolute term of 1e-4 of the output's scale.  That test's 1e-5
# absolute holds the JAX package against itself at its init's small
# outputs; here the shards' convolutions run at other shapes (cuDNN picks
# its algorithms a shape), and on the CPU at the test weights the port's
# sharded forward was 4.9e-5 off its unsharded one at a logit scale of 10.6
# (tests/test_torch_parallel_spatial.py)
SPATIAL_RTOL, SPATIAL_ATOL_OF_SCALE = 1e-4, 1e-4
# [15] (f): every row type sharded at an uneven H, float32 at full width:
# the hub's yolov3-tiny (a zero pad and a stride-1 max pool across rows),
# yolov5s-transformer (C3TR on the gathered map) and pspv5s, each at
# 544x1024 (17 units of the stride 32: 288 + 256 rows), bs1; (g) the dp1 x
# sp2 step at an uneven H: det 800x832 (25 units: 416 + 384), seg 544x1024
PAR_UNEVEN_HW = (544, 1024)
PAR_UNEVEN_CFGS = ("yolov3-tiny", "yolov5s-transformer", CFG)
PAR_UNEVEN_DET_HW, PAR_UNEVEN_SEG_HW = (800, 832), (544, 1024)
# the training CLI under [15]: one epoch of two steps (16 frames, batch 8)
# and rank 0's seg eval (--noval: [14] holds the detection eval); 1024
# keeps every H shard of the det image and the seg crop (1024 x 512) a
# multiple of the stride 32 under --model-parallel 2
PAR_CLI_IMG = 1024


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def par_state(spec, sd, device, bs, mesh=None):
    """A float32 train state and step (hyp scratch) of ``sd``, over ``mesh``."""
    from multiyolov5_tpu_torch.data.hyps import load_hyp
    from multiyolov5_tpu_torch.train import trainer as T
    cfg = T.TrainConfig(hyp=load_hyp("scratch"), batch_size=bs, compute_dtype=torch.float32)
    ts, groups = T.create_train_state(spec, cfg, state_dict=sd, device=device)
    return ts, T.make_train_step(spec, cfg, groups, mesh=mesh)


def _host(tree):
    return {k: v.detach().cpu().clone() for k, v in tree.items()}


def _timed_steps(ts, step, batch, args, device) -> list:
    """Host ms of PAR_REPS synchronised steps (each updates the state)."""
    out = []
    for _ in range(PAR_REPS):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(ts, *batch, *args)
        if device == "cuda":
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


@contextlib.contextmanager
def collective_meter(device):
    """Count the bytes each collective of parallel/comm.py sends (its
    input) and its host ms (synchronised before and after), for the duration."""
    from multiyolov5_tpu_torch.parallel import comm
    rec = {"all_reduce": [0, 0, 0.0], "all_gather": [0, 0, 0.0]}

    def meter(kind, real):
        def run(self, t, *a):
            if self.size == 1:
                return real(self, t, *a)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(self, t, *a)
            if device == "cuda":
                torch.cuda.synchronize()
            r = rec[kind]
            r[0] += 1
            r[1] += t.numel() * t.element_size()
            r[2] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    with replaced(comm.Group, "all_reduce_", meter("all_reduce", comm.Group.all_reduce_)), \
            replaced(comm.Group, "all_gather_raw", meter("all_gather",
                                                         comm.Group.all_gather_raw)):
        yield rec


def uneven_frames(hw):
    """[15] (f)'s seeded bs1 frame."""
    return (np.random.RandomState(SEED + 53).rand(1, *hw, 3) * 255).astype(np.uint8)


def spatial_of(cfg: str, mesh, device: str):
    """``spatial_forward`` (float32) of ``cfg`` at full width on seeded
    weights, over ``mesh``."""
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import Model, seeded_state_dict
    from multiyolov5_tpu_torch.parallel.spatial import spatial_forward
    spec = load_spec(cfg)
    model = Model(spec)
    model.load_state_dict(seeded_state_dict(spec, SEED), strict=False)
    return spatial_forward(model.to(device), mesh, compute_dtype=torch.float32)


def par_rank(rank: int, world: int, store: str, device: str, geo: dict, out: str) -> None:
    """One rank of [15]: (a) the data-parallel step with K6 and its global
    D held on this rank's arguments, (e) the sharded checkpoint of its
    state, (c) the dp1 x sp2 step, (b) the spatial forward, (g) the dp1 x
    sp2 step at an uneven H, (f) the spatial forward of every row type at
    an uneven H; readings.  Saves its results under ``out``."""
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import Model, seeded_state_dict
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.parallel.mesh import (initialize_distributed, make_mesh,
                                                     shard_train_batch)
    from multiyolov5_tpu_torch.parallel.spatial import spatial_forward
    from multiyolov5_tpu_torch.train import trainer as T
    from multiyolov5_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    initialize_distributed(f"file://{store}", world, rank, device=device)
    res = {"backend": torch.distributed.get_backend()}
    spec = load_spec(geo["cfg"])
    sd = seeded_state_dict(spec, SEED)
    host = train_batch(np.random.RandomState(SEED + 9), geo["bs"], spec.nc, spec.n_segcls,
                       geo["det_hw"], geo["seg_hw"])
    args = (*TRAIN_STEP_ARGS, True)

    # (a) the data-parallel step: K6 once forward, once backward on this rank
    mesh = make_mesh(world, 1)
    unit = max(spec.strides)
    batch = tuple(torch.as_tensor(a).to(device) for a in shard_train_batch(mesh, host, unit))
    ts, step = par_state(spec, sd, device, geo["bs"], mesh)
    rec = []
    K.reset_launches()
    with spied(T, "seg_ce", before=lambda z, y, w=None, group=None: rec.append(
            (z.detach().clone(), y.clone(), w, group))):
        ts, m = step(ts, *batch, *args)
    if device == "cuda":
        torch.cuda.synchronize()
    res["launches"] = K.launch_counts()
    res["metrics"] = {k: v.cpu() for k, v in m.items()}
    res["dp"] = {"state": _host(ts.state_dict()), "ema": _host(ts.ema),
                 "momentum": _host(ts.opt["momentum"]), "updates": ts.updates}
    # K6 with the global D against its plain version on this rank's arguments
    z, y, w, group = rec[0]
    upstream = geo["bs"] * T.TrainConfig(hyp={}).seggain
    k6 = []
    for fn in (K.seg_ce, K.seg_ce_plain):
        zz = z.detach().clone().requires_grad_(True)
        loss = fn(zz, y, w, group=group)
        (loss * upstream).backward()
        k6.append((loss.detach().float().cpu(), zz.grad.float()))
    (lk, gk), (lp, gp) = k6
    dz = (gk - gp).abs().max().item()
    res["k6"] = {"z": tuple(z.shape), "loss_rel": abs(lk.item() - lp.item()) / abs(lp.item()),
                 "dz_max_abs": dz, "dz_rel": dz / gp.abs().max().item(),
                 "group": group.size if group is not None else 1}
    # (e) the state through save_sharded / load_sharded, every rank
    tree = {"state": res["dp"]["state"], "ema": res["dp"]["ema"],
            "momentum": res["dp"]["momentum"], "updates": ts.updates}
    save_sharded(geo["ckpt"], tree)
    back = load_sharded(geo["ckpt"])
    res["ckpt_diff"] = sum(int(not torch.equal(back[p][k], tree[p][k]))
                           for p in ("state", "ema", "momentum") for k in tree[p]) \
        + int(back["updates"] != tree["updates"])
    # readings: ms a step, then one step's collectives
    res["dp_step_ms"] = _timed_steps(ts, step, batch, args, device)
    with collective_meter(device) as meter:
        step(ts, *batch, *args)
    res["dp_collectives"] = meter
    del ts, step, rec, k6

    # (c) the dp1 x sp2 step on the same global batch: H over the two ranks
    mesh = make_mesh(1, world)
    batch = tuple(torch.as_tensor(a).to(device) for a in shard_train_batch(mesh, host, unit))
    ts, step = par_state(spec, sd, device, geo["bs"], mesh)
    step = functools.partial(step, heights=(host[0].shape[1], host[3].shape[1]))
    K.reset_launches()
    ts, m = step(ts, *batch, *args)
    if device == "cuda":
        torch.cuda.synchronize()
    res["sp_launches"] = K.launch_counts()
    res["sp_metrics"] = {k: v.cpu() for k, v in m.items()}
    res["sp"] = {"state": _host(ts.state_dict()), "ema": _host(ts.ema),
                 "momentum": _host(ts.opt["momentum"]), "updates": ts.updates}
    res["sp_step_ms"] = _timed_steps(ts, step, batch, args, device)
    with collective_meter(device) as meter:
        step(ts, *batch, *args)
    res["sp_collectives"] = meter
    del ts, step

    # (b) the spatial forward (float32) of the seeded frames, H over the ranks
    model = Model(spec)
    model.load_state_dict(sd, strict=False)
    fn = spatial_forward(model.to(device), mesh, compute_dtype=torch.float32)
    frames = (np.random.RandomState(SEED + 51).rand(PAR_SPATIAL_BS, *geo["spatial_hw"], 3)
              * 255).astype(np.uint8)
    det, seg = fn(frames)
    res["spatial"] = {"det": det.cpu(), "seg": seg.cpu()}
    res["spatial_ms"] = []
    for _ in range(PAR_REPS):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(frames)
        if device == "cuda":
            torch.cuda.synchronize()
        res["spatial_ms"].append((time.perf_counter() - t0) * 1e3)
    with collective_meter(device) as meter:
        fn(frames)
    res["spatial_collectives"] = meter
    del model, fn

    # (g) the dp1 x sp2 step at an uneven H: the ranks hold 416 + 384 det
    # rows and 288 + 256 seg rows (mesh.split_rows in units of the stride)
    host_u = train_batch(np.random.RandomState(SEED + 13), geo["bs"], spec.nc, spec.n_segcls,
                         geo["uneven_det_hw"], geo["uneven_seg_hw"])
    batch = tuple(torch.as_tensor(a).to(device) for a in shard_train_batch(mesh, host_u, unit))
    res["uneven_rows"] = (batch[0].shape[1], batch[3].shape[1])
    ts, step = par_state(spec, sd, device, geo["bs"], mesh)
    step = functools.partial(step, heights=(host_u[0].shape[1], host_u[3].shape[1]))
    ts, m = step(ts, *batch, *args)
    res["uneven_sp_metrics"] = {k: v.cpu() for k, v in m.items()}
    res["uneven_sp"] = {"state": _host(ts.state_dict()), "ema": _host(ts.ema),
                        "momentum": _host(ts.opt["momentum"]), "updates": ts.updates}
    del ts, step

    # (f) every row type sharded at an uneven H: one timed forward each,
    # pspv5s's collectives metered
    res["uneven"] = {}
    frame = uneven_frames(geo["uneven_hw"])
    for cfg in geo["uneven_cfgs"]:
        fn = spatial_of(cfg, mesh, device)
        det, seg = fn(frame)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(frame)
        if device == "cuda":
            torch.cuda.synchronize()
        r = {"det": det.cpu(), "seg": None if seg is None else seg.cpu(),
             "ms": (time.perf_counter() - t0) * 1e3}
        if cfg == geo["cfg"]:
            with collective_meter(device) as meter:
                fn(frame)
            r["collectives"] = meter
        res["uneven"][cfg] = r
        del fn
    torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(out, f"{rank}.pt"))


def par_cli_rank(rank: int, world: int, argv, out: str) -> None:
    """One rank of [15]'s training CLI run."""
    from multiyolov5_tpu_torch.cli import train as cli
    res = quiet(cli.main, argv + ["--num-processes", str(world), "--process-id", str(rank)])
    torch.save(res, os.path.join(out, f"cli{rank}.pt"))


def spawn(fn, world: int, args, timeout_s: float = 600.0) -> None:
    """``fn(rank, world, *args)`` in ``world`` spawned processes, joined;
    a rank's failure raises here."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world, join=False,
                             start_method="spawn")
    t0 = time.perf_counter()
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > timeout_s:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"{fn.__name__}: ranks still running after {timeout_s} s")


def _held_step(what, r, ref, init, metrics, ref_metrics):
    """A rank's step state and metrics against the one-process step's."""
    for k in ("total", "seg_loss", "det_items"):
        check(f"{what}: {k} max|diff|/|one process|",
              ((metrics[k] - ref_metrics[k]).abs() / ref_metrics[k].abs()).max().item(),
              TRAIN_LOSS_REL)
    worst = {}
    for part, ref_part, base in (("state", ref["state"], init), ("ema", ref["ema"], init),
                                 ("momentum", ref["momentum"],
                                  {k: torch.zeros_like(v) for k, v in ref["momentum"].items()})):
        bad, worst[part], _ = change_errors(r[part], ref_part, base)
        check(f"{what}: {part} tensors off their change bound", len(bad), 0)
    return worst


def phase_parallel(card: str, tree: str = None):
    """[15] parallelism on the card: (a) the data-parallel step over two
    ranks sharing the card (gloo), K6 held on each rank's arguments with
    the global D, against the one-process step, and the same step at world
    1 over NCCL; (b) the spatial forward at n_model 2 against the
    one-process forward; (c) the dp1 x sp2 step; (d) cli.train.main with
    --num-processes 2, then --model-parallel 2; (e) the sharded checkpoint
    round trip; (f) the spatial forward of yolov3-tiny, yolov5s-transformer
    and pspv5s at an uneven H against the one-process forward; (g) the dp1
    x sp2 step at an uneven H against the one-process step; readings of ms
    a step and a frame, and of the collectives.  (d) trains on ``tree``
    ([14]'s dataset file; its directory is removed at the end) where given."""
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import Model, seeded_state_dict
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.parallel.mesh import make_mesh, split_rows
    from multiyolov5_tpu_torch.parallel.spatial import spatial_forward
    from multiyolov5_tpu_torch.utils.checkpoint import load_npz, load_sharded
    log(f"[15] parallelism: {CFG} seed {SEED} float32 (TF32 off), {PAR_WORLD} ranks sharing "
        f"the card over gloo; steps at det bs{TRAIN_BS} {TRAIN_DET_HW} + seg bs{TRAIN_BS} "
        f"{TRAIN_SEG_HW} (global batch), the spatial forward at bs{PAR_SPATIAL_BS} "
        f"{PAR_SPATIAL_HW}")
    work = os.path.join(ROOT, "build", "chip_smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    geo = {"cfg": CFG, "bs": TRAIN_BS, "det_hw": TRAIN_DET_HW, "seg_hw": TRAIN_SEG_HW,
           "spatial_hw": PAR_SPATIAL_HW, "ckpt": os.path.join(work, "sharded"),
           "uneven_hw": PAR_UNEVEN_HW, "uneven_cfgs": PAR_UNEVEN_CFGS,
           "uneven_det_hw": PAR_UNEVEN_DET_HW, "uneven_seg_hw": PAR_UNEVEN_SEG_HW}
    t0 = time.perf_counter()
    spawn(par_rank, PAR_WORLD, (os.path.join(work, "store"), DEVICE, geo, work))
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"{r}.pt"), weights_only=False)
             for r in range(PAR_WORLD)]
    log(f"  {PAR_WORLD} ranks over {ranks[0]['backend']} ran (a), (e), (c), (b), (g), (f) in "
        f"{wall:.1f} s (spawn and CUDA init included)")
    res = {"card": card, "ranks_wall_s": wall, "backend": ranks[0]["backend"]}

    # the one-process references on the card: the step on the global batch
    spec = load_spec(CFG)
    sd = seeded_state_dict(spec, SEED)
    init = {k: v.float() for k, v in sd.items()}
    host = train_batch(np.random.RandomState(SEED + 9), TRAIN_BS, spec.nc, spec.n_segcls)
    batch = tuple(torch.as_tensor(a).to(DEVICE) for a in host)
    args = (*TRAIN_STEP_ARGS, True)
    ts, step = par_state(spec, sd, DEVICE, TRAIN_BS)
    ts, m1 = step(ts, *batch, *args)
    ref = {"state": _host(ts.state_dict()), "ema": _host(ts.ema),
           "momentum": _host(ts.opt["momentum"])}
    ref_metrics = {k: v.cpu() for k, v in m1.items()}
    one_ms = _timed_steps(ts, step, batch, args, DEVICE)
    del ts, step

    # (a) the data-parallel step
    for r, q in enumerate(ranks):
        c = q["launches"]
        log(f"  (a) rank {r}: total {q['metrics']['total'].item():.6f} (one process "
            f"{ref_metrics['total'].item():.6f}); launches {c}")
        if DEVICE == "cuda" and (c["seg_ce"], c["seg_ce_bwd"]) != (1, 1):
            raise AssertionError(f"(a) rank {r}: K6 forward/backward launched "
                                 f"{c['seg_ce']}/{c['seg_ce_bwd']} times, not once each")
        k6 = q["k6"]
        log(f"  (a) rank {r}: seg_ce with the global D (over {k6['group']} ranks) on its "
            f"{k6['z']} logits: loss |diff| {k6['loss_rel']:.3e} relative, dz max|diff| "
            f"{k6['dz_max_abs']:.3e}")
        check(f"(a) rank {r} seg_ce (global D) loss |diff|/|plain|", k6["loss_rel"],
              SEG_CE_LOSS_REL)
        check(f"(a) rank {r} seg_ce (global D) dz max|diff|/max|plain dz|", k6["dz_rel"],
              SEG_CE_DZ_REL[torch.float32])
    diff = sum(int(not torch.equal(ranks[0]["dp"][p][k], ranks[1]["dp"][p][k]))
               for p in ("state", "ema", "momentum") for k in ranks[0]["dp"][p])
    check("(a) the ranks' states: tensors not bitwise equal", diff, 0)
    worst = _held_step("(a) dp2 vs one process", ranks[0]["dp"], ref, init,
                       ranks[0]["metrics"], ref_metrics)
    res["a"] = {"launches": [q["launches"] for q in ranks], "k6": [q["k6"] for q in ranks],
                "worst_change_rel": worst, "total": ranks[0]["metrics"]["total"].item(),
                "one_process_total": ref_metrics["total"].item()}

    # (a) again at world 1 over NCCL, the CLI's backend for a card a rank
    if DEVICE == "cuda":
        torch.distributed.init_process_group("nccl", init_method=f"file://{work}/nccl",
                                             world_size=1, rank=0,
                                             device_id=torch.device(DEVICE, 0))
        try:
            mesh = make_mesh()
            ts, step = par_state(spec, sd, DEVICE, TRAIN_BS, mesh)
            ts, mn = step(ts, *batch, *args)
            got = {"state": _host(ts.state_dict()), "ema": _host(ts.ema),
                   "momentum": _host(ts.opt["momentum"])}
            backend = torch.distributed.get_backend()
            del ts, step
        finally:
            torch.distributed.destroy_process_group()
        log(f"  (a) world 1 over {backend}: total {mn['total'].item():.6f}")
        res["a"]["nccl_worst_change_rel"] = _held_step(
            "(a) world 1 over NCCL vs one process", got, ref, init,
            {k: v.cpu() for k, v in mn.items()}, ref_metrics)

    # (e) the sharded checkpoint: written by both ranks, read by both and by this process
    back = load_sharded(geo["ckpt"])
    diff = sum(int(not torch.equal(back[p][k], ranks[0]["dp"][p][k]))
               for p in ("state", "ema", "momentum") for k in ranks[0]["dp"][p])
    check("(e) save_sharded -> load_sharded: entries not bitwise equal (ranks, then one "
          "process)", sum(q["ckpt_diff"] for q in ranks) + diff, 0)

    # (c) the dp1 x sp2 step: no K6 (the plain seg loss under a model axis)
    c = ranks[0]["sp_launches"]
    check("(c) dp1 x sp2 step: K6 launches", c["seg_ce"] + c["seg_ce_bwd"], 0)
    diff = sum(int(not torch.equal(ranks[0]["sp"][p][k], ranks[1]["sp"][p][k]))
               for p in ("state", "ema", "momentum") for k in ranks[0]["sp"][p])
    check("(c) the ranks' states: tensors not bitwise equal", diff, 0)
    res["c"] = {"worst_change_rel": _held_step("(c) dp1 x sp2 vs one process", ranks[0]["sp"],
                                               ref, init, ranks[0]["sp_metrics"], ref_metrics)}

    # (b) the spatial forward against the one-process Model(kernels=False) forward
    model = Model(spec)
    model.load_state_dict(sd, strict=False)
    fn = spatial_forward(model.to(DEVICE), make_mesh(), compute_dtype=torch.float32)
    frames = (np.random.RandomState(SEED + 51).rand(PAR_SPATIAL_BS, *PAR_SPATIAL_HW, 3)
              * 255).astype(np.uint8)
    z, seg = (t.cpu() for t in fn(frames))
    spatial_one_ms = []
    for _ in range(PAR_REPS):
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(frames)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        spatial_one_ms.append((time.perf_counter() - t0) * 1e3)
    res["b"] = {}
    for r, q in enumerate(ranks):
        for name, got, want in (("boxes", q["spatial"]["det"][:, :4], z[:, :4]),
                                ("obj/cls", q["spatial"]["det"][:, 4:], z[:, 4:]),
                                ("seg logits", q["spatial"]["seg"], seg)):
            scale = want.abs().max().item()
            excess = ((got - want).abs() - SPATIAL_RTOL * want.abs()).max().item()
            check(f"(b) rank {r} spatial {name}: max(|diff| - {SPATIAL_RTOL:g} |one process|) "
                  f"/ scale {scale:.3g}", max(excess, 0.0) / scale, SPATIAL_ATOL_OF_SCALE)
            res["b"][f"{name} rank {r}"] = {"max_abs": (got - want).abs().max().item(),
                                           "scale": scale}
    del model, fn

    # (d) the training CLI as two ranks: --num-processes 2, then --model-parallel 2,
    # both runs spawned from threads at once while this process computes
    # (g)'s and (f)'s one-process references (so (d)'s walls share the card
    # with them)
    data_path = tree or tc_tree(os.path.join(work, "tree"), np.random.RandomState(SEED + 61),
                                spec.nc)
    cli_runs, cli_errors = {}, []
    ports = set()
    while len(ports) < 2:
        ports.add(_free_port())

    def cli_ranks(name, extra, port):
        """One run of the CLI's ranks; the two runs go at once."""
        try:
            argv = ["--data", short_data(data_path), "--no-wandb", "--cfg", CFG, "--img-size",
                    str(PAR_CLI_IMG), str(PAR_CLI_IMG), "--batch-size", str(TC_BS), "--epochs",
                    "1", "--noval",
                    "--seg-eval-interval", "1", "--workers", str(TC_WORKERS), "--seed",
                    str(SEED), "--no-tb", "--project", os.path.join(work, "runs"), "--name",
                    name, "--coordinator", f"localhost:{port}",
                    "--device", "" if DEVICE == "cuda" else DEVICE, *extra]
            out = os.path.join(work, name)
            os.makedirs(out)
            t0 = time.perf_counter()
            spawn(par_cli_rank, PAR_WORLD, (argv, out))
            cli_runs[name] = (extra, time.perf_counter() - t0,
                              [torch.load(os.path.join(out, f"cli{r}.pt"),
                                          weights_only=False)[0] for r in range(PAR_WORLD)])
        except BaseException as e:  # noqa: BLE001 (raised in the main thread)
            cli_errors.append(e)

    import threading
    cli_threads = [threading.Thread(target=cli_ranks, args=(name, extra, port))
                   for (name, extra), port in zip(
                       (("dp2", []), ("dp1_sp2", ["--model-parallel", str(PAR_WORLD)])),
                       sorted(ports))]
    for t in cli_threads:
        t.start()
    try:
        # (g) the dp1 x sp2 step at an uneven H against the one-process step on
        # the same global batch
        host_u = train_batch(np.random.RandomState(SEED + 13), TRAIN_BS, spec.nc, spec.n_segcls,
                             PAR_UNEVEN_DET_HW, PAR_UNEVEN_SEG_HW)
        ts, step = par_state(spec, sd, DEVICE, TRAIN_BS)
        ts, mu = step(ts, *(torch.as_tensor(a).to(DEVICE) for a in host_u), *args)
        ref_u = {"state": _host(ts.state_dict()), "ema": _host(ts.ema),
                 "momentum": _host(ts.opt["momentum"])}
        del ts, step
        rows = [q["uneven_rows"] for q in ranks]
        unit = max(spec.strides)
        want = list(zip(split_rows(PAR_UNEVEN_DET_HW[0], PAR_WORLD, unit),
                        split_rows(PAR_UNEVEN_SEG_HW[0], PAR_WORLD, unit)))
        log(f"  (g) dp1 x sp2 at det {PAR_UNEVEN_DET_HW} + seg {PAR_UNEVEN_SEG_HW}: the ranks "
            f"hold {rows} (det, seg) rows")
        check("(g) ranks whose det and seg rows differ from split_rows' (uneven)",
              sum(int(tuple(r) != w) for r, w in zip(rows, want)), 0,
              ok=rows == [tuple(w) for w in want] and rows[0] != rows[1])
        diff = sum(int(not torch.equal(ranks[0]["uneven_sp"][p][k], ranks[1]["uneven_sp"][p][k]))
                   for p in ("state", "ema", "momentum") for k in ranks[0]["uneven_sp"][p])
        check("(g) the ranks' states: tensors not bitwise equal", diff, 0)
        res["g"] = {"rows": rows, "worst_change_rel": _held_step(
            "(g) dp1 x sp2 at an uneven H vs one process", ranks[0]["uneven_sp"], ref_u, init,
            ranks[0]["uneven_sp_metrics"], {k: v.cpu() for k, v in mu.items()})}

        # (f) every row type sharded at an uneven H against the one-process forward
        res["f"] = {}
        frame = uneven_frames(PAR_UNEVEN_HW)
        fns = {}
        for cfg in PAR_UNEVEN_CFGS:
            fns[cfg] = fn = spatial_of(cfg, make_mesh(), DEVICE)
            z, seg = fn(frame)
            outs = [("boxes", lambda q: q["det"][:, :4], z[:, :4].cpu()),
                    ("obj/cls", lambda q: q["det"][:, 4:], z[:, 4:].cpu())]
            if seg is not None:
                outs.append(("seg logits", lambda q: q["seg"], seg.cpu()))
            worst = 0.0
            for r, q in enumerate(ranks):
                u = q["uneven"][cfg]
                if (u["seg"] is None) != (seg is None):
                    raise AssertionError(f"(f) {cfg} rank {r}: seg output present on one side only")
                for name, pick, want in outs:
                    got = pick(u)
                    scale = want.abs().max().item()
                    excess = ((got - want).abs() - SPATIAL_RTOL * want.abs()).max().item()
                    worst = max(worst, max(excess, 0.0) / scale)
                    check(f"(f) {cfg} rank {r} at {PAR_UNEVEN_HW} {name}: max(|diff| - "
                          f"{SPATIAL_RTOL:g} |one process|) / scale {scale:.3g}",
                          max(excess, 0.0) / scale, SPATIAL_ATOL_OF_SCALE)
            res["f"][cfg] = {"worst_excess_of_scale": worst, "sp2_ms_a_frame": ranks[0]["uneven"][
                cfg]["ms"], "collectives": ranks[0]["uneven"][cfg].get("collectives")}

    finally:
        for t in cli_threads:
            t.join()
    if cli_errors:
        raise cli_errors[0]
    for cfg, fn in fns.items():           # (f)'s one-process time, the card to itself
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(frame)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        f_ms = res["f"][cfg]["one_process_ms_a_frame"] = (time.perf_counter() - t0) * 1e3
        log(f"  (f) {cfg} at {PAR_UNEVEN_HW} over {PAR_WORLD} ranks "
            f"({' + '.join(map(str, split_rows(PAR_UNEVEN_HW[0], PAR_WORLD, 32)))} rows): "
            f"{res['f'][cfg]['sp2_ms_a_frame']:.2f} ms a frame, one process {f_ms:.2f} "
            f"(one forward each, host clock, synchronised)")
    del fns
    res["d"] = {}
    frame = (np.random.RandomState(SEED + 63).rand(*IN_HW, 3) * 255).astype(np.uint8)
    for name, (extra, wall, runs) in cli_runs.items():
        made = sorted(os.listdir(os.path.join(work, "runs")))
        if len(set(runs)) != 1 or made.count(name) != 1 or any(
                m.startswith(name) and m != name for m in made):
            raise AssertionError(f"(d) {name}: the ranks' run directories {runs}, made {made}")
        rows = tc_results(runs[0], 1)
        path = os.path.join(runs[0], "weights", "last.npz")
        if load_npz(path).get("opt") is not None:
            raise AssertionError(f"(d) {name}: last.npz is not stripped")
        dets, masks = Engine(path, device=DEVICE, half=True)(frame, ORIG_HW, conf=CONF)
        if not (np.isfinite(dets[0]).all() and masks[0].shape == ORIG_HW):
            raise AssertionError(f"(d) {name}: rank 0's checkpoint does not serve")
        log(f"  (d) cli.train.main --num-processes {PAR_WORLD} {' '.join(extra)}: one run "
            f"directory (rank 0's), results.txt {rows[0, 1:6].tolist()}, last.npz stripped "
            f"and served ({len(dets[0])} detections); {wall:.1f} s with the spawn")
        res["d"][name] = {"results": rows.tolist(), "wall_s": wall}

    # readings: no speed-up is expected, the ranks share one card's SMs
    def med(v):
        return float(np.median(v))
    res["readings"] = {
        "one_process_step_ms": med(one_ms), "dp2_step_ms": med(ranks[0]["dp_step_ms"]),
        "dp1_sp2_step_ms": med(ranks[0]["sp_step_ms"]),
        "one_process_spatial_ms_a_frame": med(spatial_one_ms) / PAR_SPATIAL_BS,
        "sp2_spatial_ms_a_frame": med(ranks[0]["spatial_ms"]) / PAR_SPATIAL_BS,
        "collectives": {k: ranks[0][f"{k}_collectives"] for k in ("dp", "sp", "spatial")}}
    rd = res["readings"]
    log(f"  on {card}: one-process step {rd['one_process_step_ms']:.1f} ms, dp2 step "
        f"{rd['dp2_step_ms']:.1f} ms, dp1 x sp2 step {rd['dp1_sp2_step_ms']:.1f} ms (median of "
        f"{PAR_REPS}, host clock, synchronised); spatial forward "
        f"{rd['sp2_spatial_ms_a_frame']:.2f} ms a frame at n_model {PAR_WORLD}, one process "
        f"{rd['one_process_spatial_ms_a_frame']:.2f}")
    rd["collectives"]["uneven_spatial"] = res["f"][CFG]["collectives"]
    for k, v in rd["collectives"].items():
        log(f"  {k} collectives on rank 0 (one step or forward, each synchronised): "
            + "; ".join(f"{kind} {n} calls, {b / 2**20:.2f} MiB, {ms:.1f} ms"
                        for kind, (n, b, ms) in v.items()))
    shutil.rmtree(work, ignore_errors=True)
    if tree:
        shutil.rmtree(os.path.dirname(tree), ignore_errors=True)
    return res


def hold_recorded(eng, frames, what: str, bound: float):
    """One counted ``Engine`` call on ``frames`` (B, H, W, C) uint8 with the
    arguments of K1, K2, K7, K3, K5 and K4 recorded; each kernel the call
    launched then held against its plain version on them
    (:func:`hold_path_kernels`).  Returns (the call's output, its launches,
    the records, the errors)."""
    from multiyolov5_tpu_torch import engine as engine_mod
    from multiyolov5_tpu_torch.models import blocks
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops import nms as nms_mod
    rec = {k: [] for k in ("stem", "conv3x3", "c3", "nms", "nms_greedy", "upsample_argmax")}
    with spied(engine_mod, "stem", before=recorder(rec["stem"])), \
            spied(blocks, "conv3x3", before=recorder(rec["conv3x3"])), \
            spied(blocks, "c3", before=recorder(rec["c3"])), \
            spied(nms_mod, "nms_packed", before=recorder(rec["nms"])), \
            spied(nms_mod, "nms_greedy", before=recorder(rec["nms_greedy"])), \
            spied(engine_mod, "upsample_argmax", before=recorder(rec["upsample_argmax"])):
        K.reset_launches()
        out = eng(frames, ORIG_HW, conf=CONF)
        torch.cuda.synchronize()
        launches = K.launch_counts()
    return out, launches, rec, hold_path_kernels(rec, what, bound)


def want_launches(what: str, launches: dict, want: dict) -> None:
    log(f"  {what}: launches {launches}")
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")


def batch_vs_cpu(name, e32, cpu, frames, own_f64):
    """A batch of uint8 ``frames`` through the card's fp32 engine against
    the CPU's: the networks within max(NET_REL, F64_FACTOR x the CPU's own
    float32 error at bs1 (``own_f64``, by output)), the detections under
    [3]'s end-to-end bounds where the networks are within NET_REL (else
    reported)."""
    x = torch.from_numpy(frames)
    z_card, _ = e32.forward(x.to(DEVICE))
    t0 = time.perf_counter()
    z_cpu, _ = cpu.forward(x)
    t_cpu = time.perf_counter() - t0
    z_card = z_card.cpu()
    close = True
    for what, sl, k in (("boxes", slice(0, 4), 1), ("obj/cls", slice(4, None), 0)):
        err = diffs(z_card[:, sl], z_cpu[:, sl])[k]
        close = close and err <= NET_REL
        check(f"{name} network fp32 card vs CPU: {what} "
              f"{'max|diff|/max(max|ref|,1)' if k else 'max|diff|'}", err,
              max(NET_REL, F64_FACTOR * own_f64[what]["cpu_vs_f64"]))
    card = e32.postprocess(z_card.to(DEVICE), None, IN_HW, ORIG_HW, conf=CONF)
    ref = cpu.postprocess(z_cpu, None, IN_HW, ORIG_HW, conf=CONF)
    compare_runs(f"{name} end to end fp32 card vs CPU (the CPU forward took {t_cpu:.1f} s)"
                 + ("" if close else "; networks past NET_REL: detections reported"),
                 card, ref, E2E_MATCH_SHARE if close else None, BOX_PX if close else None,
                 E2E_SCORE_ABS, E2E_MASK_SHARE)
    return z_card, t_cpu


def phase_dsl(frames, card: str):
    """[16] the DSL's other rows: the v5.0 hub configs at full width on the
    card, and pspv5s with bilinear neck upsamples.  Failed bounds are
    raised at the end of the phase."""
    return deferring_checks("[16]", _phase_dsl, frames, card)


def _phase_dsl(frames, card: str):
    from multiyolov5_tpu_torch import evaluation as E
    from multiyolov5_tpu_torch.models import blocks
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops import nms as nms_mod
    from multiyolov5_tpu_torch.utils.profiling import estimate_gflops
    log(f"[16] the DSL's other rows: {DSL_MAIN}, {DSL_TR}, {', '.join(DSL_OTHERS)} at full "
        f"width and depth, seed {SEED}, {IN_HW} -> {ORIG_HW}, conf {CONF}")
    res = {"launches": {}}
    counted = []
    rng = np.random.RandomState(SEED + 31)
    batch = np.stack([(rng.rand(*IN_HW, 3) * 255).astype(np.uint8) for _ in range(DSL_BS)])

    # (a) yolov3: bs1 fp32 and bf16 (run_family), each kernel on its own
    # arguments, K2's sites timed, a bs8 batch, the eval path
    spec = load_spec(DSL_MAIN)
    with torch.device("meta"):
        from multiyolov5_tpu_torch.models.model import Model
        n_params = sum(p.numel() for p in Model(spec).parameters())
    gf = estimate_gflops(spec, None, IN_HW)
    log(f"  {DSL_MAIN}: {n_params} parameters, {gf:.4f} GFLOPs a frame at {IN_HW} "
        f"({estimate_gflops(spec, None, 640):.4f} at 640x640)")
    a, (e32, e16, cpu) = run_family(DSL_MAIN, frames[0])
    a.update(parameters=n_params, gflops=gf)
    n_k2 = a["k2_sites"]
    for eng, name, bound in ((e32, "fp32", F32_REL), (e16, "bf16", BF16_REL)):
        _, launches, rec, errs = hold_recorded(eng, frames[0][None], f"{DSL_MAIN} bs1 {name}",
                                               bound)
        want_launches(f"{DSL_MAIN} bs1 {name}", launches,
                      {"stem": 0, "conv3x3": n_k2, "nms": 1, "nms_greedy": 0, "c3": 0})
        counted.append(launches)
        a[f"bs1_{name}_errs"] = errs
        if name == "bf16":
            calls = [(x, wt, b, kw.get("stride", 1), kw.get("dilation", 1), kw.get("act", True))
                     for (x, wt, b), kw in rec["conv3x3"]]
            log(f"  conv3x3 bf16 at {DSL_MAIN}'s {len(calls)} bs1 sites (their own inputs):")
            a["k2_sites_bf16"], a["k2_bf16"] = time_k2(calls)
            t = a["k2_bf16"]
            log(f"  conv3x3 bf16 {DSL_MAIN} sums: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f}, cuDNN bf16 {t['library_ms']:.4f}, bound "
                f"{t['bound_ms']:.5f}")
    # bs8: launches, every kernel on its arguments, card against the CPU
    for eng, name, bound in ((e32, "fp32", F32_REL), (e16, "bf16", BF16_REL)):
        _, launches, _, errs = hold_recorded(eng, batch, f"{DSL_MAIN} bs{DSL_BS} {name}", bound)
        want_launches(f"{DSL_MAIN} bs{DSL_BS} {name}", launches,
                      {"stem": 0, "conv3x3": n_k2, "nms": 0, "nms_greedy": 1, "c3": 0})
        counted.append(launches)
        a[f"bs{DSL_BS}_{name}_errs"] = errs
    z8, a["bs8_cpu_s"] = batch_vs_cpu(f"{DSL_MAIN} bs{DSL_BS}", e32, cpu, batch,
                                      a["network_fp32"])
    z8_16, _ = e16.forward(torch.from_numpy(batch).to(DEVICE))
    own = a["bf16_vs_fp32"]["cpu"]["objcls_mean"]
    check(f"{DSL_MAIN} bs{DSL_BS} network bf16 vs fp32 card: obj/cls mean |diff|",
          (z8_16[:, 4:].float().cpu() - z8[:, 4:]).abs().mean().item(),
          max(BF16_OBJCLS_MEAN, BF16_FACTOR * own))
    for name, eng in (("fp32", e32), ("bf16", e16)):
        reps = [r / DSL_BS for r in frame_ms(eng, batch)]
        a[f"bs{DSL_BS}_{name}_ms"] = reps
        log(f"  {DSL_MAIN} Engine.__call__ bs{DSL_BS} {name}: median "
            f"{float(np.median(reps)):.3f} ms/frame over {FAMILY_REPS} reps of {FAMILY_ITERS}, "
            f"range {min(reps):.3f}-{max(reps):.3f}")
    # the eval path on one bs4 batch: K2 and K5 on their own arguments
    det_b, _ = eval_batches(e32, np.random.RandomState(SEED + 33), batches=1)
    rec = {k: [] for k in ("stem", "conv3x3", "c3", "nms_greedy", "upsample_argmax")}
    with spied(blocks, "conv3x3", before=recorder(rec["conv3x3"])), \
            spied(nms_mod, "nms_greedy", before=recorder(rec["nms_greedy"])):
        K.reset_launches()
        metrics, _, _ = quiet(E.evaluate_detection, e32, det_b, conf_thres=EVAL_CONF,
                              iou_thres=EVAL_IOU)
        torch.cuda.synchronize()
        launches = K.launch_counts()
    want_launches(f"{DSL_MAIN} evaluate_detection bs{EVAL_BS}", launches,
                  {"stem": 0, "conv3x3": n_k2, "nms": 0, "nms_greedy": 1, "c3": 0})
    counted.append(launches)
    a["eval_errs"] = hold_path_kernels(rec, f"{DSL_MAIN} eval", F32_REL)
    a["eval_metrics"] = [float(v) for v in metrics[:4]]
    log(f"  {DSL_MAIN} evaluate_detection P, R, mAP@.5, mAP: {a['eval_metrics']}")
    if not 0.0 < metrics[2] < 1.0:
        raise AssertionError(f"{DSL_MAIN}: degenerate mAP@.5 {metrics[2]}")
    res[DSL_MAIN] = a
    del e32, e16, cpu

    # (b) yolov5s-transformer: bs1 (K1, K2 s1 and s2, K3), C3TR against the
    # CPU, bs2 (K7 on the row-2 C3)
    b, (t32, t16, tcpu) = run_family(DSL_TR, frames[0])
    for eng, name, bound in ((t32, "fp32", F32_REL), (t16, "bf16", BF16_REL)):
        _, launches, rec, errs = hold_recorded(eng, frames[0][None], f"{DSL_TR} bs1 {name}",
                                               bound)
        want_launches(f"{DSL_TR} bs1 {name}", launches,
                      {"stem": 1, "conv3x3": b["k2_sites"], "nms": 1, "c3": 0})
        counted.append(launches)
        strides = sorted({kw.get("stride", 1) for _, kw in rec["conv3x3"]})
        if strides != [1, 2]:
            raise AssertionError(f"{DSL_TR}: K2 strides {strides}, want [1, 2]")
        b[f"bs1_{name}_errs"] = errs
    row = next(r.i for r in t32.spec.rows if r.module == "C3TR")
    seen = []
    hook = t32.model.model[row].register_forward_pre_hook(
        lambda m, args: seen.append(args[0].clone()))
    t32.forward(torch.from_numpy(frames[0][None]).to(DEVICE))
    hook.remove()
    with torch.inference_mode():
        got = t32.model.model[row](seen[0]).cpu()
        want = tcpu.model.model[row](seen[0].cpu())
    b["c3tr_rel"] = diffs(got, want)[1]
    log(f"  {DSL_TR} C3TR (row {row}) on the card's input {tuple(seen[0].shape)}: "
        f"{(seen[0].shape[2] * seen[0].shape[3])} tokens")
    check(f"{DSL_TR} C3TR row {row} fp32 card vs CPU max|diff|/max(max|ref|,1)",
          b["c3tr_rel"], F32_REL)
    x2 = np.stack(frames[:DSL_TR_BS])
    n_c3 = sum(isinstance(m, blocks.C3) and m.c3_kernel for m in t32.model.modules())
    if n_c3 < 1:
        raise AssertionError(f"{DSL_TR}: no C3 on K7")
    _, launches, _, b[f"bs{DSL_TR_BS}_errs"] = hold_recorded(
        t32, x2, f"{DSL_TR} bs{DSL_TR_BS} fp32", F32_REL)
    want_launches(f"{DSL_TR} bs{DSL_TR_BS} fp32 ({n_c3} C3 row(s) on K7)", launches,
                  {"stem": 1, "conv3x3": b["k2_sites"], "nms_greedy": 1, "c3": n_c3})
    counted.append(launches)
    batch_vs_cpu(f"{DSL_TR} bs{DSL_TR_BS}", t32, tcpu, x2, b["network_fp32"])
    res[DSL_TR] = b
    del t32, t16, tcpu

    # (c) the other four at bs1 in float32
    for cfg in DSL_OTHERS:
        res[cfg], _ = run_family(cfg, frames[0], half=False, timing=False)

    # (d) one float32 train step of yolov5-panet, card against the CPU
    spec = load_spec(DSL_TRAIN_CFG)
    sd = seeded_state_dict(spec, SEED, DEVICE)
    host = train_batch(np.random.RandomState(SEED + 35), DSL_TRAIN_BS, spec.nc, 2,
                       det_hw=DSL_TRAIN_HW, seg_hw=DSL_TRAIN_HW)
    args = (*TRAIN_STEP_ARGS, True)
    ts_c, step_c = train_state(spec, sd, torch.float32, DEVICE, DSL_TRAIN_BS)
    K.reset_launches()
    ts_c, m_c = step_c(ts_c, *(torch.as_tensor(t).to(DEVICE) for t in host), *args)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"{DSL_TRAIN_CFG} train step launched {launches}")
    t_cpu = time.perf_counter()
    ts_h, step_h = train_state(spec, sd, torch.float32, "cpu", DSL_TRAIN_BS)
    ts_h, m_h = step_h(ts_h, *host, *args)
    t_cpu = time.perf_counter() - t_cpu
    log(f"  {DSL_TRAIN_CFG} fp32 bs{DSL_TRAIN_BS} {DSL_TRAIN_HW} step, card vs CPU (the CPU "
        f"step took {t_cpu:.1f} s): total {m_c['total'].item():.5f}")
    for k in ("total", "det_items"):
        a_, b_ = m_c[k].cpu(), m_h[k]
        check(f"{DSL_TRAIN_CFG} train fp32 card vs CPU: {k} max|diff|/|CPU|",
              ((a_ - b_).abs() / b_.abs()).max().item(), TRAIN_LOSS_REL)
    # a network this deep amplifies float32 rounding itself (its CPU forward
    # is ~3e-3 off float64, (c)): as [9] does for the forward, the card's
    # step is held against the step in float64, to [7]'s change bound or
    # F64_FACTOR x the CPU's own float32 error, whichever is larger
    ts_64, _ = train_step64(spec, sd, host, args, DSL_TRAIN_BS)
    init = {k: v.float() for k, v in sd.items()}
    mom0 = {k: torch.zeros_like(v) for k, v in ts_h.opt["momentum"].items()}
    res["train"] = {"cpu_s": t_cpu}
    for what, got, want, ref, ref64 in (
            ("params+BN", ts_c.state_dict(), ts_h.state_dict(), init, ts_64.state_dict()),
            ("EMA", ts_c.ema, ts_h.ema, init, ts_64.ema),
            ("momentum", ts_c.opt["momentum"], ts_h.opt["momentum"], mom0,
             ts_64.opt["momentum"])):
        bad, worst, med = change_errors(got, want, ref)
        bad64 = [k for k in bad if not within_f64(got[k], want[k], ref64[k], ref[k])]
        log(f"  {what}: {len(want)} tensors, change |diff|/|change| card vs CPU worst "
            f"{worst:.3e}, median {med:.3e}; {len(bad)} past [7]'s change bound: {bad}")
        check(f"{DSL_TRAIN_CFG} train fp32 card vs float64: {what} tensors off max([7]'s "
              f"change bound, {F64_FACTOR:g} x the CPU's own error)", len(bad64), 0)
        res["train"][what] = {"worst": worst, "median": med, "past_change_bound": bad}
    # (e) pspv5s with its neck's nn.Upsample rows bilinear
    res["bilinear"], bl_counted = bilinear_neck(frames[0])
    counted += bl_counted
    res["launches"] = {k: sum(c[k] for c in counted) for k in counted[0]}
    log(f"  [16]'s counted runs launched {res['launches']} on {card}")
    return res


def bilinear_neck(frame):
    """[16] (e): pspv5s (CFG) with its neck's ``nn.Upsample`` rows (11 and
    15) bilinear, a dict cfg on the smoke's weights, bs1 at the serving
    geometry through :func:`run_family` (fp32 and bf16, the network against
    float64, post-processing on the card's own outputs and end to end
    against the CPU's under [3]'s bounds, bf16 against fp32 beside the
    CPU's own drift, every K2 site); then a counted fp32 and bf16 call
    each, with launches equal to the nearest model's (K1-K4) and each
    kernel held on its arguments, and seg logits that differ from the
    nearest model's (the mode took effect).  Returns (the results, the
    counted calls' launches)."""
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.models import zoo
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.utils.checkpoint import load_checkpoint
    t0 = time.perf_counter()
    cfg = zoo.get(CFG)
    cfg["head"] = [[f, n, m, [a[0], a[1], "bilinear"] if m == "nn.Upsample" else a]
                   for f, n, m, a in cfg["head"]]
    spec = load_spec(cfg)
    rows = [r.i for r in spec.rows if r.module == "nn.Upsample" and r.args[2] == "bilinear"]
    if rows != [11, 15]:
        raise AssertionError(f"bilinear rows {rows}, want [11, 15]")
    sd = load_checkpoint(smoke_weights())[1]
    res, (e32, e16, _) = run_family("pspv5s bilinear", frame, timing=False,
                                    make=functools.partial(Engine, spec=spec, state_dict=sd))
    near = Engine(spec=load_spec(CFG), state_dict=sd, device=DEVICE, half=False)
    x = frame[None]
    near(x, ORIG_HW, conf=CONF)                 # the geometry's first call
    _, want, _, _ = hold_recorded(near, x, "pspv5s nearest bs1 fp32", F32_REL)
    res.update(errs={}, launches={})
    counted = []
    for name, eng, bound in (("fp32", e32, F32_REL), ("bf16", e16, BF16_REL)):
        _, launches, _, res["errs"][name] = hold_recorded(eng, x, f"pspv5s bilinear bs1 {name}",
                                                          bound)
        want_launches(f"pspv5s bilinear bs1 {name} (the nearest model's: {want})", launches,
                      want)
        counted.append(launches)
        res["launches"][name] = launches
    xt = torch.from_numpy(x).to(DEVICE)
    res["seg_vs_nearest"] = diffs(e32.forward(xt)[1], near.forward(xt)[1])[0]
    log(f"  bilinear vs nearest seg logits max|diff| {res['seg_vs_nearest']:.3e}")
    if not res["seg_vs_nearest"] > 0:
        raise AssertionError("the bilinear model's seg logits equal the nearest model's")
    res["s"] = PHASE_S["[16] bilinear"] = time.perf_counter() - t0
    log(f"  pspv5s bilinear: {res['dets']} detections (fp32); {res['s']:.1f} s")
    return res, counted

# [17] the host tools on a seeded tree (no PIL, no cv2 on the card's
# machine), and seg_confusion_device on the card against SegMetric at a
# bs2 19-class full frame
TOOLS_HW = (256, 512)
CONFUSION_SHAPE = (2, 19, 1024, 2048)


def phase_tools(card: str):
    """[17] tools/cityscapes2yolo.py and the five subcommands of
    tools/labelme_convert.py on a seeded tree, the extra augmentations
    (load_mosaic9 on cityscapes2yolo's output, replicate, cutout,
    hist_equalize), prune_params / sparsity on pspv5s's weights and wh_iou;
    then utils/metrics.seg_confusion_device on the card against the host
    SegMetric counts, with both times."""
    import base64
    import random
    from multiyolov5_tpu_torch.data import draw, jpeg, png
    from multiyolov5_tpu_torch.data.detection import (DetectionDataset, cutout, hist_equalize,
                                                      replicate)
    from multiyolov5_tpu_torch.data.hyps import load_hyp
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.tools import cityscapes2yolo, labelme_convert
    from multiyolov5_tpu_torch.utils.boxes import wh_iou
    from multiyolov5_tpu_torch.utils.general import prune_params, sparsity
    from multiyolov5_tpu_torch.utils.metrics import SegMetric, seg_confusion_device
    log(f"[17] host tools on a seeded tree at {TOOLS_HW}; seg_confusion_device at "
        f"{CONFUSION_SHAPE}")
    work = os.path.join(ROOT, "build", "chip_smoke_tools")
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.RandomState(SEED + 71)
    h, w = TOOLS_HW
    res = {"card": card}
    t0 = time.perf_counter()

    # cityscapes2yolo: 2 splits x 2 cities x 2 frames, polygons of detection
    # classes and others
    names = list(cityscapes2yolo.LABEL_MAP) + ["road", "sky"]
    want_lines, frames = {}, {}
    for split in ("train", "val"):
        for city in ("aachen", "bremen"):
            for d in ("leftImg8bit", "gtFine"):
                os.makedirs(os.path.join(work, "citys", d, split, city))
            for i in range(2):
                stem = f"{city}_{i:06d}_000019"
                frame = (rng.rand(h, w, 3) * 255).astype(np.uint8)
                path = os.path.join(work, "citys", "leftImg8bit", split, city,
                                    f"{stem}_leftImg8bit.png")
                png.imwrite(path, frame)
                frames[f"{split}/{stem}"] = open(path, "rb").read()
                objs = [{"label": names[rng.randint(len(names))],
                         "polygon": [[int(rng.randint(w)), int(rng.randint(h))]
                                     for _ in range(rng.randint(3, 8))]}
                        for _ in range(rng.randint(2, 7))]
                want_lines[f"{split}/{stem}"] = sum(o["label"] in cityscapes2yolo.LABEL_MAP
                                                    for o in objs)
                with open(os.path.join(work, "citys", "gtFine", split, city,
                                       f"{stem}_gtFine_polygons.json"), "w") as fh:
                    json.dump({"imgWidth": w, "imgHeight": h, "objects": objs}, fh)
    quiet(cityscapes2yolo.main, ["--root", os.path.join(work, "citys")])
    bad = 0
    for key, n in want_lines.items():
        split, stem = key.split("/")
        out = os.path.join(work, "citys", "labels", split, f"{stem}_leftImg8bit.txt")
        rows = [list(map(float, r.split())) for r in open(out).read().splitlines()]
        bad += int(len(rows) != n or any(not 0 <= r[0] < 10 or not all(0 <= v <= 1.01
                                                                      for v in r[3:])
                                          for r in rows))
        copied = os.path.join(work, "citys", "images", split, f"{stem}_leftImg8bit.png")
        bad += int(open(copied, "rb").read() != frames[key])
    lists = [open(os.path.join(work, "citys", f"yolo_{sp}.txt")).read().splitlines()
             for sp in ("train", "val")]
    bad += int([len(x) for x in lists] != [4, 4])
    check("[17] cityscapes2yolo: frames whose labels, copy or list are wrong", bad, 0)

    # labelme_convert: an embedded PNG and an imagePath, every shape type
    lm = os.path.join(work, "labelme")
    os.makedirs(lm)
    with open(os.path.join(work, "labels.txt"), "w") as fh:
        fh.write("__ignore__\n_background_\ncar\nperson\nroad\n")
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    png.imwrite(os.path.join(lm, "b.png"), img[..., ::-1])
    shapes = [{"label": "car", "points": [[20.5, 10], [200, 30], [120, 90], [230, 200],
                                          [30, 180]]},
              {"label": "person", "points": [[260, 20], [500, 240], [500, 20], [260, 240]]},
              {"label": "road", "points": [[-40, 200], [150, 300], [350, 230]]},
              {"label": "car", "points": [[480, 250], [300, 120]], "shape_type": "rectangle"},
              {"label": "person", "points": [[100, 100], [130, 120]], "shape_type": "circle"},
              {"label": "__ignore__", "points": [[0, 0], [60, 0], [30, 40]]}]
    for name, data in (("a", {"imageData": base64.b64encode(png.encode(img)).decode(),
                              "imagePath": "a.jpg"}),
                       ("b", {"imageData": None, "imagePath": "b.png"})):
        with open(os.path.join(lm, f"{name}.json"), "w") as fh:
            json.dump(dict(data, shapes=shapes), fh)
    labels = os.path.join(work, "labels.txt")
    quiet(labelme_convert.main, ["labelme2seg", lm, os.path.join(work, "seg"), "--labels",
                                 labels])
    quiet(labelme_convert.main, ["labelme2det", lm, os.path.join(work, "det"), "--labels",
                                 labels])
    want = np.zeros((h, w), np.int32)
    for sh in shapes:
        cid = {"car": 1, "person": 2, "road": 3}.get(sh["label"], -1)
        want[labelme_convert._shape_to_mask((h, w), sh["points"],
                                            sh.get("shape_type", "polygon"))] = cid
    want[want < 0] = 255
    bad = 0
    for name in ("a", "b"):
        mask = png.read_samples(os.path.join(work, "seg", "SegmentationClassPNG", f"{name}.png"))
        bad += int(not np.array_equal(mask, want))
        for folder in ("seg/JPEGImages", "det/images"):     # PIL's save of the source
            with open(os.path.join(work, folder, f"{name}.jpg"), "rb") as fh:
                bad += int(fh.read() != jpeg.encode(img, *JPEG_SETTINGS["pil"]))
        bad += int(len(open(os.path.join(work, "det", "labels", f"{name}.txt")).read()
                       .splitlines()) != 5)
    circle = draw.ellipse((h, w), [100 - 36.05551, 100 - 36.05551, 100 + 36.05551,
                                   100 + 36.05551])
    bad += int(not 3900 < circle.sum() < 4300)
    os.makedirs(os.path.join(work, "voc"))
    with open(os.path.join(work, "voc", "v.xml"), "w") as fh:
        fh.write("<annotation><size><width>512</width><height>256</height></size><object>"
                 "<name>car</name><bndbox><xmin>10</xmin><ymin>20</ymin><xmax>110</xmax>"
                 "<ymax>220</ymax></bndbox></object></annotation>")
    quiet(labelme_convert.main, ["voc2yolo", os.path.join(work, "voc"),
                                 os.path.join(work, "voc_out"), "--names", "car"])
    with open(os.path.join(work, "coco.json"), "w") as fh:
        json.dump({"categories": [{"id": 3}], "images": [{"id": 1, "file_name": "c.png",
                                                         "width": 512, "height": 256}],
                   "annotations": [{"image_id": 1, "category_id": 3,
                                    "bbox": [10, 20, 100, 200]}]}, fh)
    quiet(labelme_convert.main, ["coco2yolo", os.path.join(work, "coco.json"),
                                 os.path.join(work, "coco_out")])
    os.makedirs(os.path.join(work, "kitti"))
    with open(os.path.join(work, "kitti", "b.txt"), "w") as fh:
        fh.write("Car 0 0 0 10 20 110 220 1 1 1 1 1 1 1\n")
    quiet(labelme_convert.main, ["kitti2yolo", os.path.join(work, "kitti"),
                                 os.path.join(work, "kitti_out"), "--names", "Car",
                                 "--img-dir", lm])
    line = "0 0.11719 0.46875 0.19531 0.78125"
    for out in ("voc_out/v.txt", "coco_out/c.txt", "kitti_out/b.txt"):
        got = [float(v) for v in open(os.path.join(work, out)).read().split()]
        bad += int(not np.allclose(got, [float(v) for v in line.split()], atol=1e-5))
    check("[17] labelme_convert: masks, images, labels or box lines that are wrong", bad, 0)

    # the extra augmentations on cityscapes2yolo's output, prune_params, wh_iou
    ds = quiet(DetectionDataset, os.path.join(work, "citys", "images", "train"), img_size=256,
               batch_size=2, augment=True, hyp=load_hyp("scratch"))
    img9, lab9 = ds.load_mosaic9(0, random.Random(SEED))
    frame = png.imread(os.path.join(work, "citys", "images", "train",
                                    "aachen_000000_000019_leftImg8bit.png"))
    boxes = np.array([[0, 10, 20, 80, 90], [1, 200, 40, 260, 200]], np.float32)
    img_r, lab_r = replicate(frame.copy(), boxes.copy(), random.Random(SEED))
    lab_c = cutout(img_r, lab_r.copy(), random.Random(SEED))
    eq = [hist_equalize(frame, clahe=c, bgr=True) for c in (True, False)]
    sd = seeded_state_dict(load_spec(CFG), SEED)
    pruned = quiet(prune_params, sd, 0.3)
    convs = {k: v for k, v in pruned.items() if k.endswith(".weight") and v.ndim == 4}
    sp = sparsity(convs)
    iou = wh_iou(torch.tensor([[10.0, 13], [33, 23]]), torch.tensor([[10.0, 13], [16, 30]]))
    bad = int(img9.shape != (256, 256, 3)) + int(lab9.shape[1] != 5) + int(len(lab_r) != 3)
    bad += int(len(lab_c) > 3) + sum(int(e.shape != frame.shape or e.dtype != np.uint8)
                                     for e in eq)
    bad += int(abs(iou[0, 0].item() - 1) > 1e-6) + int(not 0.29 < sp < 0.31)
    check("[17] load_mosaic9, replicate, cutout, hist_equalize, prune_params, wh_iou: "
          "results of the wrong shape or value", bad, 0)
    res["tools_s"] = time.perf_counter() - t0
    res["pruned_conv_sparsity"] = sp
    log(f"  the tools ran in {res['tools_s']:.2f} s (host); pruned conv sparsity {sp:.4f}")

    # seg_confusion_device on the card against SegMetric's host histograms
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    b, c, hh, ww = CONFUSION_SHAPE
    logits = torch.randn(CONFUSION_SHAPE, generator=gen, device=DEVICE)
    target = torch.randint(-1, c, (b, hh, ww), generator=gen, device=DEVICE)
    inter, union = seg_confusion_device(logits, target, c)
    pred, tgt = logits.argmax(1).cpu().numpy(), target.cpu().numpy()
    m = SegMetric(c)
    m.update(pred, tgt)
    bad = int(not np.array_equal(inter.cpu().numpy(), m.total_inter)) + \
        int(not np.array_equal(union.cpu().numpy(), m.total_union))
    check("[17] seg_confusion_device on the card: counts unequal to SegMetric's", bad, 0,
          ok=bad == 0 and inter.device.type == DEVICE)
    dev_ms = cuda_ms(lambda: seg_confusion_device(logits, target, c), iters=5, warmup=1) \
        if DEVICE == "cuda" else float("nan")

    def host():
        SegMetric(c).update(pred, tgt)

    res["confusion"] = {"shape": CONFUSION_SHAPE, "device_ms": dev_ms,
                        "segmetric_host_ms": host_ms(host, reps=1)}
    log(f"  on {card}: seg_confusion_device {dev_ms:.3f} ms (logits on the card), host "
        f"SegMetric {res['confusion']['segmetric_host_ms']:.1f} ms on the argmax already "
        f"on the host")
    shutil.rmtree(work, ignore_errors=True)
    return res


# [18] JPEG: the port's codec (data/jpeg.py, csrc/host/jpeg.cpp) against
# libjpeg-turbo's bytes and pixels (SHA-256s taken with cv2 and PIL, which
# tests/test_torch_jpeg.py holds them to: the card's machine need not have
# either), the detect app and the eval CLI on JPEG inputs against the same
# CLIs on PNG copies of the port's decodes, the citysbdd training loader on
# BDD-style .jpg frames, and the codec's host times
JPEG_HW = ((1024, 2048), (720, 1280))
JPEG_SETTINGS = {"cv2": (95, "4:2:0"), "pil": (75, "4:2:0")}   # their defaults
JPEG_DIGESTS = {    # (encoded bytes, RGB decode of those bytes)
    ("cv2", 1024, 2048): ("278b33f7a033dcc1527d08d8b5c1fc08b1d0f05de6153a33f7f134e778840348",
                          "23595b608cc932f54fb96cd6fa635d5b8756b5c9d3ef53c52d9b785dda66939c"),
    ("pil", 1024, 2048): ("bbba28671c53e9ac65ec4004063125bc94afff4503327bc2ee0a0e6183eac468",
                          "a8d1c65deed5bfb153d435d1fce70e2a02f7d3a0c6aacc409ddd0f9bd13d3f47"),
    ("cv2", 720, 1280): ("fdfdb0e8c9f5df28a5a3d87db1cb0a3d1b9a30759722925759dc2c241b1a14af",
                         "390d2ebbc140e21d9fe303eb24918935dca8753d955329d61be5568fee0e6383"),
    ("pil", 720, 1280): ("e0e85ee631119dc439c432f59edb0f473e05821203a6d324ab19596eeb56cb99",
                         "c02207da12229a6e03d01062eb6f0c42d3c6edd8d4a82fab2dadabb3695ba0c4"),
}
JPEG_DET_FRAMES, JPEG_BDD_HW = 4, (720, 1280)


def jpeg_frame(h: int, w: int, seed: int = SEED + 90) -> np.ndarray:
    """A seeded (h, w, 3) RGB frame from integer arithmetic only (ramps and
    uniform noise), so that every numpy gives the same bytes."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx // 4 + yy // 2, (yy // 3) * 2 + xx // 8, (xx + 3 * yy) // 7], -1)
    return ((base + rng.randint(0, 24, (h, w, 3))) % 256).astype(np.uint8)


def with_exif(data: bytes, orientation: int) -> bytes:
    """JPEG bytes with an APP1 Exif segment (IFD0 orientation) after SOI."""
    tiff = b"II*\x00" + np.array([8], "<u4").tobytes() + np.array([1], "<u2").tobytes()
    tiff += np.array([0x0112, 3], "<u2").tobytes() + np.array([1], "<u4").tobytes()
    tiff += np.array([orientation, 0], "<u2").tobytes() + b"\x00" * 4
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big") + body + data[2:]


def jpeg_digests() -> dict:
    """[18] (a) and (d): the port's encoder at cv2's and PIL's defaults and
    its decoder on those bytes, each against its SHA-256 constant, with
    their host ms on this thread (one call each); cv2's and PIL's own
    times beside, one call each, where they import (used nowhere in the
    port)."""
    import hashlib

    from multiyolov5_tpu_torch.data import jpeg
    t0 = time.perf_counter()
    jpeg.library()                      # g++ builds the host part here, before any timing
    out = {"build_s": time.perf_counter() - t0}
    log(f"  the codec's host library ready in {out['build_s']:.1f} s (g++ at first use)")
    try:        # PIL's first decode loads its plugins: done here, outside the one-call timings
        from PIL import Image
        Image.open(io.BytesIO(jpeg.encode(np.zeros((8, 8, 3), np.uint8)))).convert("RGB")
    except ImportError:
        pass
    for (h, w) in JPEG_HW:
        rgb = jpeg_frame(h, w)
        for who, (q, sub) in JPEG_SETTINGS.items():
            t0 = time.perf_counter()
            data = jpeg.encode(rgb, q, sub)
            t1 = time.perf_counter()
            dec = jpeg.decode_rgb(data)
            t2 = time.perf_counter()
            enc_want, dec_want = JPEG_DIGESTS[(who, h, w)]
            if hashlib.sha256(data).hexdigest() != enc_want:
                raise AssertionError(f"[18] JPEG encode at {who}'s defaults {h}x{w}: its "
                                     "SHA-256 is not libjpeg-turbo's")
            if hashlib.sha256(np.ascontiguousarray(dec).tobytes()).hexdigest() != dec_want:
                raise AssertionError(f"[18] JPEG decode of {who}'s {h}x{w} bytes: its SHA-256 "
                                     "is not libjpeg-turbo's")
            out[f"{who}_{h}x{w}"] = {"bytes": len(data), "encode_ms": (t1 - t0) * 1e3,
                                     "decode_ms": (t2 - t1) * 1e3}
            lib = {}
            try:
                import cv2
                bgr = np.ascontiguousarray(rgb[..., ::-1])
                arr = np.frombuffer(data, np.uint8)
                if who == "cv2":
                    lib["cv2_encode_ms"] = host_ms(lambda: cv2.imencode(".jpg", bgr), reps=1)
                lib["cv2_decode_ms"] = host_ms(lambda: cv2.imdecode(arr, cv2.IMREAD_COLOR),
                                               reps=1)
            except ImportError:
                lib["cv2"] = "does not import"
            try:
                from PIL import Image
                im = Image.fromarray(rgb)
                if who == "pil":
                    lib["pil_encode_ms"] = host_ms(lambda: im.save(io.BytesIO(), "JPEG"), reps=1)
                lib["pil_decode_ms"] = host_ms(
                    lambda: Image.open(io.BytesIO(data)).convert("RGB").load(), reps=1)
            except ImportError:
                lib["PIL"] = "does not import"
            out[f"{who}_{h}x{w}"].update(lib)
            log(f"  (a) {who} defaults q{q} {sub} {h}x{w}: {len(data)} bytes, encode and decode "
                f"SHA-256 equal libjpeg-turbo's; (d) host ms encode "
                f"{out[f'{who}_{h}x{w}']['encode_ms']:.1f}, decode "
                f"{out[f'{who}_{h}x{w}']['decode_ms']:.1f}; libraries: "
                + ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                            for k, v in lib.items()))
    return out


def jpeg_app(weights: str, work: str) -> dict:
    """[18] (b): cli.detect on two JPEG frames (PIL's defaults, and cv2's
    with EXIF orientation 6) against the same app on PNG copies of the
    port's decoded, turned frames: equal txt lines, and each JPEG artifact
    the bytes cv2.imwrite would give the PNG run's artifact."""
    from multiyolov5_tpu_torch.data import images, jpeg, png
    from multiyolov5_tpu_torch.ops import kernels as K
    src, copies = os.path.join(work, "app_jpg"), os.path.join(work, "app_png")
    os.makedirs(src)
    os.makedirs(copies)
    for i, (who, o) in enumerate((("pil", 0), ("cv2", 6))):
        rgb = jpeg_frame(*ORIG_HW, seed=SEED + 91 + i)
        data = with_exif(jpeg.encode(rgb, *JPEG_SETTINGS[who]), o) if o else \
            jpeg.encode(rgb, *JPEG_SETTINGS[who])
        path = os.path.join(src, f"frame{i}.jpg")
        with open(path, "wb") as fh:
            fh.write(data)
        png.imwrite(os.path.join(copies, f"frame{i}.png"), images.imread(path))
    n = 2
    runs = {}
    for tag, d in (("jpg", src), ("png", copies)):
        argv = ["--weights", weights, "--source", d, "--img-size", str(APP_IMG), "--save-txt",
                "--save-conf", "--project", work, "--name", f"out_{tag}", "--exist-ok",
                "--device", "" if DEVICE == "cuda" else DEVICE]
        K.reset_launches()
        out, loop_s = run_app(argv)
        torch.cuda.synchronize()
        runs[tag] = (out, K.launch_counts(), loop_s)
    launches = runs["jpg"][1]
    want = {"stem": n, "stem_float": 0, "conv3x3": 10 * n, "nms": n, "upsample_argmax": n,
            "nms_greedy": 0, "c3": 0}
    if {k: launches[k] for k in want} != want or runs["png"][1] != launches:
        raise AssertionError(f"[18] app launches on JPEG {launches}, on PNG {runs['png'][1]}, "
                             f"want {want} on both")
    jo, po = runs["jpg"][0], runs["png"][0]
    for i in range(n):
        stem = f"frame{i}"
        with open(os.path.join(jo, "labels", f"{stem}.txt")) as a, \
                open(os.path.join(po, "labels", f"{stem}.txt")) as b:
            if a.read() != b.read():
                raise AssertionError(f"[18] app: labels/{stem}.txt differs between JPEG and PNG")
        for art in ("", "_mask", "_dst"):
            got = open(os.path.join(jo, f"{stem}{art}.jpg"), "rb").read()
            want_bytes = jpeg.encode(png.imread(os.path.join(po, f"{stem}{art}.png"))[..., ::-1],
                                     *JPEG_SETTINGS["cv2"])
            if got != want_bytes:
                raise AssertionError(f"[18] app: {stem}{art}.jpg is not cv2.imwrite of the PNG "
                                     f"run's {stem}{art}.png")
    turned = images.imread(os.path.join(src, "frame1.jpg")).shape
    if turned[:2] != ORIG_HW[::-1]:
        raise AssertionError(f"[18] the EXIF-6 frame reads as {turned}, not turned")
    log(f"  (b) cli.detect on {n} JPEG {ORIG_HW} frames (one EXIF 6 -> {turned[:2]}): txt, "
        f"image, _mask and _dst equal the PNG copies' run; launches {launches}; app ms/frame "
        f"JPEG {runs['jpg'][2] * 1e3 / n:.1f}, PNG {runs['png'][2] * 1e3 / n:.1f}")
    return {"launches": launches, "ms_per_frame_jpg": runs["jpg"][2] * 1e3 / n,
            "ms_per_frame_png": runs["png"][2] * 1e3 / n}


def jpeg_eval(eng32, weights: str, work: str) -> dict:
    """[18] (c): cli.test (fp32) on a JPEG detection split (one frame with
    EXIF 6) and a citysbdd seg split (Cityscapes .png frames with labelIds,
    BDD .jpg frames with trainIds), against the same CLI on PNG copies of
    the port's decodes (BDD masks as labelIds); then the citysbdd training
    loader's first batch."""
    from multiyolov5_tpu_torch.data import images, jpeg, png
    from multiyolov5_tpu_torch.data.cityscapes import CITYSCAPES_IDMAP
    from multiyolov5_tpu_torch.data.segmentation import get_citysbdd_loader
    from multiyolov5_tpu_torch.ops import kernels as K
    rng = np.random.RandomState(SEED + 95)
    trees = {}
    for tag in ("jpg", "png"):
        root = os.path.join(work, f"eval_{tag}")
        trees[tag] = root
        for d in ("det/images/val", "det/labels/val"):
            os.makedirs(os.path.join(root, d))
    jdet = os.path.join(trees["jpg"], "det", "images", "val")
    for i in range(JPEG_DET_FRAMES + 1):    # noise, as [11]'s, so its labelling gives a mAP
        data = jpeg.encode(rng.randint(0, 256, (*ORIG_HW, 3)).astype(np.uint8),
                           *JPEG_SETTINGS["cv2"])
        path = os.path.join(jdet, f"munich_{i:06d}.jpg")
        with open(path, "wb") as fh:
            fh.write(with_exif(data, 6) if i == JPEG_DET_FRAMES else data)
    label_split(eng32, jdet, os.path.join(trees["jpg"], "det", "labels", "val"), rng, CLI_IMG,
                JPEG_DET_FRAMES)
    for f in sorted(os.listdir(jdet)):
        stem = f[:-4]
        png.imwrite(os.path.join(trees["png"], "det", "images", "val", stem + ".png"),
                    images.imread(os.path.join(jdet, f)))
        shutil.copy(os.path.join(trees["jpg"], "det", "labels", "val", stem + ".txt"),
                    os.path.join(trees["png"], "det", "labels", "val", stem + ".txt"))
    for split, n in (("val", 4), ("train", 2)):
        for i in range(n):
            bdd = i % 2 == 1
            city = "bdd" if bdd else "munich"
            stem = f"{city}_{i:06d}_000019"
            hw = JPEG_BDD_HW if bdd else ORIG_HW
            rgb = jpeg_frame(*hw, seed=SEED + 110 + i)
            train_ids = rng.randint(0, 19, hw).astype(np.uint8)
            train_ids[rng.rand(*hw) < 0.1] = 255
            label_ids = np.where(train_ids == 255, 255,
                                 CITYSCAPES_IDMAP[train_ids % 255]).astype(np.uint8)
            for tag in ("jpg", "png") if split == "val" else ("jpg",):
                idir = os.path.join(trees[tag], "citys", "leftImg8bit", split, city)
                mdir = os.path.join(trees[tag], "citys", "gtFine", split, city)
                os.makedirs(idir, exist_ok=True)
                os.makedirs(mdir, exist_ok=True)
                ipath = os.path.join(idir, f"{stem}_leftImg8bit")
                mpath = os.path.join(mdir, f"{stem}_gtFine_labelIds.png")
                if tag == "jpg" and bdd:       # BDD: a .jpg frame, its mask trainIds
                    jpeg.pil_save(ipath + ".jpg", rgb)
                    png.imwrite(mpath, train_ids)
                elif tag == "png" and bdd:     # its PNG copy: the port's decode, labelIds
                    decoded = images.read_rgb(os.path.join(
                        trees["jpg"], "citys", "leftImg8bit", split, city,
                        f"{stem}_leftImg8bit.jpg"))
                    png.imwrite(ipath + ".png", decoded[..., ::-1])
                    png.imwrite(mpath, label_ids)
                else:
                    png.imwrite(ipath + ".png", rgb[..., ::-1])
                    png.imwrite(mpath, label_ids)
    res = {}
    for tag in ("jpg", "png"):
        data = os.path.join(trees[tag], "data.json")
        with open(data, "w") as fh:
            json.dump({"val": os.path.join(trees[tag], "det", "images", "val"),
                       "segval": os.path.join(trees[tag], "citys"), "nc": eng32.spec.nc,
                       "names": eng32.names}, fh)
        argv = ["--weights", weights, "--data", data, "--img-size", str(CLI_IMG), "--base-size",
                str(CLI_IMG), "--batch-size", str(JPEG_DET_FRAMES), "--seg-data-kind",
                "citysbdd", "--device", "" if DEVICE == "cuda" else DEVICE]
        K.reset_launches()
        metrics, _, _, spent, count, wall = run_cli(argv, kernels=False)
        torch.cuda.synchronize()
        res[tag] = {"metrics": metrics, "launches": K.launch_counts(), "cli_s": wall,
                    "loader_det_host_ms_per_image": spent["det"] * 1e3 / max(count["det"], 1)}
    for k in ("stem", "stem_float", "conv3x3", "c3", "nms_greedy", "upsample_argmax"):
        if res["jpg"]["launches"][k] <= 0:
            raise AssertionError(f"[18] kernel {k} was not launched on the JPEG eval CLI's path")
    if res["jpg"]["launches"] != res["png"]["launches"]:
        raise AssertionError(f"[18] eval launches on JPEG {res['jpg']['launches']}, on PNG "
                             f"{res['png']['launches']}")
    for k in ("P", "R", "mAP50", "mAP", "pixAcc", "mIoU"):
        check(f"[18] eval CLI on JPEG vs on its PNG copies: {k} |diff|",
              abs(res["jpg"]["metrics"][k] - res["png"]["metrics"][k]), 0)
    if not 0.05 < res["jpg"]["metrics"]["mAP50"] < 0.95:     # as [11]'s labels give
        raise AssertionError(f"[18] degenerate detection metrics: {res['jpg']['metrics']}")
    loader = get_citysbdd_loader(root=os.path.join(trees["jpg"], "citys"), split="train",
                                 mode="train", batch_size=2, workers=2)
    imgs, masks = next(iter(loader))
    if imgs.shape != (2, 512, 1024, 3) or masks.shape != (2, 512, 1024) or \
            not (masks == -1).any() or masks.max() > 18:
        raise AssertionError(f"[18] citysbdd train batch {imgs.shape} {masks.shape}")
    log(f"  (c) cli.test on {JPEG_DET_FRAMES + 1} JPEG detection frames (one EXIF 6) and a "
        f"citysbdd split (2 BDD .jpg {JPEG_BDD_HW}, 2 Cityscapes .png): metrics equal the "
        f"PNG copies' {res['jpg']['metrics']}; launches {res['jpg']['launches']}; detection "
        f"loader host ms an image JPEG {res['jpg']['loader_det_host_ms_per_image']:.1f}, PNG "
        f"{res['png']['loader_det_host_ms_per_image']:.1f}; the citysbdd training loader "
        f"gave {tuple(imgs.shape)} images, {tuple(masks.shape)} trainId masks")
    return res


def phase_jpeg(eng32, card: str):
    """[18] the JPEG codec and its callers: (a) digests, (b) the detect app,
    (c) the eval CLI and the citysbdd training loader, (d) host times."""
    log(f"[18] JPEG: the port's codec against libjpeg-turbo's digests at {JPEG_HW}, "
        f"cli.detect and cli.test on JPEG inputs against PNG copies, the citysbdd loader")
    work = os.path.join(ROOT, "build", "chip_smoke_jpeg")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    res = {"card": card, "codec": jpeg_digests()}
    weights = smoke_weights()
    res["app"] = jpeg_app(weights, work)
    res["eval"] = jpeg_eval(eng32, weights, work)
    shutil.rmtree(work, ignore_errors=True)
    return res


# [19] the other still-image forms: every PNG form, BMP, MPO and baseline
# TIFF (data/png.py, bmp.py, tiff.py, jpeg.py; csrc/host/codecs.cpp) against
# SHA-256s of cv2's and PIL's decodes of seeded files (taken with both
# libraries in tests/test_torch_image_callers.py: the card's machine need
# not have either), the detect app and the eval CLI on those forms against
# the same CLIs on PNG copies of the port's decodes, and the decoders' times
FORM_HW = ORIG_HW
FORM_DIGESTS = {       # file -> SHA-256s of cv2's, PIL's RGB and PIL's sample arrays
    "adam7_rgb16.png": {
        "cv2": "ad7472ddd5e9a9fef255b245379a5072483deff1a7acb3206e77d863e8bd5414",
        "rgb": "06f4ae9a80558738dced431445fee47e269696d5a07c68633c266acfa8ef1030",
        "samples": "06f4ae9a80558738dced431445fee47e269696d5a07c68633c266acfa8ef1030"},
    "gray16.png": {
        "cv2": "85451448178a0eb724f27e48065bd491ec6f083ece037934de646e79e698ecdc",
        "rgb": "9274162fa727196395681beaa4c313ab67744fb637eb53a5f0dc3ccb925c38c1",
        "samples": "e9c9f0c09fc1828862ffcbf57ffa3d4a9d962b2d747b5a9bbea511bd626a61fa"},
    "palette4.png": {
        "cv2": "5bee4192436b4d1e6bf3a5262c925f22748f931c239900025abc5af79861bf0d",
        "rgb": "96ddc076355b0777faa4453bb8b98722af785e1eeff70ed6261e486370c0c96a",
        "samples": "1f7b328b017c57cc8cf22dfe3c70ab75dca164c2f9749f49151feb81a0555266"},
    "exif6.png": {
        "cv2": "5fe5116fc2d3381cc7854326511be7496dda1e596bacb05a1fb17f41a0dd63ab",
        "rgb": "06caa147c2e57ef63a328fecb0c0cb1ce304c16877f21eefd3dab85a4deccab8",
        "samples": "06caa147c2e57ef63a328fecb0c0cb1ce304c16877f21eefd3dab85a4deccab8"},
    "rgb24.bmp": {
        "cv2": "42953f9216e279dff79766055f116ef5219e75911a07fdbfb8e86f9f8677ece6",
        "rgb": "06caa147c2e57ef63a328fecb0c0cb1ce304c16877f21eefd3dab85a4deccab8",
        "samples": "06caa147c2e57ef63a328fecb0c0cb1ce304c16877f21eefd3dab85a4deccab8"},
    "rle8.bmp": {
        "cv2": "d4d7d188dddde362c54ae885f24c20377d76b11b14a7329955ac5658a502ddfc",
        "rgb": "0a793e62ab438b593ff63d7e48d0b8aaaa9a992fee7db5e7e750a84450287d44",
        "samples": "c2b72c6639d416fe9be471b44997096fbc8f22e44998095b8164f153d1fc6dfd"},
    "two_frames.mpo": {
        "cv2": "ff44fe06cbda210b29a96f969f320463378f8fb647d1c40feb626d65ff224d93",
        "rgb": "c8f89da0553161b83d6c3aea72685c72118dfb005024cdbece58dfbc9bb275bf",
        "samples": "c8f89da0553161b83d6c3aea72685c72118dfb005024cdbece58dfbc9bb275bf"},
    "lzw_pred2.tif": {
        "cv2": "42953f9216e279dff79766055f116ef5219e75911a07fdbfb8e86f9f8677ece6",
        "rgb": "06caa147c2e57ef63a328fecb0c0cb1ce304c16877f21eefd3dab85a4deccab8",
        "samples": "06caa147c2e57ef63a328fecb0c0cb1ce304c16877f21eefd3dab85a4deccab8"},
    "deflate_tiles.tif": {
        "cv2": "42953f9216e279dff79766055f116ef5219e75911a07fdbfb8e86f9f8677ece6",
        "rgb": "06caa147c2e57ef63a328fecb0c0cb1ce304c16877f21eefd3dab85a4deccab8",
        "samples": "06caa147c2e57ef63a328fecb0c0cb1ce304c16877f21eefd3dab85a4deccab8"},
}
# cv2.imencode(".bmp") of form_frame's BGR
BMP_WRITE_DIGEST = "9f4a937361070c3a2d72708fd6654e663628419500c5b002b94858549bd05674"
FORM_DET_FRAMES = 4


def form_frame(h: int, w: int, seed: int = SEED + 120) -> np.ndarray:
    """A seeded (h, w, 3) RGB frame of integer ramps in runs (what RLE and
    LZW find), a quarter of its rows noisy."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    px = np.stack([xx // 16 + yy // 8, (yy // 12) * 3 + xx // 32, (xx + 3 * yy) // 28], -1) * 4
    noisy = rng.rand(h, 1, 1) < 0.25
    return ((px + noisy * rng.randint(0, 24, (h, w, 3))) % 256).astype(np.uint8)


def _writers():
    """tests/_torch_image_writers.py (numpy, zlib and struct only)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import _torch_image_writers
    return _torch_image_writers


def image_form_files() -> dict:
    """[19]'s nine seeded files at FORM_HW: name -> bytes."""
    from multiyolov5_tpu_torch.data import jpeg, tiff
    W = _writers()
    h, w = FORM_HW
    rgb = form_frame(h, w)
    rng = np.random.RandomState(SEED + 121)
    idx4 = ((rgb[..., 0] // 16 + rgb[..., 2] // 32) % 16).astype(np.uint8)
    idx8 = (rgb[..., 1] // 2).astype(np.uint8)
    pal = rng.randint(0, 256, (256, 3))
    deep = rgb.astype(np.uint16) * 257 + rng.randint(0, 256, rgb.shape).astype(np.uint16) % 251
    return {
        "adam7_rgb16.png": W.png(deep[..., ::-1], 16, 2, interlace=True, filters=(0, 1, 2)),
        "gray16.png": W.png(deep[..., 1], 16, 0, filters=(3, 4, 2)),
        "palette4.png": W.png(idx4, 4, 3, filters=(1, 4), palette=pal[:16]),
        "exif6.png": W.png(rgb, 8, 2, filters=(4,), before=[(b"eXIf", W.exif_tiff(6))]),
        "rgb24.bmp": W.bmp(rgb[..., ::-1], 24),
        "rle8.bmp": W.bmp(None, 8, palette=pal, compression=1, rle=W.rle8(idx8), size=(w, h)),
        "two_frames.mpo": W.mpo([jpeg.encode(rgb, 95), jpeg.encode(rgb[::-1, ::-1], 75)]),
        "lzw_pred2.tif": tiff.encode(rgb[..., ::-1]),
        "deflate_tiles.tif": W.tiff(rgb, 8, 2, ">", 8, 2, tile=(256, 256)),
    }


def form_digests(work: str) -> dict:
    """[19] (a) and (d): each file's three reads by the port against the
    SHA-256s of cv2's and PIL's, the BMP writer's bytes against cv2's, and
    each read's host ms (one call) beside cv2's and PIL's where they
    import (used nowhere in the port)."""
    import hashlib

    from multiyolov5_tpu_torch.data import bmp, host_codecs, images
    t0 = time.perf_counter()
    host_codecs.library()               # g++ builds the host part here, before any timing
    out = {"build_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    files = image_form_files()
    out["write_s"] = time.perf_counter() - t0
    log(f"  the host library ready in {out['build_s']:.1f} s; {len(files)} seeded "
        f"{FORM_HW[1]}x{FORM_HW[0]} files written in {out['write_s']:.1f} s")
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731
    for name, data in files.items():
        path = os.path.join(work, name)
        with open(path, "wb") as fh:
            fh.write(data)
        t0 = time.perf_counter()
        got = {"cv2": images.imread(path)}
        t1 = time.perf_counter()
        got["rgb"] = images.read_rgb(path)
        t2 = time.perf_counter()
        got["samples"] = images.read_samples(path)
        for k, v in got.items():
            if sha(v) != FORM_DIGESTS[name][k]:
                raise AssertionError(f"[19] {name}: the port's {k} read (shape {v.shape}, "
                                     f"{v.dtype}) is not the library's")
        rec = {"bytes": len(data), "imread_ms": (t1 - t0) * 1e3, "read_rgb_ms": (t2 - t1) * 1e3}
        try:
            import cv2
            rec["cv2_imread_ms"] = host_ms(lambda: cv2.imread(path), reps=1)
        except ImportError:
            rec["cv2"] = "does not import"
        try:
            from PIL import Image
            rec["pil_convert_ms"] = host_ms(lambda: Image.open(path).convert("RGB"), reps=1)
        except ImportError:
            rec["PIL"] = "does not import"
        out[name] = rec
        log(f"  (a) {name}: {len(data)} bytes, imread {got['cv2'].shape}, read_samples "
            f"{got['samples'].shape} {got['samples'].dtype}: SHA-256 equal cv2's and PIL's; "
            "(d) host ms " + ", ".join(f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
                                       for k, v in rec.items() if k != "bytes"))
    bgr = np.ascontiguousarray(form_frame(*FORM_HW)[..., ::-1])
    t0 = time.perf_counter()
    written = bmp.encode(bgr)
    out["bmp_write_ms"] = (time.perf_counter() - t0) * 1e3
    if hashlib.sha256(written).hexdigest() != BMP_WRITE_DIGEST:
        raise AssertionError("[19] the BMP writer's bytes are not cv2.imwrite's")
    log(f"  (a) bmp.encode of the frame: cv2.imwrite's bytes, {out['bmp_write_ms']:.1f} ms")
    return out


def forms_app(weights: str, work: str) -> dict:
    """[19] (b): cli.detect on a BMP, an Adam7 16-bit PNG, an eXIf-6 PNG and
    an LZW TIFF against the same app on PNG copies of the port's decoded,
    turned frames: equal txt lines, equal PNG artifacts, each ``.bmp``
    artifact the bytes cv2 would write of the PNG run's pixels, each
    ``.tif`` decoding to them; then an MPO source, whose first save raises
    (cv2 has no MPO writer), and with ``--nosave --save-txt`` the txt of
    its PNG copy."""
    from multiyolov5_tpu_torch.data import bmp, images, jpeg, png, tiff
    from multiyolov5_tpu_torch.ops import kernels as K
    W = _writers()
    src, copies = os.path.join(work, "app_src"), os.path.join(work, "app_png")
    os.makedirs(src)
    os.makedirs(copies)
    frames = [form_frame(*ORIG_HW, seed=SEED + 130 + i) for i in range(5)]
    files = {"f0.bmp": W.bmp(frames[0][..., ::-1], 24),
             "f1.png": W.png(frames[1].astype(np.uint16) * 257, 16, 2, interlace=True,
                             filters=(1, 2)),
             "f2.png": W.png(frames[2], 8, 2, filters=(2,), before=[(b"eXIf", W.exif_tiff(6))]),
             "f3.tif": tiff.encode(frames[3][..., ::-1])}
    for name, data in files.items():
        with open(os.path.join(src, name), "wb") as fh:
            fh.write(data)
        png.imwrite(os.path.join(copies, name.rsplit(".", 1)[0] + ".png"),
                    images.imread(os.path.join(src, name)))
    n = len(files)
    runs = {}
    for tag, d in (("forms", src), ("png", copies)):
        argv = ["--weights", weights, "--source", d, "--img-size", str(APP_IMG), "--save-txt",
                "--save-conf", "--project", work, "--name", f"out_{tag}", "--exist-ok",
                "--device", "" if DEVICE == "cuda" else DEVICE]
        K.reset_launches()
        out, loop_s = run_app(argv)
        torch.cuda.synchronize()
        runs[tag] = (out, K.launch_counts(), loop_s)
    launches = runs["forms"][1]
    want = {"stem": n, "stem_float": 0, "conv3x3": 10 * n, "nms": n, "upsample_argmax": n,
            "nms_greedy": 0, "c3": 0}
    if {k: launches[k] for k in want} != want or runs["png"][1] != launches:
        raise AssertionError(f"[19] app launches on the forms {launches}, on PNG "
                             f"{runs['png'][1]}, want {want} on both")
    fo, po = runs["forms"][0], runs["png"][0]
    for name in files:
        stem, ext = name.rsplit(".", 1)
        with open(os.path.join(fo, "labels", f"{stem}.txt")) as a, \
                open(os.path.join(po, "labels", f"{stem}.txt")) as b:
            if a.read() != b.read():
                raise AssertionError(f"[19] app: labels/{stem}.txt differs from the PNG copy's")
        for art in ("", "_mask", "_dst"):
            got_path = os.path.join(fo, f"{stem}{art}.{ext}")
            want_px = png.imread(os.path.join(po, f"{stem}{art}.png"))
            if ext == "bmp":
                ok = open(got_path, "rb").read() == bmp.encode(want_px)
            elif ext == "tif":
                ok = np.array_equal(tiff.imread(got_path), want_px) and \
                    open(got_path, "rb").read() == tiff.encode(want_px)
            else:
                ok = open(got_path, "rb").read() == open(
                    os.path.join(po, f"{stem}{art}.png"), "rb").read()
            if not ok:
                raise AssertionError(f"[19] app: {stem}{art}.{ext} is not cv2.imwrite of the "
                                     f"PNG run's {stem}{art}.png")
    turned = images.imread(os.path.join(src, "f2.png")).shape
    if turned[:2] != ORIG_HW[::-1]:
        raise AssertionError(f"[19] the eXIf-6 frame reads as {turned}, not turned")
    mdir, mcopy = os.path.join(work, "app_mpo"), os.path.join(work, "app_mpo_png")
    os.makedirs(mdir)
    os.makedirs(mcopy)
    with open(os.path.join(mdir, "m.mpo"), "wb") as fh:
        fh.write(W.mpo([jpeg.encode(frames[4], 95), jpeg.encode(frames[0], 75)]))
    png.imwrite(os.path.join(mcopy, "m.png"), images.imread(os.path.join(mdir, "m.mpo")))
    base = ["--weights", weights, "--img-size", str(APP_IMG), "--save-txt", "--save-conf",
            "--project", work, "--exist-ok", "--device", "" if DEVICE == "cuda" else DEVICE]
    try:
        run_app(base + ["--source", mdir, "--name", "out_mpo_save"])
        raise AssertionError("[19] app: saving an MPO source did not raise")
    except ValueError as e:
        if "could not find a writer" not in str(e):
            raise
    txt = []
    for tag, d in (("mpo", mdir), ("mpo_png", mcopy)):
        out, _ = run_app(base + ["--source", d, "--name", f"out_{tag}", "--nosave"])
        with open(os.path.join(out, "labels", "m.txt")) as fh:
            txt.append(fh.read())
    if txt[0] != txt[1] or not txt[0]:
        raise AssertionError("[19] app: the MPO's --nosave txt differs from its PNG copy's")
    log(f"  (b) cli.detect on {n} frames {ORIG_HW} (BMP, Adam7 16-bit PNG, eXIf-6 PNG -> "
        f"{turned[:2]}, LZW TIFF): txt, image, _mask and _dst equal the PNG copies' run "
        f"(.bmp bytes cv2's, .tif decoding to them); launches {launches}; app ms/frame forms "
        f"{runs['forms'][2] * 1e3 / n:.1f}, PNG {runs['png'][2] * 1e3 / n:.1f}; an MPO "
        "source raises at its first save, its --nosave txt equals its PNG copy's")
    return {"launches": launches, "ms_per_frame_forms": runs["forms"][2] * 1e3 / n,
            "ms_per_frame_png": runs["png"][2] * 1e3 / n}


def forms_eval(eng32, weights: str, work: str) -> dict:
    """[19] (c): cli.test (fp32) on a detection split of a BMP, an RLE8 BMP,
    an LZW TIFF, an MPO (EXIF 6) and an Adam7 16-bit PNG, and a Cityscapes
    split of Adam7 frames with 16-bit labelId masks, against the same CLI
    on PNG copies of the port's decodes (8-bit masks): metrics equal."""
    from multiyolov5_tpu_torch.data import images, jpeg, png, tiff
    from multiyolov5_tpu_torch.data.cityscapes import CITYSCAPES_IDMAP
    from multiyolov5_tpu_torch.ops import kernels as K
    W = _writers()
    rng = np.random.RandomState(SEED + 140)
    trees = {tag: os.path.join(work, f"eval_{tag}") for tag in ("forms", "png")}
    for root in trees.values():
        for d in ("det/images/val", "det/labels/val"):
            os.makedirs(os.path.join(root, d))
    fdet = os.path.join(trees["forms"], "det", "images", "val")
    for i in range(FORM_DET_FRAMES + 1):    # noise, as [11]'s, so its labelling gives a mAP
        rgb = rng.randint(0, 256, (*ORIG_HW, 3)).astype(np.uint8)
        name, data = [("munich_0.bmp", lambda: W.bmp(rgb[..., ::-1], 24)),
                      ("munich_1.bmp", lambda: W.bmp(
                          None, 8, palette=np.repeat(np.arange(256)[:, None], 3, 1),
                          compression=1, rle=W.rle8(rgb[..., 1] // 64 * 64), size=ORIG_HW[::-1])),
                      ("munich_2.tif", lambda: tiff.encode(rgb[..., ::-1])),
                      ("munich_3.mpo", lambda: W.mpo([with_exif(jpeg.encode(rgb, 95), 6),
                                                      jpeg.encode(rgb[::2, ::2], 75)])),
                      ("munich_4.png", lambda: W.png(rgb.astype(np.uint16) * 257 + 7, 16, 2,
                                                     interlace=True, filters=(1, 2)))][i]
        with open(os.path.join(fdet, name), "wb") as fh:
            fh.write(data())
    label_split(eng32, fdet, os.path.join(trees["forms"], "det", "labels", "val"), rng, CLI_IMG,
                FORM_DET_FRAMES)
    for f in sorted(os.listdir(fdet)):
        stem = f.rsplit(".", 1)[0]
        png.imwrite(os.path.join(trees["png"], "det", "images", "val", stem + ".png"),
                    images.imread(os.path.join(fdet, f)))
        shutil.copy(os.path.join(trees["forms"], "det", "labels", "val", stem + ".txt"),
                    os.path.join(trees["png"], "det", "labels", "val", stem + ".txt"))
    for i in range(2):
        stem = f"munich_{i:06d}_000019"
        rgb = form_frame(*ORIG_HW, seed=SEED + 150 + i)
        train_ids = rng.randint(0, 19, ORIG_HW).astype(np.uint8)
        train_ids[rng.rand(*ORIG_HW) < 0.1] = 255
        label_ids = np.where(train_ids == 255, 255, CITYSCAPES_IDMAP[train_ids % 255])
        for tag in trees:
            idir = os.path.join(trees[tag], "citys", "leftImg8bit", "val", "munich")
            mdir = os.path.join(trees[tag], "citys", "gtFine", "val", "munich")
            os.makedirs(idir, exist_ok=True)
            os.makedirs(mdir, exist_ok=True)
            ipath = os.path.join(idir, f"{stem}_leftImg8bit.png")
            mpath = os.path.join(mdir, f"{stem}_gtFine_labelIds.png")
            if tag == "forms":
                with open(ipath, "wb") as fh:
                    fh.write(W.png(rgb, 8, 2, interlace=True, filters=(1, 2)))
                with open(mpath, "wb") as fh:
                    fh.write(W.png(label_ids.astype(np.uint16), 16, 0))
            else:
                png.imwrite(ipath, rgb[..., ::-1])
                png.imwrite(mpath, label_ids.astype(np.uint8))
    res = {}
    for tag in trees:
        data = os.path.join(trees[tag], "data.json")
        with open(data, "w") as fh:
            json.dump({"val": os.path.join(trees[tag], "det", "images", "val"),
                       "segval": os.path.join(trees[tag], "citys"), "nc": eng32.spec.nc,
                       "names": eng32.names}, fh)
        argv = ["--weights", weights, "--data", data, "--img-size", str(CLI_IMG), "--base-size",
                str(CLI_IMG), "--batch-size", str(FORM_DET_FRAMES), "--device",
                "" if DEVICE == "cuda" else DEVICE]
        K.reset_launches()
        metrics, _, _, spent, count, wall = run_cli(argv, kernels=False)
        torch.cuda.synchronize()
        res[tag] = {"metrics": metrics, "launches": K.launch_counts(), "cli_s": wall,
                    "loader_det_host_ms_per_image": spent["det"] * 1e3 / max(count["det"], 1),
                    "loader_seg_host_ms_per_image": spent["seg"] * 1e3 / max(count["seg"], 1)}
    for k in ("stem", "stem_float", "conv3x3", "c3", "nms_greedy", "upsample_argmax"):
        if res["forms"]["launches"][k] <= 0:
            raise AssertionError(f"[19] kernel {k} was not launched on the eval CLI's path")
    if res["forms"]["launches"] != res["png"]["launches"]:
        raise AssertionError(f"[19] eval launches on the forms {res['forms']['launches']}, on "
                             f"PNG {res['png']['launches']}")
    for k in ("P", "R", "mAP50", "mAP", "pixAcc", "mIoU"):
        check(f"[19] eval CLI on the forms vs on their PNG copies: {k} |diff|",
              abs(res["forms"]["metrics"][k] - res["png"]["metrics"][k]), 0)
    if not 0.05 < res["forms"]["metrics"]["mAP50"] < 0.95:     # as [11]'s labels give
        raise AssertionError(f"[19] degenerate detection metrics: {res['forms']['metrics']}")
    log(f"  (c) cli.test on {FORM_DET_FRAMES + 1} detection frames (24-bit and RLE8 BMP, LZW "
        f"TIFF, MPO with EXIF 6, Adam7 16-bit PNG) and 2 Cityscapes Adam7 frames with 16-bit "
        f"masks: metrics equal the PNG copies' {res['forms']['metrics']}; launches "
        f"{res['forms']['launches']}; loader host ms an image: detection forms "
        f"{res['forms']['loader_det_host_ms_per_image']:.1f}, PNG "
        f"{res['png']['loader_det_host_ms_per_image']:.1f}; seg forms "
        f"{res['forms']['loader_seg_host_ms_per_image']:.1f}, PNG "
        f"{res['png']['loader_seg_host_ms_per_image']:.1f}")
    return res


def phase_forms(eng32, card: str):
    """[19] the other still-image forms and their callers: (a) digests, (b)
    the detect app, (c) the eval CLI, (d) host times."""
    log(f"[19] PNG forms, BMP, MPO, TIFF: the port's decoders against cv2's and PIL's "
        f"digests at {FORM_HW}, cli.detect and cli.test on them against PNG copies")
    work = os.path.join(ROOT, "build", "chip_smoke_forms")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    part_s = {}
    t0 = time.perf_counter()
    res = {"card": card, "codecs": form_digests(work), "part_s": part_s}
    part_s["a_d"] = time.perf_counter() - t0
    weights = smoke_weights()
    t0 = time.perf_counter()
    res["app"] = forms_app(weights, work)
    part_s["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["eval"] = forms_eval(eng32, weights, work)
    part_s["c"] = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    log(f"  [19] seconds: (a) + (d) {part_s['a_d']:.1f}, (b) {part_s['b']:.1f}, "
        f"(c) {part_s['c']:.1f}")
    return res


# [20] WebP (data/webp.py, csrc/host/webp.cpp): the port's decodes of
# libwebp's files committed under tests/webp_fixtures/ against SHA-256s of
# cv2's and PIL's decodes of them (digests.json, taken with both libraries
# by tests/_torch_make_webp_fixtures.py), the lossless writer's round trip,
# the detect app and the eval CLI on WebP copies of [19]'s frames against
# PNG copies, and the codec's host times beside cv2's and PIL's
WEBP_FIXTURES = os.path.join(ROOT, "tests", "webp_fixtures")
WEBP_BIG = "lossy_2048x1024.webp"


def webp_codec(work: str) -> dict:
    """[20] (a) and (d): each fixture's three reads by the port against the
    libraries' digests; the writer's 2048x1024 file decoding to its input;
    host ms of one decode of the lossy frame and of one encode of the
    frame, beside cv2's and PIL's where they import (used nowhere in the
    port)."""
    import hashlib

    from multiyolov5_tpu_torch.data import images, webp
    t0 = time.perf_counter()
    webp.library()                      # g++ builds the host part here, before any timing
    out = {"build_s": time.perf_counter() - t0}
    with open(os.path.join(WEBP_FIXTURES, "digests.json")) as fh:
        want = json.load(fh)
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731
    for name in sorted(want):
        path = os.path.join(WEBP_FIXTURES, name)
        got = {"cv2": images.imread(path), "rgb": images.read_rgb(path),
               "samples": images.read_samples(path)}
        for k, v in got.items():
            if sha(v) != want[name][k]:
                raise AssertionError(f"[20] {name}: the port's {k} read (shape {v.shape}) is "
                                     "not the library's")
        out[name] = {"bytes": os.path.getsize(path), "imread": list(got["cv2"].shape),
                     "samples": list(got["samples"].shape)}
    big = os.path.join(WEBP_FIXTURES, WEBP_BIG)
    rec = {"decode_ms": host_ms(lambda: images.imread(big), reps=1)}
    frame = form_frame(*ORIG_HW, seed=SEED + 130)[..., ::-1].copy()
    written = os.path.join(work, "written.webp")
    rec["encode_ms"] = host_ms(lambda: images.imwrite(written, frame), reps=1)
    rec["encoded_bytes"] = os.path.getsize(written)
    rec["encoded_decode_ms"] = host_ms(lambda: images.imread(written), reps=1)
    if not np.array_equal(images.imread(written), frame):
        raise AssertionError("[20] the lossless writer's file does not decode to its input")
    try:
        import cv2
        rec["cv2_decode_ms"] = host_ms(lambda: cv2.imread(big), reps=1)
        theirs = os.path.join(work, "cv2.webp")
        rec["cv2_encode_ms"] = host_ms(lambda: cv2.imwrite(theirs, frame), reps=1)
        rec["cv2_encoded_bytes"] = os.path.getsize(theirs)
        if not np.array_equal(cv2.imread(written), frame):
            raise AssertionError("[20] cv2 does not decode the port's file to its input")
    except ImportError:
        rec["cv2"] = "does not import"
    try:
        from PIL import Image
        rec["pil_decode_ms"] = host_ms(lambda: Image.open(big).convert("RGB"), reps=1)
    except ImportError:
        rec["PIL"] = "does not import"
    out["host"] = rec
    log(f"  (a) {len(want)} fixtures ({', '.join(sorted(want))}): imread, read_rgb and "
        f"read_samples SHA-256 equal cv2's and PIL's; the writer's {ORIG_HW[1]}x{ORIG_HW[0]} "
        f"file ({rec['encoded_bytes']} bytes) decodes to its input; (d) host ms "
        + ", ".join(f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in rec.items()))
    return out


def webp_sources(work: str, tag: str, frames) -> tuple:
    """WebP copies of ``frames`` (the port's lossless writer) plus the lossy
    fixture under ``<work>/<tag>``, and PNG copies of the port's decodes of
    them under ``<work>/<tag>_png``: the two directories."""
    from multiyolov5_tpu_torch.data import images, png
    src, copies = os.path.join(work, tag), os.path.join(work, f"{tag}_png")
    os.makedirs(src)
    os.makedirs(copies)
    for i, f in enumerate(frames):
        images.imwrite(os.path.join(src, f"w{i}.webp"), f[..., ::-1])
    shutil.copy(os.path.join(WEBP_FIXTURES, WEBP_BIG), os.path.join(src, "lossy.webp"))
    for name in os.listdir(src):
        png.imwrite(os.path.join(copies, name.rsplit(".", 1)[0] + ".png"),
                    images.imread(os.path.join(src, name)))
    return src, copies


def webp_app(weights: str, work: str) -> dict:
    """[20] (b): cli.detect with ``--save-txt --submit --nosave`` on two
    [19] frames written as lossless WebP and the lossy fixture, against the
    same app on PNG copies: equal txt, each ``results/name._pred.png`` (the
    JAX app's name for a ``.webp``) the PNG run's ``name_pred.png``, the
    launches the PNG run's; then one run that saves, which writes
    ``w0.webp`` (decoding to the PNG run's ``w0.png``) and raises at
    ``w0._maskwebp``, as the JAX app raises there."""
    from multiyolov5_tpu_torch.data import images, png
    from multiyolov5_tpu_torch.ops import kernels as K
    frames = [form_frame(*ORIG_HW, seed=SEED + 130 + i) for i in range(2)]
    src, copies = webp_sources(work, "app", frames)
    n = len(os.listdir(src))
    base = ["--weights", weights, "--img-size", str(APP_IMG), "--save-txt", "--save-conf",
            "--project", work, "--exist-ok", "--device", "" if DEVICE == "cuda" else DEVICE]
    runs = {}
    for tag, d in (("webp", src), ("png", copies)):
        K.reset_launches()
        out, loop_s = run_app(base + ["--source", d, "--name", f"out_{tag}", "--submit",
                                      "--nosave"])
        torch.cuda.synchronize()
        runs[tag] = (out, K.launch_counts(), loop_s)
    launches = runs["webp"][1]
    want = {"stem": n, "stem_float": 0, "conv3x3": 10 * n, "nms": n, "upsample_argmax": n,
            "nms_greedy": 0, "c3": 0}
    if {k: launches[k] for k in want} != want or runs["png"][1] != launches:
        raise AssertionError(f"[20] app launches on WebP {launches}, on PNG {runs['png'][1]}, "
                             f"want {want} on both")
    wo, po = runs["webp"][0], runs["png"][0]
    for name in sorted(os.listdir(src)):
        stem = name.rsplit(".", 1)[0]
        with open(os.path.join(wo, "labels", f"{stem}.txt")) as a, \
                open(os.path.join(po, "labels", f"{stem}.txt")) as b:
            if a.read() != b.read():
                raise AssertionError(f"[20] app: labels/{stem}.txt differs from the PNG copy's")
        with open(os.path.join(wo, "results", f"{stem}._pred.png"), "rb") as a, \
                open(os.path.join(po, "results", f"{stem}_pred.png"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"[20] app: results/{stem}._pred.png differs from the PNG "
                                     f"copy's {stem}_pred.png")
    one, one_png = os.path.join(work, "app_one"), os.path.join(work, "app_one_png")
    os.makedirs(one)
    os.makedirs(one_png)
    shutil.copy(os.path.join(src, "w0.webp"), one)
    shutil.copy(os.path.join(copies, "w0.png"), one_png)
    try:
        run_app(base + ["--source", one, "--name", "out_one"])
        raise AssertionError("[20] app: saving a .webp source did not raise at its _mask")
    except ValueError as e:
        if "could not find a writer" not in str(e) or "_maskwebp" not in str(e):
            raise
    out_png, _ = run_app(base + ["--source", one_png, "--name", "out_one_png"])
    saved = images.imread(os.path.join(work, "out_one", "w0.webp"))
    if not np.array_equal(saved, png.imread(os.path.join(out_png, "w0.png"))):
        raise AssertionError("[20] app: w0.webp does not decode to the PNG run's w0.png")
    log(f"  (b) cli.detect --submit --nosave on {n} frames {ORIG_HW} (2 lossless WebP, the "
        f"lossy fixture): txt and _pred.png equal the PNG copies' run; launches {launches}; "
        f"app ms/frame WebP {runs['webp'][2] * 1e3 / n:.1f}, PNG {runs['png'][2] * 1e3 / n:.1f}; "
        "a saving run writes w0.webp (the PNG run's pixels) and raises at w0._maskwebp")
    return {"launches": launches, "ms_per_frame_webp": runs["webp"][2] * 1e3 / n,
            "ms_per_frame_png": runs["png"][2] * 1e3 / n}


def webp_eval(eng32, weights: str, work: str) -> dict:
    """[20] (c): cli.test (fp32) on a detection split of two noise frames
    written as lossless WebP and the lossy fixture, and a Cityscapes split
    of one WebP frame (stored under its ``.png`` name, read by content),
    against the same CLI on PNG copies: metrics and launches equal."""
    from multiyolov5_tpu_torch.data import images, png
    from multiyolov5_tpu_torch.data.cityscapes import CITYSCAPES_IDMAP
    from multiyolov5_tpu_torch.ops import kernels as K
    rng = np.random.RandomState(SEED + 160)
    frames = [rng.randint(0, 256, (*ORIG_HW, 3)).astype(np.uint8) for _ in range(2)]
    trees = {tag: os.path.join(work, f"eval_{tag}") for tag in ("webp", "png")}
    src, copies = webp_sources(work, "eval_src", frames)
    for tag, d in (("webp", src), ("png", copies)):
        os.makedirs(os.path.join(trees[tag], "det", "images"))
        shutil.copytree(d, os.path.join(trees[tag], "det", "images", "val"))
    label_split(eng32, os.path.join(trees["webp"], "det", "images", "val"),
                os.path.join(trees["webp"], "det", "labels", "val"), rng, CLI_IMG,
                FORM_DET_FRAMES)
    shutil.copytree(os.path.join(trees["webp"], "det", "labels", "val"),
                    os.path.join(trees["png"], "det", "labels", "val"))
    stem = "munich_000000_000019"
    city = form_frame(*ORIG_HW, seed=SEED + 161)
    train_ids = rng.randint(0, 19, ORIG_HW).astype(np.uint8)
    train_ids[rng.rand(*ORIG_HW) < 0.1] = 255
    label_ids = np.where(train_ids == 255, 255, CITYSCAPES_IDMAP[train_ids % 255]).astype(np.uint8)
    for tag in trees:
        idir = os.path.join(trees[tag], "citys", "leftImg8bit", "val", "munich")
        mdir = os.path.join(trees[tag], "citys", "gtFine", "val", "munich")
        os.makedirs(idir)
        os.makedirs(mdir)
        ipath = os.path.join(idir, f"{stem}_leftImg8bit.png")
        (images.imwrite if tag == "webp" else png.imwrite)(
            ipath + (".webp" if tag == "webp" else ""), city[..., ::-1])
        if tag == "webp":
            os.rename(ipath + ".webp", ipath)
        png.imwrite(os.path.join(mdir, f"{stem}_gtFine_labelIds.png"), label_ids)
    res = {}
    for tag in trees:
        data = os.path.join(trees[tag], "data.json")
        with open(data, "w") as fh:
            json.dump({"val": os.path.join(trees[tag], "det", "images", "val"),
                       "segval": os.path.join(trees[tag], "citys"), "nc": eng32.spec.nc,
                       "names": eng32.names}, fh)
        argv = ["--weights", weights, "--data", data, "--img-size", str(CLI_IMG), "--base-size",
                str(CLI_IMG), "--batch-size", str(FORM_DET_FRAMES), "--device",
                "" if DEVICE == "cuda" else DEVICE]
        K.reset_launches()
        metrics, _, _, spent, count, wall = run_cli(argv, kernels=False)
        torch.cuda.synchronize()
        res[tag] = {"metrics": metrics, "launches": K.launch_counts(), "cli_s": wall,
                    "loader_det_host_ms_per_image": spent["det"] * 1e3 / max(count["det"], 1)}
    for k in ("stem", "stem_float", "conv3x3", "c3", "nms_greedy", "upsample_argmax"):
        if res["webp"]["launches"][k] <= 0:
            raise AssertionError(f"[20] kernel {k} was not launched on the eval CLI's path")
    if res["webp"]["launches"] != res["png"]["launches"]:
        raise AssertionError(f"[20] eval launches on WebP {res['webp']['launches']}, on PNG "
                             f"{res['png']['launches']}")
    for k in ("P", "R", "mAP50", "mAP", "pixAcc", "mIoU"):
        check(f"[20] eval CLI on WebP vs on their PNG copies: {k} |diff|",
              abs(res["webp"]["metrics"][k] - res["png"]["metrics"][k]), 0)
    if not 0.05 < res["webp"]["metrics"]["mAP50"] < 0.95:      # as [11]'s labels give
        raise AssertionError(f"[20] degenerate detection metrics: {res['webp']['metrics']}")
    log(f"  (c) cli.test on 3 WebP detection frames (2 lossless, the lossy fixture) and a "
        f"WebP Cityscapes frame: metrics equal the PNG copies' {res['webp']['metrics']}; "
        f"launches {res['webp']['launches']}; loader host ms an image: WebP "
        f"{res['webp']['loader_det_host_ms_per_image']:.1f}, PNG "
        f"{res['png']['loader_det_host_ms_per_image']:.1f}")
    return res


def prebuild_webp() -> None:
    """Build [20]'s host codec early, beside [1]'s nvcc builds; a failed build
    is left for [20]'s own load to build again and raise."""
    try:
        from multiyolov5_tpu_torch.data import webp
        webp.library()
    except Exception:                   # noqa: BLE001 (raised again where [20] loads it)
        pass


def phase_webp(eng32, card: str):
    """[20] WebP and its callers: (a) digests, (b) the detect app, (c) the
    eval CLI, (d) host times."""
    log("[20] WebP: the port's decoders against cv2's and PIL's digests of libwebp's files, "
        "its writer, cli.detect and cli.test on WebP against PNG copies")
    work = os.path.join(ROOT, "build", "chip_smoke_webp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    part_s = {}
    t0 = time.perf_counter()
    res = {"card": card, "codec": webp_codec(work), "part_s": part_s}
    part_s["a_d"] = time.perf_counter() - t0
    weights = smoke_weights()
    t0 = time.perf_counter()
    res["app"] = webp_app(weights, work)
    part_s["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["eval"] = webp_eval(eng32, weights, work)
    part_s["c"] = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    log(f"  [20] seconds: (a) + (d) {part_s['a_d']:.1f}, (b) {part_s['b']:.1f}, "
        f"(c) {part_s['c']:.1f}")
    return res


PHASE_S = {}


def timed(label: str, fn, *args):
    """``fn(*args)``, its wall seconds logged and kept in PHASE_S."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[label] = time.perf_counter() - t0
    log(f"  {label} took {PHASE_S[label]:.1f} s")
    return out


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
    # the card's machine may have a real wandb: no run of this script may
    # reach for the network through it ([14] run A uses a stand-in, the
    # other CLI runs --no-wandb; these hold for any wandb imported anyway)
    os.environ["WANDB_MODE"] = "disabled"
    os.environ["WANDB_ERROR_REPORTING"] = "false"
    t_start = time.perf_counter()
    # g++ builds [20]'s host codec while [1]'s nvcc builds run (a failed
    # build is built again, and raises, where [20] loads it)
    threading.Thread(target=prebuild_webp, daemon=True).start()
    smi, sass = timed("[1]", phase_card)
    rng = np.random.RandomState(SEED)
    frames = [(rng.rand(*IN_HW, 3) * 255).astype(np.uint8) for _ in range(N_FRAMES)]
    eng32 = Engine(cfg=CFG, device=DEVICE, half=False, seed=SEED)
    eng16 = Engine(cfg=CFG, device=DEVICE, half=True, seed=SEED)
    cpu_eng = Engine(cfg=CFG, device="cpu", half=False, seed=SEED)

    errs, sites16, nms_in = timed("[2]", phase_kernels, eng32, eng16, frames)
    launches = timed("[3]", phase_end_to_end, eng32, eng16, cpu_eng, frames)
    ev = timed("[5]", phase_eval, eng32, eng16, cpu_eng)
    launches["nms_greedy"] = ev["launches"]["nms_greedy"]
    errs["nms_greedy"] = ev["errs"]["nms_greedy"]
    (e2e, times, per_site, library, bounds, k4_eval, short, c3_times, k2_f32, k2_sweep,
     stem_bs8) = timed("[6]", phase_timing, eng32, eng16, frames, sites16, nms_in, ev)
    eval_launches, eval_errs = ev["launches"], ev["errs"]
    eval_n, eval_metrics = ev["n"], ev["metrics"]
    del ev
    sv = timed("[8]", phase_serving, eng32, eng16, cpu_eng)
    n_batched = sum(b[0] > 1 for b in sv["batches"])
    launches["c3"] = sv["launches"]["c3"]
    app = timed("[10]", phase_app, eng32, eng16, cpu_eng, frames, smi)
    fam = timed("[9]", phase_families, eng32, frames)
    cli = timed("[11]", phase_eval_cli, eng32, smi)
    hb = timed("[12]", phase_hub, smi)
    pe = timed("[13]", phase_profile_export, eng32, eng16, frames, smi)
    jp = timed("[18]", phase_jpeg, eng32, smi)
    fm = timed("[19]", phase_forms, eng32, smi)
    wp = timed("[20]", phase_webp, eng32, smi)
    del eng32, eng16, cpu_eng
    tr = timed("[7]", phase_train)
    tc = timed("[14]", phase_train_cli, smi)
    torch.cuda.empty_cache()        # [15]'s ranks share the card with this process
    par = timed("[15]", phase_parallel, smi, tc["tree"])
    dsl = timed("[16]", phase_dsl, frames, smi)
    tools = timed("[17]", phase_tools, smi)
    check_sass(sass)
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
    # eval_launches, train_launches, eval_cli_launches ([11], the CLI's
    # counted run), hub_launches ([12], one fp32 AutoShape call on the
    # mixed list) and dsl_launches ([16]'s counted calls: yolov3 bs1 fp32
    # and bf16, bs8 fp32 and bf16, its eval batch; the transformer bs1 fp32
    # and bf16, bs2; bilinear pspv5s bs1 fp32 and bf16): every kernel on
    # those paths.
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
                "eval_cli_launches": cli["launches"][k], "hub_launches": hb["launches"][k],
                "train_launches": train_counts[k] + (train_counts["seg_ce_bwd"]
                                                     if k == "seg_ce" else 0),
                "train_cli_launches": tc["run_a"]["launches"][k] + (
                    tc["run_a"]["launches"]["seg_ce_bwd"] if k == "seg_ce" else 0),
                "dsl_launches": dsl["launches"][k] + (
                    dsl["launches"]["seg_ce_bwd"] if k == "seg_ce" else 0),
                "jpeg_app_launches": jp["app"]["launches"][k],
                "jpeg_eval_cli_launches": jp["eval"]["jpg"]["launches"][k],
                "forms_app_launches": fm["app"]["launches"][k],
                "forms_eval_cli_launches": fm["eval"]["forms"]["launches"][k],
                "webp_app_launches": wp["app"]["launches"][k],
                "webp_eval_cli_launches": wp["eval"]["webp"]["launches"][k],
                "err_dtype": "float32",
                "ms_dtype": ("float32" if k.startswith("nms") or k == "stem_float"
                             else "bfloat16")}
               for k in replaces]
    kk = {k["name"]: k for k in kernels}
    kk["seg_ce"].update(fwd_ms=k6["fwd_ms"], bwd_ms=k6["bwd_ms"],
                        fwd_launches=train_counts["seg_ce"],
                        bwd_launches=train_counts["seg_ce_bwd"], plan=tr["k6"]["bf16"]["plan"],
                        # [15] (a): forward + backward on each rank of the 2-rank step
                        dp_launches=[c["seg_ce"] + c["seg_ce_bwd"] for c in par["a"]["launches"]],
                        dp_max_abs_err=max(q["dz_max_abs"] for q in par["a"]["k6"]))
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
                      fp32_frame=su["frame"],
                      # [12]'s 1- and 4-channel models: K1's launches, error and
                      # times on each bs1 call's own arguments, by channels and dtype
                      channels={ch: {"launches": {d: r["launches"][d]["stem"]
                                                  for d in r["launches"]}, **r["stem"]}
                                for ch, r in hb["channels"].items()})
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
    # K7's bf16 form at pspv5m's bs8 shape; its float32 form (3xTF32) at
    # eval's shape, its bound beside the CUDA cores' float32 bound
    mb = c3_times["pspv5m_bs8_bf16"]
    kk["c3"].update(pspv5m_bs8_ms=mb["ms"], pspv5m_bs8_plain_ms=mb["plain_ms"],
                    pspv5m_bs8_library_ms=mb["library_ms"], pspv5m_bs8_bound_ms=mb["bound"][0])
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
                   "serving_bs8": sv, "families": fam, "app": app, "eval_cli": cli,
                   "hub": hb, "profile_export": pe, "train_cli": tc, "parallel": par,
                   "dsl": dsl, "tools": tools, "jpeg": jp, "forms": fm, "webp": wp,
                   "phase_s": PHASE_S,
                   "total_s": time.perf_counter() - t_start}, fh,
                  indent=1)
    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
