"""Detection and segmentation heads (counterpart of ``multiyolov5_tpu/models/heads.py``).

Every seg head returns its 1/8-res logits (B, n_segcls, h, w); the x8
upsample is composed into the mask kernel (ops/kernels/upsample_argmax.py)
at serving and eval, and into the seg loss (ops/kernels/seg_ce.py) in
training.  Built with ``kernel=True`` (fused, from the neck on), a head runs
its 3x3 convs through K2 at the sites where the JAX package runs a Pallas
3x3; the bias-free 3x3s (Base's ``m.3``, ASPP's dilated branches) stay
cuDNN convolutions, as they stay XLA convolutions there."""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops import shard
from ..ops.nn import Dropout
from ..ops.resize import resize_bilinear
from .blocks import ASPP, C3, C3SPP, FFM, RFB2, Conv, PyramidPooling


class Detect(nn.Module):
    """reference models/yolo.py:189-230.

    In eval mode ``forward`` returns the decoded candidates PLANAR, (B, no,
    N) float32 with rows [x, y, w, h, obj, cls...] in input pixels and N
    ordered (scale, anchor, pixel) — the order of detect_decode_planar
    (multiyolov5_tpu/models/heads.py:75-138) that ops/nms.nms_planar's
    lower-index-first top-k ties depend on.  In training mode, or with
    ``decode=False`` (the reference's ``Detect.export``), it returns the
    raw per-level maps (B, na, ny, nx, no) in the conv's dtype, the
    layout of detect_raw (multiyolov5_tpu/models/heads.py:53-72)."""

    def __init__(self, nc: int, anchors, ch: Sequence[int], strides: Sequence[int]):
        super().__init__()
        self.nc, self.no = nc, nc + 5
        self.nl, self.na = len(anchors), len(anchors[0]) // 2
        self.strides = [float(s) for s in strides]
        self.m = nn.ModuleList(nn.Conv2d(c, self.no * self.na, 1) for c in ch)
        a = np.asarray(anchors, np.float32).reshape(self.nl, -1, 2)
        self.register_buffer("anchors", torch.from_numpy(
            a / np.asarray(strides, np.float32)[:, None, None]))
        self.register_buffer("anchor_grid", torch.from_numpy(
            a.reshape(self.nl, 1, -1, 1, 1, 2).copy()))

    def init_bias_prior(self) -> None:
        """Focal-loss prior init, reference models/yolo.py:318-326."""
        with torch.no_grad():
            for conv, s in zip(self.m, self.strides):
                b = conv.bias.view(self.na, -1)
                b[:, 4] += math.log(8 / (640 / s) ** 2)
                b[:, 5:] += math.log(0.6 / (self.nc - 0.99))

    def forward(self, xs: List[torch.Tensor], decode=True):
        """``decode``: True for the candidates, False for the raw maps,
        "both" for the pair (candidates, raw maps) from one set of convs
        (the eval loop's validation losses read the raw maps)."""
        ys = [conv(x) for conv, x in zip(self.m, xs)]
        if self.training or not decode:
            return self._raw(ys)
        z = self._decode(ys)
        return (z, self._raw(ys)) if decode == "both" else z

    def _raw(self, ys: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for y in ys:
            b, _, ny, nx = y.shape
            out.append(y.view(b, self.na, self.no, ny, nx).permute(0, 1, 3, 4, 2))
        return out

    def _decode(self, ys: List[torch.Tensor]) -> torch.Tensor:
        zs = []
        for i, y in enumerate(ys):
            y = y.float()                                  # (B, na*no, ny, nx)
            b, _, ny, nx = y.shape
            y = y.sigmoid().reshape(b, self.na, self.no, ny * nx)
            s = self.strides[i]
            gx = torch.arange(nx, dtype=torch.float32, device=y.device).repeat(ny)
            # expand, not repeat_interleave: torch.jit.trace of that on the
            # card puts its repeat count on the CPU (torch 2.11)
            gy = torch.arange(ny, dtype=torch.float32,
                              device=y.device)[:, None].expand(ny, nx).reshape(-1)
            anc = (self.anchors[i] * s)[None, :, :, None]  # (1, na, 2, 1)
            xy = (y[:, :, 0:2] * 2.0 - 0.5 + torch.stack([gx, gy])) * s
            wh = torch.square(y[:, :, 2:4] * 2.0) * anc
            z = torch.cat([xy, wh, y[:, :, 4:]], 2)        # (B, na, no, HW)
            zs.append(z.transpose(1, 2).reshape(b, self.no, self.na * ny * nx))
        return torch.cat(zs, 2)


class SegMaskPSP(nn.Module):
    """PSP segmentation head, reference models/yolo.py:149-186."""

    def __init__(self, n_segcls: int, c_hid: int, ch: Sequence[int],
                 fused: bool = False, kernel: bool = False):
        super().__init__()
        c8, c16, c32 = ch
        self.m8 = nn.Sequential(Conv(c8, c_hid, 1, fused=fused))
        self.m16 = nn.Sequential(Conv(c16, c_hid, 1, fused=fused))
        self.m32 = nn.Sequential(Conv(c32, c_hid, 1, fused=fused))
        self.out = nn.Sequential(
            RFB2(c_hid * 3, c_hid, map_reduce=6, d=(2, 3), fused=fused, kernel=kernel),
            PyramidPooling(c_hid, fused=fused),
            FFM(c_hid * 2, c_hid, k=3, fused=fused, kernel=kernel),
            nn.Conv2d(c_hid, n_segcls, 1))

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        x8, x16, x32 = xs
        hw = tuple(x8.shape[-2:])
        feat = torch.cat([self.m8(x8), resize_bilinear(self.m16(x16), hw),
                          resize_bilinear(self.m32(x32), hw)], 1)
        return self.out(feat)


class SegMaskBase(nn.Module):
    """C3 + C3SPP + a bias-free 3x3 to the classes, reference
    models/yolo.py:129-146 (multiyolov5_tpu/models/heads.py:248-269)."""

    def __init__(self, n_segcls: int, n: int, c_hid: int, shortcut: bool,
                 ch: Sequence[int], fused: bool = False, kernel: bool = False):
        super().__init__()
        c_out = int(c_hid * 1.5)
        self.m = nn.Sequential(
            C3(ch[0], c_hid, n=n, shortcut=shortcut, fused=fused, kernel=kernel),
            C3SPP(c_hid, c_out, fused=fused),
            Dropout(0.1),
            nn.Conv2d(c_out, n_segcls, 3, 1, 1, bias=False))

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        m = self.m
        return shard.conv2d(m[3], m[2](m[1](m[0](xs[0]))))


class SegMaskBiSe(nn.Module):
    """BiSeNet-style head, reference models/yolo.py:30-86
    (multiyolov5_tpu/models/heads.py:273-314).  In eval mode it returns the
    1/8-res logits; in training mode ``[main, aux16, aux32]``: the main
    logits and the aux pair on ``feat2`` (1/8 res) and ``feat3`` (1/16
    res), each at its own resolution.  The JAX head upsamples them x8, x8
    and x16 to the label size; the port's loss does that
    (train/trainer.py), the same function."""

    def __init__(self, n_segcls: int, ch: Sequence[int], fused: bool = False,
                 kernel: bool = False):
        super().__init__()
        c8, c16, c32 = ch
        self.m8 = nn.Sequential(Conv(c8, 128, 1, fused=fused))
        self.m16 = nn.Sequential(RFB2(c16, 128, map_reduce=4, fused=fused, kernel=kernel))
        self.m32 = nn.Sequential(RFB2(c32, 128, map_reduce=8, has_globel=True,
                                      fused=fused, kernel=kernel))
        self.up16 = nn.Sequential(Conv(128, 128, 3, fused=fused, kernel=kernel))
        self.up32 = nn.Sequential(Conv(128, 128, 3, fused=fused, kernel=kernel))
        self.out = nn.Sequential(FFM(256, 256, k=3, fused=fused, kernel=kernel),
                                 Dropout(0.1), nn.Conv2d(256, n_segcls, 1))
        self.aux16 = nn.Sequential(Conv(128, 128, 3, fused=fused), nn.Conv2d(128, n_segcls, 1))
        self.aux32 = nn.Sequential(Conv(128, 128, 3, fused=fused), nn.Conv2d(128, n_segcls, 1))

    def forward(self, xs: List[torch.Tensor]):
        x8, x16, x32 = xs
        f32 = self.up32(self.m32(x32))
        feat3 = resize_bilinear(f32, (f32.shape[2] * 2, f32.shape[3] * 2))
        f16 = self.up16(self.m16(x16) + feat3)
        feat2 = resize_bilinear(f16, (f16.shape[2] * 2, f16.shape[3] * 2))
        main = self.out(torch.cat([self.m8(x8), feat2], 1))
        if not self.training:
            return main
        return [main, self.aux16(feat2), self.aux32(feat3)]


class SegMaskLab(nn.Module):
    """DeepLabV3+-style head, reference models/yolo.py:93-124
    (multiyolov5_tpu/models/heads.py:318-344): an ASPP encoder on the 1/16
    map (``map_reduce`` 5 - n), a 48-channel detail branch on the 1/8 map,
    an FFM decoder."""

    def __init__(self, n_segcls: int, n: int, c_hid: int, ch: Sequence[int],
                 fused: bool = False, kernel: bool = False):
        super().__init__()
        c_detail, c16 = ch
        self.detail = nn.Sequential(Conv(c_detail, 48, 1, fused=fused),
                                    Conv(48, 48, 3, fused=fused, kernel=kernel))
        self.encoder = nn.Sequential(
            Conv(c16, c_hid * 2, 1, fused=fused),
            ASPP(c_hid * 2, 256, has_globel=False, map_reduce=5 - n, fused=fused))
        self.decoder = nn.Sequential(FFM(256 + 48, 256, k=1, fused=fused),
                                     Conv(256, c_hid, 3, fused=fused, kernel=kernel),
                                     nn.Conv2d(c_hid, n_segcls, 1))

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        x_detail, x16 = xs
        e = self.encoder(x16)
        e = resize_bilinear(e, (e.shape[2] * 2, e.shape[3] * 2))
        return self.decoder(torch.cat([self.detail(x_detail), e], 1))
