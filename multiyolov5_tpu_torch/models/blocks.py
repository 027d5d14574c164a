"""Building blocks (counterpart of ``multiyolov5_tpu/models/blocks.py``).

``nn.Module``s on NCHW tensors whose parameter names equal the reference
``state_dict`` keys (``cv1.conv.weight``, ``branch1.1.running_var``, ...).
Every block is built either unfused (conv without bias, then BN, eps 1e-3)
or ``fused`` (BN folded into a biased conv, see ops/nn.fuse_conv_bn).  A
block built with ``kernel=True`` runs its fused 3x3 convs through the K2
kernel (ops/kernels/conv3x3.py); a fused C3 built with ``c3_kernel=True``
runs whole through the K7 kernel (ops/kernels/c3.py) in eval mode at batch
> 1; all other convs are ``F.conv2d``.  Convs with vertical reach, pools
and global means go through ops/shard.py, which a sharded forward
(parallel/spatial.py) turns into halo exchanges and gathers.  A BN that
no conv absorbs (BottleneckCSP's, MixConv2d's, DAPPM's, an
``nn.BatchNorm2d`` row) stays in the fused build and applies its running
statistics (ops/nn.batch_norm).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import shard
from ..ops.kernels import c3, conv3x3
from ..ops.kernels.conv3x3 import takes as k2_takes
from ..ops.nn import BN_EPS, BN_MOMENTUM, autopad, batch_norm
from ..ops.resize import (UPSAMPLE_MODES, adaptive_avg_pool_multi, max_pool_same,
                          resize_bilinear, upsample)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def _kernel_weights(conv: nn.Conv2d):
    """(OHWI weight, float32 bias) of a fused conv for K2 and K7, cached on the conv
    and rebuilt whenever the parameters change (dtype, device or values)."""
    w, b = conv.weight, conv.bias
    key = (w.data_ptr(), w._version, w.dtype, b.data_ptr(), b._version)
    cache = getattr(conv, "_k2_cache", None)
    if cache is None or cache[0] != key:
        cache = (key, w.detach().permute(0, 2, 3, 1).contiguous(),
                 b.detach().float().contiguous())
        conv._k2_cache = cache
    return cache[1], cache[2]


def conv3x3_k2(conv: nn.Conv2d, x: torch.Tensor, act: bool) -> torch.Tensor:
    """A fused 3x3 ``conv`` (+ SiLU) through K2.  On the card the model runs
    channels_last, so both permutes are views."""
    w, b = _kernel_weights(conv)
    y = conv3x3(x.permute(0, 2, 3, 1).contiguous(), w, b,
                stride=conv.stride[0], dilation=conv.dilation[0], act=act)
    return y.permute(0, 3, 1, 2)


class Conv(nn.Module):
    """reference models/common.py:34-46: conv + BN + SiLU (none with
    ``act=False``).  ``k`` and ``s`` may be (h, w) pairs (CrossConv), ``g``
    is the conv's groups.  With ``kernel`` a fused square 3x3 of one group
    whose widths, stride and dilation K2 takes runs through K2."""

    def __init__(self, c1: int, c2: int, k=1, s=1, d: int = 1, g: int = 1,
                 act: bool = True, fused: bool = False, kernel: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, d), dilation=d, groups=g, bias=fused)
        self.bn = None if fused else _bn(c2)
        self.act = act
        self.kernel = (kernel and fused and k == 3 and g == 1 and isinstance(s, int)
                       and k2_takes(c1, c2, s, d))

    def forward(self, x):
        if self.kernel:
            return conv3x3_k2(self.conv, x, self.act)
        y = shard.conv2d(self.conv, x)
        if self.bn is not None:
            y = self.bn(y)
        return F.silu(y) if self.act else y


def DWConv(c1: int, c2: int, k=1, s=1, act: bool = True, fused: bool = False) -> Conv:
    """Depth-wise conv, groups gcd(c1, c2) (reference models/common.py:29-31)."""
    return Conv(c1, c2, k, s, g=math.gcd(c1, c2), act=act, fused=fused)


class ConvBN(nn.Module):
    """Bare ``nn.Sequential(Conv2d, BatchNorm2d)`` + SiLU inside RFB2 and ASPP
    (keys ``<name>.0.weight``, ``<name>.1.running_mean``)."""

    def __init__(self, c1: int, c2: int, d: int = 1, fused: bool = False,
                 kernel: bool = False):
        super().__init__()
        self.add_module("0", nn.Conv2d(c1, c2, 3, 1, d, dilation=d, bias=fused))
        self.add_module("1", None if fused else _bn(c2))
        self.kernel = kernel and fused and k2_takes(c1, c2, 1, d)

    def forward(self, x):
        conv, bn = getattr(self, "0"), getattr(self, "1")
        if self.kernel:
            return conv3x3_k2(conv, x, True)
        y = shard.conv2d(conv, x)
        if bn is not None:
            y = bn(y)
        return F.silu(y)


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5,
                 fused: bool = False, kernel: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, fused=fused)
        self.cv2 = Conv(c_, c2, 3, fused=fused, kernel=kernel)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """reference models/common.py:138-152.

    ``c3_kernel``: a fused C3 with 8 <= c_ <= 48, c_ % 8 == 0 runs whole
    through K7 in eval mode at batch > 1: the sites, batch rule and widths
    where the JAX package runs ``c3_packed_pallas``
    (multiyolov5_tpu/models/blocks.py:125-192, minus its TPU geometry
    checks)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5, fused: bool = False, kernel: bool = False,
                 c3_kernel: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, fused=fused)
        self.cv2 = Conv(c1, c_, 1, fused=fused)
        self.cv3 = Conv(2 * c_, c2, 1, fused=fused)
        self.m = nn.Sequential(*[Bottleneck(c_, c_, shortcut, 1.0, fused, kernel)
                                 for _ in range(n)])
        self.shortcut = shortcut
        self.c3_kernel = c3_kernel and fused and 8 <= c_ <= 48 and c_ % 8 == 0

    def forward(self, x):
        if self.c3_kernel and not self.training and x.shape[0] > 1:
            return self._k7(x)
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))

    def kernel_args(self):
        """K7's arguments after x: the cached OHWI / float32 weights and
        biases of cv1, cv2, cv3, the bottlenecks', and ``shortcut``."""
        mws = [(*_kernel_weights(b.cv1.conv), *_kernel_weights(b.cv2.conv)) for b in self.m]
        return (*_kernel_weights(self.cv1.conv), *_kernel_weights(self.cv2.conv),
                *_kernel_weights(self.cv3.conv), mws, self.shortcut)

    def _k7(self, x):
        """The whole block through K7.  On the card the model runs
        channels_last, so both permutes are views."""
        y = c3(x.permute(0, 2, 3, 1).contiguous(), *self.kernel_args())
        return y.permute(0, 3, 1, 2)


class SPP(nn.Module):
    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13),
                 fused: bool = False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, fused=fused)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, fused=fused)
        self.k = tuple(k)

    def forward(self, x):
        # pools read a contiguous NCHW copy: on an H100 (700 W) torch's
        # channels_last max pool took 0.03-0.17 ms per pool at (1, 256, 16, 32),
        # the contiguous one 0.02 ms
        x = self.cv1(x).contiguous()
        return self.cv2(torch.cat([x] + [max_pool_same(x, k) for k in self.k], 1))


class C3SPP(nn.Module):
    """A C3 whose bottleneck chain is one SPP (multiyolov5_tpu/models/blocks.py:254-274):
    c_ = c1 * e, the SPP widens c_ to 1.5 c_."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13), e: float = 0.5,
                 fused: bool = False):
        super().__init__()
        c_ = int(c1 * e)
        self.cv1 = Conv(c1, c_, 1, fused=fused)
        self.cv2 = Conv(c1, c_, 1, fused=fused)
        self.cv3 = Conv(c_ + int(c_ * 1.5), c2, 1, fused=fused)
        self.m = SPP(c_, int(c_ * 1.5), k, fused=fused)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class Focus(nn.Module):
    """reference models/common.py:542-551: 2x2 space-to-depth (phase order
    [ee, oe, eo, oo], H-offset first) then Conv."""

    def __init__(self, c1: int, c2: int, k: int = 1, fused: bool = False):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, fused=fused)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1))


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


class Upsample(nn.Module):
    """``nn.Upsample(None, scale, mode)`` rows: every mode torch takes on a
    4-D map (``UPSAMPLE_MODES``), with torch's default ``align_corners``
    (the JAX package's non-nearest rows compute an align-corners bilinear,
    multiyolov5_tpu/models/model.py:179-186, unlike the reference's)."""

    def __init__(self, scale: int, mode: str = "nearest"):
        super().__init__()
        if mode not in UPSAMPLE_MODES:
            raise ValueError(f"nn.Upsample mode {mode!r}: a 4-D map takes one of "
                             f"{', '.join(UPSAMPLE_MODES)}")
        self.scale, self.mode = int(scale), mode

    def forward(self, x):
        return upsample(x, self.scale, self.mode)


def _global_branch(c1: int, c2: int, fused: bool) -> nn.Module:
    """The ``nn.Sequential(AdaptiveAvgPool2d(1), Conv(c1, c2, 1))`` global
    branch (key ``<name>.1``); :func:`_global_apply` pools with a mean, which
    unlike torch's channels_last adaptive pool is fast on the card."""
    branch = nn.Module()
    branch.add_module("1", Conv(c1, c2, 1, fused=fused))
    return branch


def _global_apply(branch: nn.Module, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The global branch on ``x``, broadcast to ``like``'s shape (the
    nearest upsample of a 1x1 map)."""
    mean = shard.mean_hw(x)
    with shard.whole():
        return getattr(branch, "1")(mean).expand_as(like)


class RFB2(nn.Module):
    """Cascaded-dilation block, reference models/common.py:470-511.  With
    ``has_globel`` a fifth branch convolves the global mean of x2 (not of
    x) and broadcasts it (multiyolov5_tpu/models/blocks.py:590-628)."""

    def __init__(self, c1: int, c2: int, map_reduce: int = 4, d=(2, 3),
                 has_globel: bool = False, fused: bool = False, kernel: bool = False):
        super().__init__()
        inter = c1 // map_reduce
        self.branch0 = nn.Sequential(Conv(c1, inter, 1, fused=fused),
                                     Conv(inter, inter, 3, fused=fused, kernel=kernel))
        self.branch1 = ConvBN(inter, inter, d[0], fused, kernel)
        self.branch2 = ConvBN(inter, inter, d[1], fused, kernel)
        self.branch3 = nn.Sequential(Conv(c1, inter, 1, fused=fused))
        self.branch4 = _global_branch(inter, inter, fused) if has_globel else None
        self.ConvLinear = Conv((5 if has_globel else 4) * inter, c2, 1, fused=fused)

    def forward(self, x):
        x0 = self.branch0(x)
        x1 = self.branch1(x0)
        x2 = self.branch2(x1)
        xs = [x0, x1, x2, self.branch3(x)]
        if self.branch4 is not None:
            xs.append(_global_apply(self.branch4, x2, x0))
        return self.ConvLinear(torch.cat(xs, 1))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling, reference models/common.py:233-255:
    a 1x1 branch, three bias-free 3x3 + BN branches at dilations 3, 6 and 9
    (SegMaskLab's) and, with ``has_globel``, a global-mean branch, fused by
    a 1x1.  The dilated 3x3s stay cuDNN convolutions: the JAX package runs
    them in XLA (multiyolov5_tpu/models/blocks.py:513-533), and dilations 6
    and 9 lie outside K2's contract."""

    def __init__(self, c1: int, c2: int, has_globel: bool = True, map_reduce: int = 4,
                 fused: bool = False):
        super().__init__()
        hid = c1 // map_reduce
        self.branch0 = nn.Sequential(Conv(c1, hid, 1, fused=fused))
        self.branch1 = ConvBN(c1, hid, 3, fused)
        self.branch2 = ConvBN(c1, hid, 6, fused)
        self.branch3 = ConvBN(c1, hid, 9, fused)
        self.branch4 = _global_branch(c1, hid, fused) if has_globel else None
        self.ConvLinear = Conv((5 if has_globel else 4) * hid, c2, 1, fused=fused)

    def forward(self, x):
        x0 = self.branch0(x)
        xs = [x0, self.branch1(x), self.branch2(x), self.branch3(x)]
        if self.branch4 is not None:
            xs.append(_global_apply(self.branch4, x, x0))
        return self.ConvLinear(torch.cat(xs, 1))


class PyramidPooling(nn.Module):
    """reference models/common.py:514-539."""

    def __init__(self, c_in: int, k=(1, 2, 3, 6), fused: bool = False):
        super().__init__()
        for i in range(1, len(k) + 1):
            self.add_module(f"conv{i}", Conv(c_in, c_in // 4, 1, fused=fused))
        self.k = tuple(k)

    def forward(self, x):
        hw = tuple(x.shape[-2:])
        pools = adaptive_avg_pool_multi(x, self.k)
        with shard.whole():          # the pooled maps: whole on every rank
            ys = [getattr(self, f"conv{i}")(p) for i, p in enumerate(pools, start=1)]
        return torch.cat([x] + [resize_bilinear(y, hw, whole=True) for y in ys], 1)


class FFM(nn.Module):
    """Feature Fusion Module, reference models/common.py:210-230."""

    def __init__(self, c1: int, c2: int, reduction: int = 1, k: int = 1,
                 fused: bool = False, kernel: bool = False):
        super().__init__()
        self.convblk = Conv(c1, c2, k, fused=fused, kernel=kernel)
        self.channel_attention = nn.Module()
        self.channel_attention.add_module(
            "1", nn.Conv2d(c2, c2 // reduction, 1, bias=False))
        self.channel_attention.add_module(
            "3", nn.Conv2d(c2 // reduction, c2, 1, bias=False))

    def forward(self, x):
        feat = self.convblk(x)
        a = shard.mean_hw(feat)
        a = F.silu(getattr(self.channel_attention, "1")(a))
        a = torch.sigmoid(getattr(self.channel_attention, "3")(a))
        return feat * a + feat


class BottleneckCSP(nn.Module):
    """CSP bottleneck (reference models/common.py): bias-free 1x1s
    ``cv2`` and ``cv3``, a BN over their concat that no conv absorbs, then
    LeakyReLU 0.1 and ``cv4`` (multiyolov5_tpu/models/blocks.py:212-238)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5, fused: bool = False, kernel: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, fused=fused)
        self.cv2 = nn.Conv2d(c1, c_, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv4 = Conv(2 * c_, c2, 1, fused=fused)
        self.bn = _bn(2 * c_)
        self.m = nn.Sequential(*[Bottleneck(c_, c_, shortcut, 1.0, fused, kernel)
                                 for _ in range(n)])

    def forward(self, x):
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], 1)
        return self.cv4(F.leaky_relu(batch_norm(self.bn, y), 0.1))


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W.T (+ b)``, a product and an add as the JAX ``linear``
    (multiyolov5_tpu/models/blocks.py:288-294) computes them."""
    y = x @ lin.weight.t()
    return y if lin.bias is None else y + lin.bias


class TransformerLayer(nn.Module):
    """reference models/common.py:49-92 on (L, B, C) tokens: q, k, v
    projections, ``nn.MultiheadAttention``'s in-projection, ``num_heads``
    heads of plain batched products and a softmax, its out-projection,
    then two bias-free linears, each with its residual.  The arithmetic is
    the JAX ``transformer_layer``'s (multiyolov5_tpu/models/blocks.py:310-333)."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = nn.Module()
        self.ma.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.ma.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.ma.out_proj = nn.Linear(c, c)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)
        self.num_heads = num_heads

    def forward(self, x):
        wq, wk, wv = self.ma.in_proj_weight.chunk(3)
        bq, bk, bv = self.ma.in_proj_bias.chunk(3)
        q = _linear(self.q, x) @ wq.t() + bq
        k = _linear(self.k, x) @ wk.t() + bk
        v = _linear(self.v, x) @ wv.t() + bv
        n, b, c = q.shape
        hd = c // self.num_heads

        def heads(t):                      # (L, B, C) -> (B * heads, L, hd)
            return t.reshape(n, b * self.num_heads, hd).transpose(0, 1)

        attn = torch.softmax(heads(q) @ heads(k).transpose(1, 2) / math.sqrt(hd), -1)
        o = (attn @ heads(v)).transpose(0, 1).reshape(n, b, c)
        x = _linear(self.ma.out_proj, o) + x
        return _linear(self.fc2, _linear(self.fc1, x)) + x


class TransformerBlock(nn.Module):
    """reference models/common.py:49-92: an optional 1x1 Conv to c2, the
    map's pixels as tokens plus a learned linear of themselves, then
    ``num_layers`` TransformerLayers.  Every token attends to the whole map,
    so a sharded forward runs the layers on the gathered map and keeps this
    rank's rows (the gather's backward sums each token's gradient into the
    rank that holds it)."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int,
                 fused: bool = False):
        super().__init__()
        self.conv = Conv(c1, c2, 1, fused=fused) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*[TransformerLayer(c2, num_heads) for _ in range(num_layers)])
        self.c2 = c2

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        _, start, rows = shard.place(x.shape[2], x.shape[3])
        x = shard.gather_rows(x)
        b, _, h, w = x.shape
        p = x.flatten(2).permute(2, 0, 1)              # (L, B, C), pixels row-major
        y = self.tr(p + _linear(self.linear, p))
        return y.permute(1, 2, 0).reshape(b, self.c2, h, w).narrow(2, start, rows)


class C3TR(nn.Module):
    """C3 whose bottleneck chain is a TransformerBlock of 4 heads,
    reference models/common.py:155-160."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, fused=fused)
        self.cv2 = Conv(c1, c_, 1, fused=fused)
        self.cv3 = Conv(2 * c_, c2, 1, fused=fused)
        self.m = TransformerBlock(c_, c_, 4, n, fused=fused)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class GhostConv(nn.Module):
    """reference models/experimental.py GhostConv: a Conv to c2 / 2, then a
    5x5 depth-wise Conv of it, concatenated."""

    def __init__(self, c1: int, c2: int, k=1, s=1, act: bool = True, fused: bool = False):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, act=act, fused=fused)
        self.cv2 = Conv(c_, c_, 5, 1, g=c_, act=act, fused=fused)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """reference models/experimental.py GhostBottleneck: GhostConv, at
    stride 2 a depth-wise k x k Conv, GhostConv without activation; at
    stride 2 the shortcut is a depth-wise Conv and a 1x1 Conv, at stride 1
    x itself where c1 == c2 (multiyolov5_tpu/models/blocks.py:776-787)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, fused: bool = False):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential()
        self.conv.add_module("0", GhostConv(c1, c_, 1, 1, fused=fused))
        self.conv.add_module("1", DWConv(c_, c_, k, s, act=False, fused=fused)
                             if s == 2 else nn.Identity())
        self.conv.add_module("2", GhostConv(c_, c2, 1, 1, act=False, fused=fused))
        self.shortcut = (nn.Sequential(DWConv(c1, c1, k, s, act=False, fused=fused),
                                       Conv(c1, c2, 1, 1, act=False, fused=fused))
                         if s == 2 else None)
        self.add = c1 == c2

    def forward(self, x):
        y = self.conv(x)
        if self.shortcut is not None:
            return y + self.shortcut(x)
        return y + x if self.add else y


class CrossConv(nn.Module):
    """reference models/experimental.py CrossConv: a (1, k) then a (k, 1) Conv."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 e: float = 1.0, shortcut: bool = False, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, (1, k), (1, s), fused=fused)
        self.cv2 = Conv(c_, c2, (k, 1), (s, 1), g=g, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class MixConv2d(nn.Module):
    """reference models/experimental.py MixConv2d (equal channels): bias-free
    convs of kernels ``k`` over an equal split of c2, a BN over their concat
    that no conv absorbs, LeakyReLU 0.1 and the residual x + ... ."""

    def __init__(self, c1: int, c2: int, k=(1, 3), s: int = 1):
        super().__init__()
        idx = np.linspace(0, len(k) - 1e-6, c2).astype(int)
        c_ = [int((idx == g).sum()) for g in range(len(k))]
        self.m = nn.ModuleList(nn.Conv2d(c1, cc, kk, s, kk // 2, bias=False)
                               for kk, cc in zip(k, c_))
        self.bn = _bn(c2)

    def forward(self, x):
        y = torch.cat([shard.conv2d(m, x) for m in self.m], 1)
        return x + F.leaky_relu(batch_norm(self.bn, y), 0.1)


class Sum(nn.Module):
    """reference models/experimental.py Sum: x0 + x1 + ...; ``weight``
    scales input i + 1 by 2 sigmoid(w_i), w initialised to -i / 2."""

    def __init__(self, n: int, weight: bool = False):
        super().__init__()
        self.w = nn.Parameter(-torch.arange(1.0, n) / 2) if weight else None

    def forward(self, xs):
        y = xs[0]
        if self.w is not None:
            w = torch.sigmoid(self.w) * 2
            for i in range(len(xs) - 1):
                y = y + xs[i + 1] * w[i]
        else:
            for t in xs[1:]:
                y = y + t
        return y


class Classify(nn.Module):
    """reference models/common.py Classify: the global mean of each input,
    concatenated, a biased k x k conv, flattened to (B, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, 1, autopad(k), bias=True)

    def forward(self, x):
        xs = x if isinstance(x, (list, tuple)) else [x]
        with shard.whole():
            return self.conv(torch.cat([shard.mean_hw(t) for t in xs], 1)).flatten(1)


class Contract(nn.Module):
    """reference models/common.py Contract: (B, C, H, W) -> (B, C g^2, H/g, W/g)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.gain
        x = x.view(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, c * s * s, h // s, w // s)


class Expand(nn.Module):
    """reference models/common.py Expand: (B, C, H, W) -> (B, C / g^2, H g, W g)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.gain
        x = x.view(b, s, s, c // s ** 2, h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // s ** 2, h * s, w * s)


class BatchNorm2d(nn.BatchNorm2d):
    """An ``nn.BatchNorm2d`` row (keys ``model.<i>.weight``, ...): in eval
    mode, fused or not, it applies its running statistics as
    ops/nn.batch_norm does."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return super().forward(x) if self.training else batch_norm(self, x)


class MaxPool2d(nn.Module):
    """An ``nn.MaxPool2d(k, s, p)`` row, stride k by default."""

    def __init__(self, k: int, s=None, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = k, s or k, p

    def forward(self, x):
        return shard.max_pool2d(x, self.k, self.s, self.p)


class ZeroPad2d(nn.Module):
    """An ``nn.ZeroPad2d`` row: torch's (left, right, top, bottom), or one int."""

    def __init__(self, pad):
        super().__init__()
        self.pad = tuple(pad) if isinstance(pad, (list, tuple)) else (pad,) * 4

    def forward(self, x):
        return shard.zero_pad(x, self.pad)


class _BNConv(nn.Module):
    """Pre-activation BN + SiLU + bias-free conv of DAPPM's Sequentials
    (keys ``<name>.<bn_at>`` and ``<name>.<conv_at>``); the BN has no conv
    to fold into, so it stays in the fused build."""

    def __init__(self, c1: int, c2: int, k: int, bn_at: int, conv_at: int):
        super().__init__()
        self.add_module(str(bn_at), _bn(c1))
        self.add_module(str(conv_at), nn.Conv2d(c1, c2, k, 1, k // 2, bias=False))
        self.at = (str(bn_at), str(conv_at))

    def forward(self, x):
        bn, conv = (getattr(self, a) for a in self.at)
        return conv(F.silu(batch_norm(bn, x)))


class DAPPM(nn.Module):
    """Deep aggregation pyramid pooling, reference models/common.py:327-412,
    pre-activation ordering (multiyolov5_tpu/models/blocks.py:631-665):
    average pools 5/2, 9/4, 17/8 and global, each BN-SiLU-1x1'd, resized
    (bilinear, align corners) and refined by a BN-SiLU-3x3 on the sum with
    the scale before, compressed and added to a BN-SiLU-1x1 shortcut."""

    def __init__(self, c_in: int, c_branch: int, c_out: int):
        super().__init__()
        self.scale0 = _BNConv(c_in, c_branch, 1, 0, 2)
        for i in (1, 2, 3, 4):
            setattr(self, f"scale{i}", _BNConv(c_in, c_branch, 1, 1, 3))
            setattr(self, f"process{i}", _BNConv(c_branch, c_branch, 3, 0, 2))
        self.compression = _BNConv(c_branch * 5, c_out, 1, 0, 2)
        self.shortcut = _BNConv(c_in, c_out, 1, 0, 2)

    def forward(self, x):
        hw = tuple(x.shape[-2:])
        pools = [F.avg_pool2d(x, 5, 2, 2), F.avg_pool2d(x, 9, 4, 4),
                 F.avg_pool2d(x, 17, 8, 8), x.mean((2, 3), keepdim=True)]
        xl = [self.scale0(x)]
        for i, pool in enumerate(pools, start=1):
            t = resize_bilinear(getattr(self, f"scale{i}")(pool), hw) + xl[-1]
            xl.append(getattr(self, f"process{i}")(t))
        return self.compression(torch.cat(xl, 1)) + self.shortcut(x)


class _Branch(nn.Module):
    """One branch of RFB1 / ASPPs: ``convs`` at keys 0, 1, ..., then a
    bias-free 3x3 at dilation ``d`` and its BN at the next two keys, and
    SiLU."""

    def __init__(self, convs, c: int, d: int, fused: bool):
        super().__init__()
        for i, conv in enumerate(convs):
            self.add_module(str(i), conv)
        self.n = n = len(convs)
        self.add_module(str(n), nn.Conv2d(c, c, 3, 1, d, dilation=d, bias=fused))
        self.add_module(str(n + 1), None if fused else _bn(c))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, str(i))(x)
        y = shard.conv2d(getattr(self, str(self.n)), x)
        bn = getattr(self, str(self.n + 1))
        return F.silu(y if bn is None else bn(y))


class RFB1(nn.Module):
    """Receptive-field block (multiyolov5_tpu/models/blocks.py:562-587): a
    1x1 + 3x3 branch, three branches of a 1x1, a 3/3/5 Conv and a 3x3 at
    dilation 3/5/7, an optional global-mean branch, fused by a 1x1."""

    def __init__(self, c1: int, c2: int, map_reduce: int = 4, d=(3, 5, 7),
                 has_globel: bool = False, fused: bool = False):
        super().__init__()
        inter = c1 // map_reduce
        self.branch0 = nn.Sequential(Conv(c1, inter, 1, fused=fused),
                                     Conv(inter, inter, 3, fused=fused))
        for bi, kk, dd in zip((1, 2, 3), (3, 3, 5), d):
            setattr(self, f"branch{bi}", _Branch(
                [Conv(c1, inter, 1, fused=fused), Conv(inter, inter, kk, fused=fused)],
                inter, dd, fused))
        self.branch4 = _global_branch(c1, inter, fused) if has_globel else None
        self.Fusion = Conv((5 if has_globel else 4) * inter, c2, 1, fused=fused)

    def forward(self, x):
        x0 = self.branch0(x)
        xs = [x0, self.branch1(x), self.branch2(x), self.branch3(x)]
        if self.branch4 is not None:
            xs.append(_global_apply(self.branch4, x, x0))
        return self.Fusion(torch.cat(xs, 1))


class ASPPs(nn.Module):
    """ASPP with 1x1 reductions first (multiyolov5_tpu/models/blocks.py:536-559):
    a 1x1 + 3x3 branch, three branches of a 1x1 and a 3x3 at dilation
    3/6/9, a global-mean branch, fused by a 1x1."""

    def __init__(self, c1: int, c2: int, d=(3, 6, 9), has_globel: bool = True,
                 map_reduce: int = 4, fused: bool = False):
        super().__init__()
        hid = c1 // map_reduce
        self.branch0 = nn.Sequential(Conv(c1, hid, 1, fused=fused),
                                     Conv(hid, hid, 3, fused=fused))
        for bi, dd in zip((1, 2, 3), d):
            setattr(self, f"branch{bi}",
                    _Branch([Conv(c1, hid, 1, fused=fused)], hid, dd, fused))
        self.branch4 = _global_branch(c1, hid, fused) if has_globel else None
        self.ConvLinear = Conv((5 if has_globel else 4) * hid, c2, 1, fused=fused)

    def forward(self, x):
        x0 = self.branch0(x)
        xs = [x0, self.branch1(x), self.branch2(x), self.branch3(x)]
        if self.branch4 is not None:
            xs.append(_global_apply(self.branch4, x, x0))
        return self.ConvLinear(torch.cat(xs, 1))
