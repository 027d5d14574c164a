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
(parallel/spatial.py) turns into halo exchanges and gathers.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import shard
from ..ops.kernels import c3, conv3x3
from ..ops.nn import BN_EPS, BN_MOMENTUM, autopad
from ..ops.resize import adaptive_avg_pool_multi, max_pool_same, resize_bilinear, upsample_nearest


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
    """reference models/common.py:34-46: conv + BN + SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1,
                 fused: bool = False, kernel: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, d), dilation=d, bias=fused)
        self.bn = None if fused else _bn(c2)
        self.kernel = kernel and fused and k == 3

    def forward(self, x):
        if self.kernel:
            return conv3x3_k2(self.conv, x, True)
        y = shard.conv2d(self.conv, x)
        if self.bn is not None:
            y = self.bn(y)
        return F.silu(y)


class ConvBN(nn.Module):
    """Bare ``nn.Sequential(Conv2d, BatchNorm2d)`` + SiLU inside RFB2 and ASPP
    (keys ``<name>.0.weight``, ``<name>.1.running_mean``)."""

    def __init__(self, c1: int, c2: int, d: int = 1, fused: bool = False,
                 kernel: bool = False):
        super().__init__()
        self.add_module("0", nn.Conv2d(c1, c2, 3, 1, d, dilation=d, bias=fused))
        self.add_module("1", None if fused else _bn(c2))
        self.kernel = kernel and fused

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
    """``nn.Upsample(None, scale, 'nearest')`` rows of the neck."""

    def __init__(self, scale: int, mode: str = "nearest"):
        super().__init__()
        if mode != "nearest":
            raise NotImplementedError(f"Upsample mode {mode!r}")
        self.scale = int(scale)

    def forward(self, x):
        return upsample_nearest(x, self.scale)


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
