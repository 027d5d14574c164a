"""K2: NHWC 3x3 conv + bias (+ SiLU), stride 1/2, dilation 1/2/3.

Counterpart of ``conv3x3_silu_pallas`` / ``conv3x3s2_silu_pallas``
(multiyolov5_tpu/ops/pallas/conv3x3_kernel.py:98, :153) and
``conv3x3_packed_pallas`` (multiyolov5_tpu/ops/pallas/c3_kernel.py:270).
The kernel is ``csrc/conv3x3.cu``; its design notes are there.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


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
    (bfloat16 also Co % 8 == 0), w contiguous OHWI of x's dtype, b
    contiguous float32."""
    if not build.on_device(x, "conv3x3"):
        return conv3x3_plain(x, w, b, stride, dilation, act)
    build.require(x.dim() == 4 and x.is_contiguous(), "conv3x3: x must be contiguous NHWC")
    bsz, h, wd, ci = x.shape
    build.require(x.dtype in _DTYPES, f"conv3x3: dtype {x.dtype}")
    co = w.shape[0]
    build.require(ci % 16 == 0, f"conv3x3: c_in {ci} is not a multiple of 16")
    build.require(x.dtype != torch.bfloat16 or co % 8 == 0,
                  f"conv3x3: bf16 needs c_out % 8 == 0, got {co}")
    build.require(tuple(w.shape) == (co, 3, 3, ci) and w.is_contiguous()
                  and w.dtype == x.dtype and w.device == x.device,
                  f"conv3x3: weight {tuple(w.shape)} {w.dtype}")
    build.require(tuple(b.shape) == (co,) and b.dtype == torch.float32
                  and b.is_contiguous() and b.device == x.device,
                  "conv3x3: bias must be contiguous float32 (c_out,)")
    build.require(stride in (1, 2) and dilation in (1, 2, 3),
                  f"conv3x3: stride {stride}, dilation {dilation}")
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    y = torch.empty((bsz, ho, wo, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        fn = build.function("mk_conv3x3", _ARGTYPES)
        err = fn(build.ptr(x), build.ptr(w), build.ptr(b), build.ptr(y),
                 bsz, h, wd, ci, ho, wo, co, stride, dilation, int(act),
                 _DTYPES[x.dtype], build.stream_of(x))
    build.check(err, "conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
