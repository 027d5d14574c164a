"""K1: the folded stem from the frame.

On a uint8 frame, the counterpart of ``stem_apply_pallas_u8`` and
``stem_apply_pallas_u8_multi`` (multiyolov5_tpu/ops/pallas/stem_kernel.py:141,
:308), with the /255 folded into w1; on a float32 or bfloat16 frame in
[0, 1], of ``stem_apply_pallas`` (:415), with w1 unscaled.  The kernel is
``csrc/stem.cu``; its design notes are there.  The two modes count their
launches apart: ``stem.launches`` (uint8) and ``stem_float.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def space_to_depth4(frame: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 16*C, H/4, W/4): two 2x2 space-to-depths, phase
    order [ee, oe, eo, oo] (H-offset first) at both levels, so channel
    (p + 2q) * 4C + (r + 2s) * C + c holds pixel (4U + 2p + r, 4V + 2q + s).
    ``F.pixel_unshuffle`` orders the channels differently."""
    b, h, w, c = frame.shape
    x = frame.reshape(b, h // 4, 2, 2, w // 4, 2, 2, c)   # B U p r V q s c
    return x.permute(0, 5, 2, 6, 3, 7, 1, 4).reshape(b, 16 * c, h // 4, w // 4)


def stem_plain(frame: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """frame (B, H, W, 3), uint8 (w1 with /255 folded in) or float in
    [0, 1] (w1 unscaled); w1 (3, 3, 48, c_mid) HWIO; w2 (2, 2, c_mid, c_out)
    HWIO; float32 weights and biases.  Returns (B, H/4, W/4, c_out) in
    ``out_dtype``, computed in float32."""
    x = space_to_depth4(frame).float()
    y = F.silu(F.conv2d(x, w1.permute(3, 2, 0, 1), b1, padding=1))
    y = F.pad(y, (1, 0, 1, 0))       # conv2's halo pads the activated map
    y = F.silu(F.conv2d(y, w2.permute(3, 2, 0, 1), b2))
    return y.permute(0, 2, 3, 1).to(out_dtype)


def stem(frame: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
         w2: torch.Tensor, b2: torch.Tensor,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1 on a CUDA frame, :func:`stem_plain` on a CPU frame.  The mode
    follows ``frame.dtype``: uint8 (w1 with /255 folded in), or float32 /
    bfloat16 in [0, 1] (w1 unscaled), which :func:`stem_float` launches."""
    if frame.is_floating_point():
        return stem_float(frame, w1, b1, w2, b2, out_dtype)
    if not build.on_device(frame, "stem"):
        return stem_plain(frame, w1, b1, w2, b2, out_dtype)
    build.require(frame.dtype == torch.uint8, f"stem: frame dtype {frame.dtype}")
    out = _launch(frame, w1, b1, w2, b2, out_dtype)
    stem.launches += 1
    return out


def stem_float(frame: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1's float mode (B1c) on a CUDA float32 or bfloat16 frame in [0, 1]
    with w1 unscaled; :func:`stem_plain` on a CPU frame."""
    if not build.on_device(frame, "stem_float"):
        return stem_plain(frame, w1, b1, w2, b2, out_dtype)
    build.require(frame.dtype in (torch.float32, torch.bfloat16),
                  f"stem: float mode takes float32 or bfloat16 frames, got {frame.dtype}")
    out = _launch(frame, w1, b1, w2, b2, out_dtype)
    stem_float.launches += 1
    return out


def _launch(frame, w1, b1, w2, b2, out_dtype):
    build.require(frame.dim() == 4 and frame.shape[-1] == 3 and frame.is_contiguous(),
                  "stem: frame must be contiguous (B, H, W, 3)")
    bsz, h, w, _ = frame.shape
    build.require(h % 4 == 0 and w % 4 == 0, f"stem: frame {h}x{w} not a multiple of 4")
    c_mid, c_out = w1.shape[-1], w2.shape[-1]
    for t, shape in ((w1, (3, 3, 48, c_mid)), (b1, (c_mid,)),
                     (w2, (2, 2, c_mid, c_out)), (b2, (c_out,))):
        build.require(tuple(t.shape) == shape and t.dtype == torch.float32
                      and t.is_contiguous() and t.device == frame.device,
                      f"stem: weight {tuple(t.shape)} {t.dtype}, want {shape} float32")
    build.require(out_dtype in (torch.float32, torch.bfloat16), f"stem: dtype {out_dtype}")
    smem = (11 * 11 * 48 + 81 * c_mid) * 4
    build.require(smem <= 227 * 1024, f"stem: c_mid {c_mid} too wide")
    out = torch.empty((bsz, h // 4, w // 4, c_out), dtype=out_dtype,
                      device=frame.device)
    with torch.cuda.device(frame.device):
        fn = build.function("mk_stem", _ARGTYPES)
        err = fn(build.ptr(frame), build.ptr(w1), build.ptr(b1), build.ptr(w2),
                 build.ptr(b2), build.ptr(out), bsz, h // 4, w // 4, c_mid,
                 c_out, _DTYPES[frame.dtype], _DTYPES[out_dtype],
                 build.stream_of(frame))
    build.check(err, "stem")
    return out


stem.launches = 0
stem_float.launches = 0
