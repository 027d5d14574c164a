"""K1: the folded stem from the frame.

On a uint8 frame, the counterpart of ``stem_apply_pallas_u8`` and
``stem_apply_pallas_u8_multi`` (multiyolov5_tpu/ops/pallas/stem_kernel.py:141,
:308), with the /255 folded into w1; on a float32 or bfloat16 frame in
[0, 1], of ``stem_apply_pallas`` (:415), with w1 unscaled.  Frames of 1
to ``MAX_CHANNELS`` channels, as the TPU kernels take any ``c_in``.  The
kernel is ``csrc/stem.cu``; its design notes are there.  The two modes count their
launches apart: ``stem.launches`` (uint8) and ``stem_float.launches``.

Both output types run on the tensor cores, each from a copy of the weights
packed in its mma's fragment order, made once and kept on the w1 tensor.
A bfloat16 output computes as the TPU kernel does in bf16: bf16 operands,
float32 accumulation, a bf16 y1 (:func:`pack_weights`).  A float32 output
computes to float32 accuracy by 3xTF32: each operand split into tf32 hi
and lo parts, three products a MAC (two for conv1 on a uint8 or bfloat16
frame, exact in tf32), float32 accumulation (:func:`pack_weights_tf32`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
CHUNK = 64          # c_mid channels both forms compute at a time
MAX_COUT = 160      # the widest c_out their conv2 accumulators take (x width)
MAX_CHANNELS = 13   # the most frame channels whose float32 patch fits in shared memory


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
    """frame (B, H, W, C), uint8 (w1 with /255 folded in) or float in
    [0, 1] (w1 unscaled); w1 (3, 3, 16 C, c_mid) HWIO; w2 (2, 2, c_mid,
    c_out) HWIO; float32 weights and biases.  Returns (B, H/4, W/4, c_out) in
    ``out_dtype``, computed in float32.

    A bfloat16 output rounds as the TPU kernel does in bf16
    (``stem_kernel.py:75-95``, ``:178-181``, ``:212-214``, ``:415-423``): the
    frame, w1 and w2 to bf16, products and sums in float32, float32 biases,
    y1 rounded to bf16 after its SiLU."""
    x = space_to_depth4(frame).float()
    w1, w2 = w1.permute(3, 2, 0, 1), w2.permute(3, 2, 0, 1)
    bf16 = out_dtype == torch.bfloat16
    if bf16:
        x, w1, w2 = (t.to(torch.bfloat16).float() for t in (x, w1, w2))
    y = F.silu(F.conv2d(x, w1, b1, padding=1))
    if bf16:
        y = y.to(torch.bfloat16).float()
    y = F.pad(y, (1, 0, 1, 0))       # conv2's halo pads the activated map
    y = F.silu(F.conv2d(y, w2, b2))
    return y.permute(0, 2, 3, 1).to(out_dtype)


def pack_weights(w1: torch.Tensor, w2: torch.Tensor):
    """The tensor-core form's weights: bf16 copies of w1 (3, 3, 16 C, c_mid)
    and w2 (2, 2, c_mid, c_out) in the B-fragment order of mma m16n8k16,
    so that each lane of a warp reads its four registers of two 8-column
    tiles as one 16-byte load.  c_mid is padded to a multiple of CHUNK and
    c_out to a multiple of 32 with zeros (a pad channel of y1 is SiLU(0) = 0
    and meets zero weights).

    Returns bf16 (p1, p2): p1 [chunk][9 C k16][4 n16][g 8][t 4][nt 2][h
    2][e 2] holds w1.reshape(144 C, c_mid)[16 * k16 + 8 * h + 2 * t + e][CHUNK
    * chunk + 16 * n16 + 8 * nt + g], p2 [chunk][4 tap][4 k16][c_out_p / 16
    n16][g][t][nt][h][e] holds w2.reshape(4, c_mid, c_out)[tap][CHUNK *
    chunk + 16 * k16 + 8 * h + 2 * t + e][16 * n16 + 8 * nt + g]."""
    c_mid, c_out = w1.shape[-1], w2.shape[-1]
    cm_p = -(-c_mid // CHUNK) * CHUNK
    co_p = -(-c_out // 32) * 32
    nch, k = cm_p // CHUNK, 9 * w1.shape[2]
    b1m = F.pad(w1.reshape(k, c_mid), (0, cm_p - c_mid)).to(torch.bfloat16)
    p1 = (b1m.reshape(k // 16, 2, 4, 2, nch, 4, 2, 8)     # k16 h t e | ch n16 nt g
          .permute(4, 0, 5, 7, 2, 6, 1, 3).contiguous())
    b2m = F.pad(w2.reshape(4, c_mid, c_out), (0, co_p - c_out, 0, cm_p - c_mid))
    p2 = (b2m.to(torch.bfloat16)
          .reshape(4, nch, 4, 2, 4, 2, co_p // 16, 2, 8)   # tap ch k16 h t e | n16 nt g
          .permute(1, 0, 2, 6, 8, 4, 7, 3, 5).contiguous())
    return p1, p2


def tf32_split(w: torch.Tensor):
    """(hi, lo) of a float32 tensor: hi = w rounded to tf32 (10 mantissa
    bits; to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), lo =
    w - hi rounded the same way, so that |w - (hi + lo)| <= 2^-22 |w|.
    Float32 bit arithmetic: the low 13 mantissa bits are cleared after
    adding half of their range to the magnitude."""
    def rna(x):
        return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(w)
    return hi, rna(w - hi)


def pack_weights_tf32(w1: torch.Tensor, w2: torch.Tensor):
    """The float32 form's weights: w1 (3, 3, 16 C, c_mid) and w2 (2, 2,
    c_mid, c_out), split by :func:`tf32_split` into tf32 hi and lo parts, in the
    B-fragment order of mma m16n8k8 (b0 = (k = t, n = g), b1 = (k = t + 4,
    n = g) for lane 4 g + t), so that each lane reads the registers of two
    8-column tiles of one part as one 16-byte load, the hi load and the lo
    load 512 bytes apart.  c_mid is padded to a multiple of CHUNK and c_out
    to a multiple of 32 with zeros, as in :func:`pack_weights`.

    Returns float32 (p1, p2): p1 [chunk][18 C k8][4 n16][part 2][g 8][t
    4][nt 2][h 2] holds part(w1.reshape(144 C, c_mid))[8 * k8 + 4 * h + t][CHUNK *
    chunk + 16 * n16 + 8 * nt + g], p2 [chunk][4 tap][8 k8][c_out_p / 16
    n16][part][g][t][nt][h] holds part(w2.reshape(4, c_mid, c_out))[tap][CHUNK
    * chunk + 8 * k8 + 4 * h + t][16 * n16 + 8 * nt + g], part 0 hi, 1 lo."""
    c_mid, c_out = w1.shape[-1], w2.shape[-1]
    cm_p = -(-c_mid // CHUNK) * CHUNK
    co_p = -(-c_out // 32) * 32
    nch, k = cm_p // CHUNK, 9 * w1.shape[2]
    b1m = torch.stack(tf32_split(F.pad(w1.reshape(k, c_mid), (0, cm_p - c_mid))))
    p1 = (b1m.reshape(2, k // 8, 2, 4, nch, 4, 2, 8)      # part k8 h t | ch n16 nt g
          .permute(4, 1, 5, 0, 7, 3, 6, 2).contiguous())
    b2m = F.pad(w2.reshape(4, c_mid, c_out), (0, co_p - c_out, 0, cm_p - c_mid))
    p2 = (torch.stack(tf32_split(b2m))
          .reshape(2, 4, nch, 8, 2, 4, co_p // 16, 2, 8)   # part tap ch k8 h t | n16 nt g
          .permute(2, 1, 3, 6, 0, 8, 5, 7, 4).contiguous())
    return p1, p2


_PACKERS = {torch.bfloat16: pack_weights, torch.float32: pack_weights_tf32}


def _packed(w1: torch.Tensor, w2: torch.Tensor, out_dtype: torch.dtype):
    """The packed weights of the form that computes ``out_dtype`` (its
    packer in ``_PACKERS``), kept on ``w1`` per form for the next call with
    the same ``w2`` while both versions stay (an in-place update repacks)."""
    def version(t):     # an inference tensor has no version counter
        return -1 if t.is_inference() else t._version

    key = (w2, version(w1), version(w2))
    cache = getattr(w1, "_k1_packed", None)
    if cache is None:
        cache = w1._k1_packed = {}
    hit = cache.get(out_dtype)
    if hit is None or hit[0] is not w2 or hit[1:3] != key[1:]:
        hit = cache[out_dtype] = (*key, _PACKERS[out_dtype](w1, w2))
    return hit[3]


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
    build.require(frame.dim() == 4 and 1 <= frame.shape[-1] <= MAX_CHANNELS
                  and frame.is_contiguous(),
                  f"stem: frame must be contiguous (B, H, W, C), 1 <= C <= {MAX_CHANNELS}")
    bsz, h, w, ch = frame.shape
    build.require(h % 4 == 0 and w % 4 == 0, f"stem: frame {h}x{w} not a multiple of 4")
    c_mid, c_out = w1.shape[-1], w2.shape[-1]
    for t, shape in ((w1, (3, 3, 16 * ch, c_mid)), (b1, (c_mid,)),
                     (w2, (2, 2, c_mid, c_out)), (b2, (c_out,))):
        build.require(tuple(t.shape) == shape and t.dtype == torch.float32
                      and t.is_contiguous() and t.device == frame.device,
                      f"stem: weight {tuple(t.shape)} {t.dtype}, want {shape} float32")
    build.require(out_dtype in (torch.float32, torch.bfloat16), f"stem: dtype {out_dtype}")
    build.require(c_out % 2 == 0 and c_out <= MAX_COUT,
                  f"stem: takes an even c_out <= {MAX_COUT}, got {c_out}")
    out = torch.empty((bsz, h // 4, w // 4, c_out), dtype=out_dtype,
                      device=frame.device)
    with torch.cuda.device(frame.device):
        p1, p2 = _packed(w1, w2, out_dtype)
        fn = build.function("mk_stem_tc" if out_dtype == torch.bfloat16 else "mk_stem_tf32",
                            _ARGTYPES)
        err = fn(build.ptr(frame), *map(build.ptr, (p1, b1, p2, b2)), build.ptr(out), bsz,
                 h // 4, w // 4, c_mid, c_out, ch, _DTYPES[frame.dtype],
                 build.stream_of(frame))
    build.check(err, "stem")
    return out


stem.launches = 0
stem_float.launches = 0
