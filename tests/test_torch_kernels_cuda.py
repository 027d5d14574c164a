"""The seven Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test decides inside itself whether a card is present
and skips otherwise.  Run on a machine with an H100 by ``pytest -m cuda
tests/test_torch_kernels_cuda.py``.  Inputs are seeded, at small shapes.
Bounds: float32 max |diff| 1e-4 (summation order; TF32 off), bfloat16
2e-2 relative to the output's scale (one bf16 rounding of the output and of
the conv input), NMS keep masks and greedy picks equal, class-map mismatch
share <= 1e-4.  K6 (seg_ce): the loss within 1e-4 relative (float32 sums
in another order; its bf16 input is the same for both), dz within 1e-4
(float32) or 1e-2 (bf16: one rounding of each side's float32 value) of
max |dz|; all-ignored labels give exactly 0 and a zero gradient; at the
train step's shape with 20% and 90% ignored labels and class weights,
labels >= C (as ignored: bitwise the same as -1), resizes at ratios other
than 8 and sizes no multiple of any tile; planar and channels-last logits
give bitwise equal loss and dz, two calls bitwise equal dz, and every tile
of ``FWD_PLANS`` and ``BWD_PLANS`` through the C entry the plain version's
loss and dz (dz bitwise the same under every plan).  K7 (c3,
bf16 products for bf16, 3xTF32 for float32): the float32 and bf16 bounds
above, at pspv5s's and pspv5m's C3 widths, c_ 8, 16 and 24, four
bottlenecks, c2 != c1, c1 128, a 1 x 1 image, H x W that are no multiple of
any tile, and no shortcut; both forms in turns on the same weights; the
bf16 form's persistent grid with fewer CTAs than tiles, batch 1, one to
four bottlenecks, c_ 8 to 48, c1 96 and 128, each bitwise the same on a
second launch.  K1's float
mode: float32 and bfloat16 frames in [0, 1] at s and x width (c_mid 128,
320), the bounds above.  K2 in bf16 at c_in 48 (SegMaskLab's detail conv,
the BK = 16 path).  K2's planned launches: a 6-way (bf16) or 8-way (float32)
cluster split at pspv5s's 1/32-res site, odd H x W, stride 2 at odd sizes,
dilation 3, c_out 8 and 24, in both dtypes.  K3: keep mask and packed
output equal to the plain versions at n 1, 31, 33 and 1024 on crowded
lists, the deepest chain and all-invalid lists, max_det below and above
the kept count, under every cluster size.  K4: every tile of its
``TILES`` at C 1, 19 and 256 in both dtypes, bs1 serving's bands, ragged
frames and bands of 1 and 8 taps: the same class map bit for bit under
every tile and on a second launch.
K2's float32 form (3xTF32):
c_in 48 (BK 16), pspv5x's c_in 640 -> 640 at stride 1 and 2, FFM's (4, 64,
128, 256) -> 128, H x W that are no multiple of the 8x16 tile, each split
1-8 through the C entry with an explicit plan, a float32 launch between two
bf16 launches on the same weights (bf16 outputs bitwise equal), and,
against float64 at eval's site shapes, no more than twice cuDNN float32's
(TF32 off) max error.  K1's two forms (bfloat16 output, and the 3xTF32
float32 output) at c_mid 32, 128, 192 and 320 on uint8 and float32
frames, at B = 3 with H/4 and W/4 that are no multiple of their 8x16
tile, held to the bounds above against ``stem_plain`` (which rounds as the
bf16 form does), and both forms in turns on the same weight tensors.  K5
(greedy NMS over a thread-block cluster an image), picks equal to
``nms_greedy_plain``'s: each cluster size (1-16) and CTA size through the C
entry with an explicit plan, boxes in shared and in device memory; ties
straddling slice edges with picks in several slices; n no multiple of 32
or of the slice; an all-invalid image beside full ones, picks that run out
before max_det, max_det 1; eight 30000-row lists; one list long enough for
the device-memory form."""

import importlib

import numpy as np
import pytest
import torch

from multiyolov5_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    scale = max(want.abs().max().item(), 1.0)
    bound = 1e-4 if dtype == torch.float32 else 2e-2 * scale
    assert (got - want).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernel(dev, dtype):
    g = torch.Generator().manual_seed(0)
    frame = torch.randint(0, 256, (2, 64, 96, 3), generator=g, dtype=torch.uint8)
    w1 = torch.randn(3, 3, 48, 128, generator=g) * 0.002
    b1 = torch.randn(128, generator=g) * 0.1
    w2 = torch.randn(2, 2, 128, 64, generator=g) * 0.05
    b2 = torch.randn(64, generator=g) * 0.1
    args = [t.to(dev).contiguous() for t in (frame, w1, b1, w2, b2)]
    got = K.stem(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    _close(got, K.stem_plain(*args, out_dtype=dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frame_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_mid,c_out", [(128, 64), (320, 160)])
def test_stem_kernel_float_mode(dev, dtype, frame_dtype, c_mid, c_out):
    g = torch.Generator().manual_seed(c_mid)
    frame = torch.rand(2, 64, 96, 3, generator=g).to(frame_dtype)
    w1 = torch.randn(3, 3, 48, c_mid, generator=g) * 0.2
    b1 = torch.randn(c_mid, generator=g) * 0.1
    w2 = torch.randn(2, 2, c_mid, c_out, generator=g) * 0.05
    b2 = torch.randn(c_out, generator=g) * 0.1
    args = [t.to(dev).contiguous() for t in (frame, w1, b1, w2, b2)]
    K.reset_launches()
    got = K.stem(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert (K.stem.launches, K.stem_float.launches) == (0, 1)
    _close(got, K.stem_plain(*args, out_dtype=dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,dil,act", [(1, 1, True), (1, 2, True), (1, 3, False),
                                            (2, 1, True)])
def test_conv3x3_kernel(dev, dtype, stride, dil, act):
    g = torch.Generator().manual_seed(stride * 10 + dil)
    x = torch.randn(2, 20, 36, 64, generator=g).to(dev, dtype)
    w = (torch.randn(96, 3, 3, 64, generator=g) * 0.05).to(dev, dtype)
    b = (torch.randn(96, generator=g) * 0.1).to(dev)
    got = K.conv3x3(x, w, b, stride, dil, act)
    torch.cuda.synchronize()
    _close(got, K.conv3x3_plain(x, w, b, stride, dil, act), dtype)


@pytest.mark.parametrize("ci,co", [(48, 48), (16, 24)])
def test_conv3x3_kernel_bf16_c_in_16(dev, ci, co):
    g = torch.Generator().manual_seed(ci)
    x = torch.randn(1, 32, 64, ci, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(co, 3, 3, ci, generator=g) * 0.05).to(dev, torch.bfloat16)
    b = (torch.randn(co, generator=g) * 0.1).to(dev)
    got = K.conv3x3(x, w, b)
    torch.cuda.synchronize()
    _close(got, K.conv3x3_plain(x, w, b), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,co,stride,dil", [
    ((1, 16, 32, 256), 256, 1, 1),     # pspv5s 1/32 res: a 6- (bf16) or 8-way split
    ((2, 37, 23, 64), 64, 1, 1),       # odd H x W
    ((1, 33, 47, 128), 128, 2, 1),     # stride 2, odd sizes
    ((1, 24, 40, 64), 64, 1, 3),       # dilation 3
    ((1, 20, 36, 32), 8, 1, 1),        # c_out 8
    ((2, 19, 21, 48), 24, 2, 2),       # c_out 24, c_in 48 (BK 16)
])
def test_conv3x3_kernel_planned(dev, dtype, shape, co, stride, dil):
    from multiyolov5_tpu_torch.ops.kernels.conv3x3 import plan
    g = torch.Generator().manual_seed(co + stride * 7 + dil)
    x = torch.randn(*shape, generator=g).to(dev, dtype)
    w = (torch.randn(co, 3, 3, shape[-1], generator=g) / (9 * shape[-1]) ** 0.5).to(dev, dtype)
    b = (torch.randn(co, generator=g) * 0.1).to(dev)
    ho, wo = (shape[1] - 1) // stride + 1, (shape[2] - 1) // stride + 1
    p = plan(shape[0], ho, wo, shape[-1], co, dtype, stride, dil)
    if shape == (1, 16, 32, 256):       # bf16: 6 (divides its 36 K steps); float32: 8
        assert p.split == (6 if dtype == torch.bfloat16 else 8) and p.ctas >= 132
    got = K.conv3x3(x, w, b, stride, dil, True)
    torch.cuda.synchronize()
    _close(got, K.conv3x3_plain(x, w, b, stride, dil, True), dtype)


def _conv_case(seed, shape, co, dev, dtype=torch.float32):
    """Seeded x (unit normal) and OHWI w scaled to unit-variance outputs."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g)
    w = torch.randn(co, 3, 3, shape[-1], generator=g) / (9 * shape[-1]) ** 0.5
    b = torch.randn(co, generator=g) * 0.1
    return x.to(dev, dtype), w.to(dev, dtype), b.to(dev)


@pytest.mark.parametrize("shape,co,stride", [
    ((1, 32, 64, 48), 48, 1),          # SegMaskLab's detail conv: BK 16
    ((2, 19, 21, 48), 24, 2),
    ((1, 16, 32, 640), 640, 1),        # pspv5x's 1/32-res sites
    ((1, 32, 64, 640), 640, 2),
    ((4, 64, 128, 256), 128, 1),       # FFM at eval's bs4
    ((3, 45, 70, 64), 64, 1),          # H x W no multiple of 8x16 (or 8x8)
    ((2, 29, 51, 128), 128, 2),
])
def test_conv3x3_kernel_f32_sites(dev, shape, co, stride):
    x, w, b = _conv_case(co + stride, shape, co, dev)
    got = K.conv3x3(x, w, b, stride)
    torch.cuda.synchronize()
    _close(got, K.conv3x3_plain(x, w, b, stride), torch.float32)


@pytest.mark.parametrize("split", list(range(1, 9)))
@pytest.mark.parametrize("bm,bn", [(64, 64), (128, 64), (64, 128)])
def test_conv3x3_kernel_f32_each_split(dev, split, bm, bn):
    """Every cluster split through the C entry with an explicit plan."""
    kmod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.conv3x3")
    shape, co = (1, 20, 36, 128), 128
    x, w, b = _conv_case(split, shape, co, dev)
    tiles = -(-20 // 8) * -(-36 // (bm // 8)) * -(-co // bn)
    nk = 9 * shape[-1] // 32
    p = kmod.Plan(bm, bn, 32, split, tiles, tiles * split, -(-nk // split))
    got = kmod._launch(x, w, b, 1, 1, True, p)
    torch.cuda.synchronize()
    _close(got, K.conv3x3_plain(x, w, b), torch.float32)


def test_conv3x3_kernel_f32_between_bf16(dev):
    """A float32 launch between two bf16 launches on the same weights: the
    bf16 outputs are bitwise equal, the float32 one within its bound."""
    x, w, b = _conv_case(7, (2, 32, 64, 128), 128, dev)
    x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
    first = K.conv3x3(x16, w16, b)
    got = K.conv3x3(x, w, b)
    again = K.conv3x3(x16, w16, b)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), again.view(torch.int16))
    _close(got, K.conv3x3_plain(x, w, b), torch.float32)
    _close(first, K.conv3x3_plain(x16, w16, b), torch.bfloat16)


@pytest.mark.parametrize("shape,co,stride,dil", [
    ((4, 32, 64, 128), 128, 1, 1), ((4, 64, 128, 64), 64, 1, 3),
    ((4, 64, 128, 128), 128, 2, 1), ((4, 32, 64, 256), 256, 2, 1),
    ((4, 16, 32, 256), 256, 1, 1), ((4, 64, 128, 256), 128, 1, 1),
])
def test_conv3x3_kernel_f32_against_float64(dev, shape, co, stride, dil):
    """At eval's site shapes the 3xTF32 form errs against float64 by no more
    than twice what cuDNN float32 (TF32 off) does."""
    x, w, b = _conv_case(co * stride + dil, shape, co, dev)
    ref = K.conv3x3_plain(x.double(), w.double(), b.double(), stride, dil)
    err_k2 = (K.conv3x3(x, w, b, stride, dil).double() - ref).abs().max().item()
    err_cudnn = (K.conv3x3_plain(x, w, b, stride, dil).double() - ref).abs().max().item()
    assert err_k2 <= 2 * err_cudnn, (err_k2, err_cudnn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frame_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("c_mid,c_out", [(32, 16), (128, 64), (192, 96), (320, 160)])
def test_stem_kernel_bf16_widths(dev, dtype, frame_dtype, c_mid, c_out):
    g = torch.Generator().manual_seed(c_mid + 1)
    if frame_dtype == torch.uint8:
        frame = torch.randint(0, 256, (3, 44, 76, 3), generator=g, dtype=torch.uint8)
        scale = 0.2 / 255
    else:
        frame = torch.rand(3, 44, 76, 3, generator=g)
        scale = 0.2
    w1 = torch.randn(3, 3, 48, c_mid, generator=g) * scale
    b1 = torch.randn(c_mid, generator=g) * 0.1
    w2 = torch.randn(2, 2, c_mid, c_out, generator=g) / (4 * c_mid) ** 0.5
    b2 = torch.randn(c_out, generator=g) * 0.1
    args = [t.to(dev).contiguous() for t in (frame, w1, b1, w2, b2)]
    got = K.stem(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.shape == (3, 11, 19, c_out) and got.dtype == dtype
    _close(got, K.stem_plain(*args, out_dtype=dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frame_dtype", [torch.uint8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ch", [1, 2, 4, 13])
def test_stem_kernel_channels(dev, dtype, frame_dtype, ch):
    """K1 on frames of other channel counts (C a kernel argument), odd
    geometry, against stem_plain; a frame wider than K1 reads raises."""
    g = torch.Generator().manual_seed(ch)
    if frame_dtype == torch.uint8:
        frame = torch.randint(0, 256, (3, 44, 76, ch), generator=g, dtype=torch.uint8)
        scale = 0.2 / 255
    else:
        frame = torch.rand(3, 44, 76, ch, generator=g).to(frame_dtype)
        scale = 0.2
    w1 = torch.randn(3, 3, 16 * ch, 128, generator=g) * scale * (3 / ch) ** 0.5
    b1 = torch.randn(128, generator=g) * 0.1
    w2 = torch.randn(2, 2, 128, 64, generator=g) / 16
    b2 = torch.randn(64, generator=g) * 0.1
    args = [t.to(dev).contiguous() for t in (frame, w1, b1, w2, b2)]
    got = K.stem(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.shape == (3, 11, 19, 64) and got.dtype == dtype
    _close(got, K.stem_plain(*args, out_dtype=dtype), dtype)
    wide = torch.zeros(1, 8, 8, 14, dtype=frame_dtype, device=dev)
    with pytest.raises(ValueError):
        K.stem(wide, torch.zeros(3, 3, 224, 128, device=dev), *args[2:], out_dtype=dtype)


def test_stem_kernel_alternating_forms(dev):
    """Both forms on the same weight tensors, in turns: each reads its own
    packed copy (kept side by side on w1), as chip_smoke's [2] calls them."""
    g = torch.Generator().manual_seed(7)
    frame = torch.randint(0, 256, (2, 64, 96, 3), generator=g, dtype=torch.uint8)
    w1 = torch.randn(3, 3, 48, 128, generator=g) * (0.2 / 255)
    b1 = torch.randn(128, generator=g) * 0.1
    w2 = torch.randn(2, 2, 128, 64, generator=g) / 512 ** 0.5
    b2 = torch.randn(64, generator=g) * 0.1
    args = [t.to(dev).contiguous() for t in (frame, w1, b1, w2, b2)]
    for dtype in (torch.float32, torch.bfloat16, torch.float32, torch.bfloat16):
        got = K.stem(*args, out_dtype=dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        _close(got, K.stem_plain(*args, out_dtype=dtype), dtype)


@pytest.mark.parametrize("n", [1, 300, 1024])
def test_nms_kernel(dev, n):
    rng = np.random.RandomState(n)
    xy = rng.rand(n, 2) * 300
    wh = rng.rand(n, 2) * 80 + 4
    boxes = torch.from_numpy(np.concatenate([xy - wh / 2, xy + wh / 2], 1)
                             .astype(np.float32)).to(dev)
    scores = torch.from_numpy(np.sort(rng.rand(n).astype(np.float32))[::-1].copy()).to(dev)
    scores[n * 3 // 4:] = 0
    got = K.nms(boxes, scores, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got, K.nms_plain(boxes, scores, 0.45))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_argmax_kernel(dev, dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 19, 16, 32, generator=g).to(dev, dtype)
    got = K.upsample_argmax(x, (256, 512), via_hw=(128, 256))
    torch.cuda.synchronize()
    want = K.upsample_argmax_plain(x, (256, 512), via_hw=(128, 256))
    assert (got != want).float().mean().item() <= 1e-4


_K3 = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.nms")
_K4 = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.upsample_argmax")


def _k3_list(dev, n, kind):
    """A seeded sorted list of n rows: crowded boxes in two class-offset
    groups with an invalid quarter, the deepest chain (unit boxes a quarter
    apart: each overlaps the next only), or every row invalid."""
    rng = np.random.RandomState(n)
    if kind == "chain":
        x = np.arange(n, dtype=np.float32) * 0.25
        boxes = np.stack([x, np.zeros_like(x), x + 1, np.ones_like(x)], 1)
        scores = np.linspace(1.0, 0.5, n).astype(np.float32)
    else:
        xy = rng.rand(n, 2) * 200
        wh = rng.rand(n, 2) * 80 + 4
        off = rng.randint(0, 2, (n, 1)) * 4096.0
        boxes = np.concatenate([xy - wh / 2 + off, xy + wh / 2 + off], 1).astype(np.float32)
        scores = np.sort(rng.rand(n).astype(np.float32))[::-1].copy()
        scores[n * 3 // 4:] = 0
        if kind == "invalid":
            scores[:] = 0
    return torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)


@pytest.mark.parametrize("n", [1, 31, 33, 1024])
@pytest.mark.parametrize("kind", ["crowded", "chain", "invalid"])
def test_nms_kernel_packed(dev, n, kind):
    """K3's keep mask and packed output bit-equal to the plain versions,
    max_det below and above the kept count, under every cluster size; one
    call for the pack."""
    boxes, scores = _k3_list(dev, n, kind)
    want = K.nms_plain(boxes, scores, 0.45)
    kept = int(want.sum())
    for max_det in sorted({1, max(kept // 2, 1), kept + 5, 300}):
        want_idx, want_valid = K.nms_packed_plain(boxes, scores, 0.45, max_det)
        for ctas in (1, 2, 4, 8, 16):
            p = _K3.plan(n, ctas=ctas)
            keep, idx, valid = _K3.launch(boxes, scores, 0.45, max_det, p=p)
            torch.cuda.synchronize()
            assert torch.equal(keep, want), p
            assert torch.equal(idx, want_idx) and torch.equal(valid, want_valid), p
        K.reset_launches()
        idx, valid = K.nms_packed(boxes, scores, 0.45, max_det)
        assert K.nms.launches == 1
        assert torch.equal(idx, want_idx) and torch.equal(valid, want_valid)


# (shape, out_hw, via_hw): bs1 serving's bands (3 x 3 taps), ragged frames,
# rows of 1 tap (identity) and of 8 (a downsample through a 2-wide via)
_K4_CASES = [((1, 19, 64, 128), (1024, 2048), (512, 1024)),
             ((2, 19, 8, 16), (100, 150), (64, 128)),
             ((1, 19, 8, 16), (8, 150), (8, 128)),
             ((1, 19, 8, 16), (3, 100), (2, 128)),
             ((1, 19, 16, 32), (257, 333), (128, 256))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 19, 256])
@pytest.mark.parametrize("case", range(len(_K4_CASES)))
def test_upsample_argmax_kernel_every_plan(dev, dtype, c, case):
    """K4 under every tile of ``TILES`` that takes the geometry: the same
    class map bit for bit, twice, and within the mismatch share of the
    plain version."""
    shape, out_hw, via_hw = _K4_CASES[case]
    g = torch.Generator().manual_seed(c + case)
    x = torch.randn(shape[0], c, *shape[2:], generator=g).to(dev, dtype)
    want = K.upsample_argmax_plain(x, out_hw, via_hw)
    first = None
    for tile in _K4.TILES:
        try:
            p = _K4.plan(x.shape[0], c, *x.shape[2:], out_hw, via_hw, tile=tile)
        except ValueError:
            continue
        got = _K4.launch(x, out_hw, via_hw, p)
        again = _K4.launch(x, out_hw, via_hw, p)
        torch.cuda.synchronize()
        assert torch.equal(got, again), p
        first = got if first is None else first
        assert torch.equal(got, first), p
        assert (got != want).float().mean().item() <= 1e-4, p
    assert first is not None


@pytest.mark.parametrize("bsz,n,n_valid", [(1, 1025, 1025), (3, 4224, 4000), (2, 30000, 29000)])
def test_nms_greedy_kernel(dev, bsz, n, n_valid):
    """Sorted scores from 50 levels (ties), an invalid tail, crowded boxes in
    four class-offset groups, as the eval path's multi-label candidates."""
    rng = np.random.RandomState(n)
    xy = rng.rand(bsz, n, 2) * 100
    wh = rng.rand(bsz, n, 2) * 20 + 40
    off = rng.randint(0, 4, (bsz, n, 1)) * 4096.0
    boxes = torch.from_numpy(np.concatenate([xy - wh / 2 + off, xy + wh / 2 + off], 2)
                             .astype(np.float32)).to(dev)
    scores = np.sort(rng.randint(1, 51, (bsz, n)).astype(np.float32) / 50, 1)[:, ::-1].copy()
    scores[:, n_valid:] = 0
    scores = torch.from_numpy(scores).to(dev)
    idx, valid = K.nms_greedy(boxes, scores, 0.6, 300)
    torch.cuda.synchronize()
    want_idx, want_valid = K.nms_greedy_plain(boxes, scores, 0.6, 300)
    assert torch.equal(idx, want_idx) and torch.equal(valid, want_valid)
    assert valid.sum(1).min() > 250 and idx.max() > 900   # deep suppression


_K5 = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.nms_greedy")


def _k5_lists(dev, seed, bsz, n, n_valid=None, levels=50, spread=100.0):
    """Seeded sorted lists: scores from ``levels`` levels (ties across slice
    edges), crowded boxes in four class-offset groups, rows past each
    image's ``n_valid`` invalid."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(bsz, n, 2) * spread
    wh = rng.rand(bsz, n, 2) * 20 + 40
    off = rng.randint(0, 4, (bsz, n, 1)) * 4096.0
    boxes = torch.from_numpy(np.concatenate([xy - wh / 2 + off, xy + wh / 2 + off], 2)
                             .astype(np.float32)).to(dev)
    scores = np.sort(rng.randint(1, levels + 1, (bsz, n)).astype(np.float32) / levels,
                     1)[:, ::-1].copy()
    for b, v in enumerate(n_valid or ()):
        scores[b, v:] = 0
    return boxes, torch.from_numpy(scores).to(dev)


def _k5_equal(boxes, scores, iou, max_det, p=None):
    """K5 (default plan, or ``p`` through the C entry) against the plain
    version: every pick equal; returns (idx, valid)."""
    if p is None:
        idx, valid = K.nms_greedy(boxes, scores, iou, max_det)
    else:
        idx, valid = _K5.launch(boxes, scores, iou, max_det, p)
    torch.cuda.synchronize()
    want_idx, want_valid = K.nms_greedy_plain(boxes, scores, iou, max_det)
    assert int((idx != want_idx).sum()) == 0 and int((valid != want_valid).sum()) == 0
    return idx, valid


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_nms_greedy_kernel_each_cluster(dev, cluster):
    """Each cluster size, with boxes in shared memory (where a slice's fit:
    4 CTAs and more) and in device memory, through the C entry with an
    explicit plan; picks equal."""
    boxes, scores = _k5_lists(dev, 11, 2, 30000, (30000, 17000))
    for res in (True, False) if cluster >= 4 else (False,):
        p = _K5.plan(2, 30000, cluster=cluster, resident=res)
        assert p.cluster == cluster and p.resident == res
        idx, valid = _k5_equal(boxes, scores, 0.6, 300, p)
        assert valid.sum(1).min() > 250


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
def test_nms_greedy_kernel_across_slices(dev, cluster):
    """Three score levels and heavily overlapping boxes, so runs of equal
    scores straddle every slice edge and each pick suppresses rows in
    later slices; picks land in several slices."""
    n = 4096
    boxes, scores = _k5_lists(dev, 12, 1, n, levels=3, spread=30.0)
    p = _K5.plan(1, n, cluster=cluster)
    edges = scores[0, p.rows - 1:(p.cluster - 1) * p.rows:p.rows]
    assert bool((edges == scores[0, p.rows::p.rows][:len(edges)]).any())   # a tie at an edge
    idx, valid = _k5_equal(boxes, scores, 0.5, 300, p)
    owners = set((idx[0][valid[0]] // p.rows).tolist())
    assert len(owners) > 1


@pytest.mark.parametrize("n", [33, 1000, 4097, 30001])
def test_nms_greedy_kernel_ragged(dev, n):
    """n no multiple of 32 or of the slice, at the default plan and at 16
    CTAs (whose last slice is short)."""
    boxes, scores = _k5_lists(dev, n, 3, n)
    _k5_equal(boxes, scores, 0.6, 300)
    _k5_equal(boxes, scores, 0.6, 300, _K5.plan(3, n, cluster=16))


def test_nms_greedy_kernel_invalid_and_short(dev):
    """An all-invalid image beside a full one and one of 40 valid rows (its
    picks run out before max_det); max_det 1."""
    boxes, scores = _k5_lists(dev, 13, 3, 30000, (30000, 0, 40))
    idx, valid = _k5_equal(boxes, scores, 0.6, 300)
    assert not valid[1].any() and (idx[1] == -1).all()
    assert 0 < int(valid[2].sum()) <= 40 and (idx[2, int(valid[2].sum()):] == -1).all()
    idx, valid = _k5_equal(boxes, scores, 0.6, 1)
    assert idx.shape == (3, 1) and valid[:, 0].tolist() == [True, False, True]


def test_nms_greedy_kernel_batch8_waves(dev):
    """Eight 30000-row lists: more clusters than the card places at once."""
    boxes, scores = _k5_lists(dev, 14, 8, 30000)
    idx, valid = _k5_equal(boxes, scores, 0.6, 300)
    assert valid.sum(1).min() > 250


def test_nms_greedy_kernel_device_memory_form(dev):
    """One list too long for shared memory at 16 CTAs: its plan reads the
    boxes from device memory."""
    n = 262144
    p = _K5.plan(1, n)
    assert not p.resident
    boxes, scores = _k5_lists(dev, 15, 1, n)
    idx, valid = _k5_equal(boxes, scores, 0.6, 300)
    assert int(valid.sum()) == 300 and idx.max() > 1000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 19, 64, 128, 8), (1, 4, 6, 12, 8), (2, 5, 8, 16, 8)])
def test_seg_ce_kernel(dev, dtype, shape):
    b, c, h, w, k = shape
    rng = np.random.RandomState(h * w + c)
    z = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(dev, dtype)
    y = rng.randint(0, c, (b, k * h, k * w))
    y = torch.from_numpy(np.where(rng.rand(*y.shape) < 0.2, -1, y)).to(dev)
    wv = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).to(dev)
    out = {}
    for name, fn in (("kernel", K.seg_ce), ("plain", K.seg_ce_plain)):
        zz = z.clone().requires_grad_(True)
        loss = fn(zz, y, wv)
        (loss * 3.5).backward()
        torch.cuda.synchronize()
        out[name] = (loss.detach(), zz.grad)
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    assert gk.dtype == dtype and gk.shape == z.shape
    assert abs(lk.item() - lp.item()) <= 1e-4 * abs(lp.item())
    bound = (1e-4 if dtype == torch.float32 else 1e-2) * gp.float().abs().max().item()
    assert (gk.float() - gp.float()).abs().max().item() <= bound


def test_seg_ce_kernel_all_ignored(dev):
    z = torch.randn(2, 5, 8, 16, generator=torch.Generator().manual_seed(3)).to(dev)
    z.requires_grad_(True)
    y = torch.full((2, 64, 128), -1, dtype=torch.int64, device=dev)
    launches = K.seg_ce_forward.launches, K.seg_ce_backward.launches
    loss = K.seg_ce(z, y)
    loss.backward()
    torch.cuda.synchronize()
    assert (K.seg_ce_forward.launches, K.seg_ce_backward.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert loss.item() == 0.0 and z.grad.abs().max().item() == 0.0


def _k6_inputs(dev, dtype, shape, hw, ignore_frac=0.2, seed=0, label_hi=None):
    """Seeded channels-last logits (b, c, h, w), int64 labels (b, H, W) in
    [0, label_hi or c) with ``ignore_frac`` of them -1, and class weights."""
    b, c, h, w = shape
    rng = np.random.RandomState(seed)
    z = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(dev, dtype)
    y = rng.randint(0, label_hi or c, (b, *hw))
    y = torch.from_numpy(np.where(rng.rand(*y.shape) < ignore_frac, -1, y)).to(dev)
    wv = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).to(dev)
    return z.contiguous(memory_format=torch.channels_last), y, wv


def _k6_run(fn, z, y, wv, upstream=3.5):
    zz = z.detach().clone().requires_grad_(True)
    loss = fn(zz, y, wv)
    (loss * upstream).backward()
    torch.cuda.synchronize()
    return loss.detach(), zz.grad


def _k6_close(z, y, wv, got):
    """K6's (loss, dz) against the plain version's, with test_seg_ce_kernel's bounds."""
    lp, gp = _k6_run(K.seg_ce_plain, z, y, wv)
    lk, gk = got
    assert gk.dtype == z.dtype and gk.shape == z.shape
    assert abs(lk.item() - lp.item()) <= 1e-4 * abs(lp.item())
    bound = (1e-4 if z.dtype == torch.float32 else 1e-2) * gp.float().abs().max().item()
    assert (gk.float() - gp.float()).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ignore_frac", [0.2, 0.9])
def test_seg_ce_kernel_step_shape_weighted(dev, dtype, ignore_frac):
    z, y, wv = _k6_inputs(dev, dtype, (8, 19, 64, 128), (512, 1024), ignore_frac, seed=1)
    _k6_close(z, y, wv, _k6_run(K.seg_ce, z, y, wv))


def test_seg_ce_kernel_labels_past_classes(dev):
    """Labels >= C count as ignored, as in the JAX kernel: bitwise the same
    loss and dz as with those labels set to -1."""
    z, y, wv = _k6_inputs(dev, torch.float32, (2, 5, 8, 16), (64, 128), seed=2, label_hi=9)
    assert (y >= 5).any()
    got = _k6_run(K.seg_ce, z, y, wv)
    y_ign = torch.where(y >= 5, -1, y)
    want = _k6_run(K.seg_ce, z, y_ign, wv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _k6_close(z, y_ign, wv, got)


# (b, c, h, w, H, W): ratios other than 8, and sizes no multiple of any tile
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 6, 17, 50, 136), (2, 19, 17, 6, 136, 50),
                                   (1, 3, 13, 21, 104, 168), (2, 19, 9, 35, 72, 280)])
def test_seg_ce_kernel_other_ratios_and_ragged_tiles(dev, dtype, shape):
    b, c, h, w, H, W = shape
    z, y, wv = _k6_inputs(dev, dtype, (b, c, h, w), (H, W), seed=h * w)
    _k6_close(z, y, wv, _k6_run(K.seg_ce, z, y, wv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_ce_kernel_layouts_and_repeats_bitwise(dev, dtype):
    """Planar and channels-last logits give bitwise equal loss and dz (dz in
    the input's layout); two calls give bitwise equal dz."""
    z, y, wv = _k6_inputs(dev, dtype, (8, 19, 64, 128), (512, 1024), seed=3)
    cl = _k6_run(K.seg_ce, z, y, wv)
    planar = _k6_run(K.seg_ce, z.contiguous(), y, wv)
    again = _k6_run(K.seg_ce, z, y, wv)
    assert cl[1].is_contiguous(memory_format=torch.channels_last)
    assert planar[1].is_contiguous()
    assert torch.equal(cl[0], planar[0]) and torch.equal(cl[1], planar[1])
    assert torch.equal(cl[0], again[0]) and torch.equal(cl[1], again[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_ce_kernel_every_plan(dev, dtype):
    """Every forward and backward tile of the sweep, through the C entry with
    an explicit plan: the plain version's loss and dz; the logsumexps
    bitwise the default plan's under every forward tile, and dz under every
    backward tile (a pixel's and an element's sums run in the same order in
    any tile; only the loss's sum order moves with the forward's tile)."""
    mod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.seg_ce")
    z, y, wv = _k6_inputs(dev, dtype, (2, 19, 16, 40), (128, 320), seed=4)
    y32 = y.to(torch.int32)
    g = torch.full((1,), 3.5, dtype=torch.float32, device=dev)
    base = mod.plan(2, 19, 16, 40, 128, 320, dtype)
    lp, gp = _k6_run(K.seg_ce_plain, z, y, wv)
    bound = (1e-4 if dtype == torch.float32 else 1e-2) * gp.float().abs().max().item()
    stats0, lse0 = K.seg_ce_forward(z, y32, wv, p=base)
    want = K.seg_ce_backward(z, y32, wv, lse0, stats0, g, p=base)
    for t in mod.FWD_PLANS:
        p = mod.plan(2, 19, 16, 40, 128, 320, dtype, fwd=t)
        stats, lse = K.seg_ce_forward(z, y32, wv, p=p)
        dz = K.seg_ce_backward(z, y32, wv, lse, stats, g, p=p)
        torch.cuda.synchronize()
        assert abs(stats[0].item() - lp.item()) <= 1e-4 * abs(lp.item()), p
        assert (dz.float() - gp.float()).abs().max().item() <= bound, p
        assert torch.equal(lse, lse0), p
    for t in mod.BWD_PLANS:
        p = mod.plan(2, 19, 16, 40, 128, 320, dtype, bwd=t)
        dz = K.seg_ce_backward(z, y32, wv, lse0, stats0, g, p=p)
        torch.cuda.synchronize()
        assert (dz.float() - gp.float()).abs().max().item() <= bound, p
        assert torch.equal(dz, want), p


def _c3_args(g, dev, dtype, c1, ch, c2, n):
    """Seeded fan-in scaled OHWI weights of ``dtype`` and float32 biases of
    one C3, in K7's argument order after x (shortcut excluded)."""
    def wt(*s):
        return (torch.randn(*s, generator=g) / np.sqrt(np.prod(s[1:]))).to(dev, dtype)

    def bias(c):
        return (torch.randn(c, generator=g) * 0.1).to(dev)

    args = [wt(ch, 1, 1, c1), bias(ch), wt(ch, 1, 1, c1), bias(ch), wt(c2, 1, 1, 2 * ch), bias(c2)]
    mws = [(wt(ch, 1, 1, ch), bias(ch), wt(ch, 3, 3, ch), bias(ch)) for _ in range(n)]
    return args, mws


# (B, H, W, c1, c_, bottlenecks, shortcut, c2): pspv5s's and pspv5m's
# widths, odd H x W, no shortcut; then c_ 8, 16 and 24 (no multiple of 16),
# four bottlenecks, c2 != c1, c1 128, a 1 x 1 image and an H x W that is no
# multiple of any tile, with two and three bottlenecks, and c2 40 on a
# float32 plan in passes of 32 channels (cv3's second pass half padding)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 20, 36, 64, 32, 1, True, 64), (1, 13, 29, 64, 32, 1, True, 64),
    (2, 16, 24, 96, 48, 2, True, 96), (2, 9, 17, 64, 32, 1, False, 64),
    (2, 12, 20, 16, 8, 1, True, 16), (2, 15, 21, 32, 16, 1, True, 32),
    (2, 18, 22, 64, 32, 4, True, 64), (2, 14, 26, 64, 24, 1, True, 40),
    (1, 16, 32, 128, 64, 1, True, 128), (3, 1, 1, 64, 32, 1, True, 64),
    (2, 7, 11, 64, 32, 2, True, 64), (2, 7, 11, 32, 16, 3, False, 48),
    (2, 10, 18, 96, 48, 1, True, 40)])
def test_c3_kernel(dev, dtype, shape):
    b, h, w, c1, ch, n, shortcut, c2 = shape
    g = torch.Generator().manual_seed(h * w + n)
    x = torch.randn(b, h, w, c1, generator=g).to(dev, dtype)
    args, mws = _c3_args(g, dev, dtype, c1, ch, c2, n)
    launches = K.c3.launches
    got = K.c3(x, *args, mws, shortcut)
    torch.cuda.synchronize()
    assert K.c3.launches == launches + 1 and got.shape == (b, h, w, c2)
    _close(got, K.c3_plain(x, *args, mws, shortcut), dtype)


# The bf16 form's persistent grid, (B, H, W, c1, c_, bottlenecks, shortcut,
# c2, SMs the plan is given): more tiles than CTAs with a ragged last tile
# (a card of 2 SMs: 2-4 CTAs walk 36 tiles); batch 1; one to four
# bottlenecks; c_ 8, 16, 24 and 48 on c1 64; c1 96 (three TMA boxes of 32
# channels) and 128 (two of 64); no shortcut
@pytest.mark.parametrize("shape", [
    (3, 37, 53, 64, 32, 1, True, 64, 2), (1, 40, 56, 64, 32, 1, True, 64, None),
    (2, 20, 24, 64, 32, 1, True, 64, None), (2, 20, 24, 64, 32, 2, True, 64, None),
    (2, 20, 24, 64, 32, 3, True, 64, None), (2, 20, 24, 64, 32, 4, True, 64, None),
    (2, 19, 23, 64, 8, 1, True, 64, None), (2, 19, 23, 64, 16, 1, True, 64, None),
    (2, 19, 23, 64, 24, 1, True, 64, None), (2, 19, 23, 64, 48, 2, True, 64, None),
    (2, 19, 23, 96, 32, 1, True, 96, None), (2, 19, 23, 128, 32, 1, True, 128, None),
    (2, 21, 27, 64, 32, 2, False, 64, None)])
def test_c3_bf16_persistent(dev, monkeypatch, shape):
    """Each case within the bf16 bound of ``c3_plain``, and a second launch
    bitwise equal to the first."""
    b, h, w, c1, ch, n, shortcut, c2, sms = shape
    mod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.c3")
    if sms is not None:
        real = mod.plan
        monkeypatch.setattr(mod, "plan", lambda *a, **k: real(*a[:8], sms=sms))
        p = mod.plan(b, h, w, c1, ch, c2, n, torch.bfloat16)
        assert p.ctas < b * -(-h // p.th) * -(-w // p.tw)
    g = torch.Generator().manual_seed(h * w + n + c1)
    x = torch.randn(b, h, w, c1, generator=g).to(dev, torch.bfloat16)
    args, mws = _c3_args(g, dev, torch.bfloat16, c1, ch, c2, n)
    launches = K.c3.launches
    got = K.c3(x, *args, mws, shortcut)
    again = K.c3(x, *args, mws, shortcut)
    torch.cuda.synchronize()
    assert K.c3.launches == launches + 2 and got.shape == (b, h, w, c2)
    _close(got, K.c3_plain(x, *args, mws, shortcut), torch.bfloat16)
    assert torch.equal(got, again)


def test_c3_kernel_alternating_forms(dev):
    """The float32 (3xTF32) and bfloat16 forms in turns on the same weight
    tensors (float32 and their bf16 casts), as the eval and serving paths
    call them in one process: each call is right, and each repeat gives
    its form's first output bit for bit."""
    g = torch.Generator().manual_seed(11)
    x32 = torch.randn(2, 20, 36, 64, generator=g).to(dev)
    args32, mws32 = _c3_args(g, dev, torch.float32, 64, 32, 64, 1)
    cast = lambda t: t.to(torch.bfloat16) if t.dim() == 4 else t   # noqa: E731
    forms = {torch.float32: (x32, args32, mws32),
             torch.bfloat16: (x32.to(torch.bfloat16), [cast(t) for t in args32],
                              [tuple(cast(t) for t in m) for m in mws32])}
    first = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float32, torch.bfloat16):
        x, args, mws = forms[dtype]
        got = K.c3(x, *args, mws)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        _close(got, K.c3_plain(x, *args, mws), dtype)
        assert torch.equal(got, first.setdefault(dtype, got))
