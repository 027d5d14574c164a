"""K7's plain version and its route in the port, against the JAX package's
fused C3 (``c3_packed_pallas`` and ``c3_packed_pallas_hwbc``, run in
interpret mode off the TPU as tests/test_c3_kernel.py runs them), on the CPU
in float32.

* ``c3_plain`` (and the ``c3`` wrapper, which runs it for a CPU tensor)
  against both Pallas kernels on the same seeded weights: rtol/atol 2e-5,
  the bound of tests/test_c3_kernel.py (float32 sums in another order).
* The route: a fused eval ``Model`` calls ``kernels.c3`` for pspv5s's row-2
  C3 (c_ 32) at batch 2, and not at batch 1, unfused, or in training.  The
  width gate of B3b (8 <= c_ <= 48): across the zoo only row 2 of the s and
  m models takes K7; the l (c_ 64) and x (c_ 80) models' row 2 does not, and
  at batch 2 never calls it.
* The whole fused forward at bs2 on pspv5s at 128x256 against the JAX
  ``forward(fused=True)`` with ``MULTIYOLOV5_FORCE_C3PACK=1``, so the JAX
  side really runs ``c3_packed_pallas`` at row 2 (at 64x64 its geometry
  check, multiyolov5_tpu/models/blocks.py:156, would refuse the C3).  The
  weights are tests/test_torch_engine.py's ``slice_pair`` weights, with BN
  folded for the JAX side, and its tolerances: 1e-4 absolute on pixel
  boxes and seg logits, 1e-5 on the obj/cls probabilities.
* K7's launch planner (pure Python): every K7 site of every zoo entry
  (recorded from a bs2 forward) gets a plan in both dtypes at bs4 1024x512,
  bs8 1024x1024 and bs2 1024x1024, the bf16 form a grid of persistent
  CTAs no larger than its tiles; ``smem_bytes`` counts the kernel's
  layout as csrc/c3.cu does (hand-counted cases); shapes the kernel does
  not take raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import forward as jax_forward
from multiyolov5_tpu.models.model import init_model
from multiyolov5_tpu.ops.nn import fuse_conv_bn
from multiyolov5_tpu.ops.pallas import c3_kernel as jax_c3
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models import blocks, zoo
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import Model
from multiyolov5_tpu_torch.ops.kernels import c3, c3_plain
from multiyolov5_tpu_torch.ops.kernels.c3 import PLANS, SMEM_LIMIT, SMS, plan, smem_bytes
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)


def _weights(seed, c1, c_, c2, n):
    """Seeded HWIO weights and biases in the JAX kernel's argument order."""
    rng = np.random.RandomState(seed)

    def w(*s):
        fan = int(np.prod(s[:-1])) if len(s) > 1 else 1
        return (rng.randn(*s) / np.sqrt(fan)).astype(np.float32)

    return (w(1, 1, c1, c_), w(c_), w(1, 1, c1, c_), w(c_), w(1, 1, 2 * c_, c2), w(c2),
            tuple((w(1, 1, c_, c_), w(c_), w(3, 3, c_, c_), w(c_)) for _ in range(n)))


def _ohwi(wts):
    """The same weights as the port's wrapper takes them: OHWI tensors."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a.transpose(3, 0, 1, 2) if a.ndim == 4 else a))
    *head, mws = wts
    return [t(a) for a in head], [tuple(t(a) for a in m) for m in mws]


@pytest.mark.parametrize("pallas", ["c3_packed_pallas", "c3_packed_pallas_hwbc"])
@pytest.mark.parametrize("b,h,w,c1,c_,n,q,shortcut", [
    (2, 32, 64, 64, 32, 1, 4, True),     # pspv5s row 2
    (2, 16, 32, 96, 48, 2, 2, True),     # pspv5m row 2 (two-pixel halo)
    (2, 16, 32, 64, 32, 1, 4, False),    # no shortcut
])
def test_c3_plain_matches_pallas(pallas, b, h, w, c1, c_, n, q, shortcut):
    rng = np.random.RandomState(h * w + c1 + int(shortcut))
    x = rng.rand(b, h, w, c1).astype(np.float32)
    wts = _weights(c1 + n, c1, c_, c1, n)
    want = np.asarray(getattr(jax_c3, pallas)(
        jnp.asarray(x), *[jnp.asarray(a) for a in wts[:6]],
        tuple(tuple(jnp.asarray(a) for a in m) for m in wts[6]), q=q, shortcut=shortcut))
    head, mws = _ohwi(wts)
    xt = torch.from_numpy(x)
    for fn in (c3_plain, c3):
        got = fn(xt, *head, mws, shortcut).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bsz,fused,training,calls", [
    (2, True, False, 1), (1, True, False, 0), (2, False, False, 0), (2, True, True, 0)])
def test_model_routes_row2_c3_to_kernel(monkeypatch, bsz, fused, training, calls):
    spec = load_spec("yolov5s_city_seg")
    torch.manual_seed(0)
    model = Model(spec, fused=fused).train(training)
    seen = []
    real = blocks.c3
    monkeypatch.setattr(blocks, "c3", lambda x, *a: seen.append(tuple(x.shape)) or real(x, *a))
    x = torch.from_numpy(np.random.RandomState(1).rand(bsz, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        model(x)
    assert seen == [(bsz, 16, 16, 64)] * calls
    assert [i for i, m in enumerate(model.model)
            if isinstance(m, blocks.C3) and m.c3_kernel] == ([2] if fused else [])


@pytest.mark.parametrize("cfg,rows", [
    ("yolov5s_city_seg", [2]), ("yolov5m_city_seg", [2]), ("yolov5l_city_seg", []),
    ("yolov5x_city_seg", []), ("yolov5s6", [2]), ("yolov5x6", []), ("yolov5l", [])])
def test_k7_width_gate(monkeypatch, cfg, rows):
    spec = load_spec(cfg)
    with torch.device("meta"):
        model = Model(spec, fused=True)
    assert [i for i, m in enumerate(model.model)
            if isinstance(m, blocks.C3) and m.c3_kernel] == rows
    a = spec.rows[2].args                  # row 2 alone, on the CPU, at batch 2
    row2 = blocks.C3(a[0], a[1], n=a[2], fused=True, c3_kernel=True).eval()
    seen = []
    real = blocks.c3
    monkeypatch.setattr(blocks, "c3", lambda x, *w: seen.append(x.shape) or real(x, *w))
    with torch.no_grad():
        row2(torch.zeros(2, a[0], 16, 16))
    assert len(seen) == len(rows)


def test_fused_bs2_forward_matches_jax_with_c3_kernel(monkeypatch):
    spec = jax_load_spec("yolov5s_city_seg")
    params, state = init_model(spec, seed=0)
    params = dict(params)
    params["model.24.out.3.weight"] = params["model.24.out.3.weight"] * 1e6
    params["model.24.out.3.bias"] = params["model.24.out.3.bias"] * 0.0
    peng = Engine(spec=load_spec("yolov5s_city_seg"),
                  state_dict=from_jax_params(params, state), device="cpu", half=False)
    img = (np.random.RandomState(7).rand(2, 128, 256, 3) * 255).astype(np.uint8)

    jax_calls, port_calls = [], []
    real_jax = jax_c3.c3_packed_pallas
    monkeypatch.setenv("MULTIYOLOV5_FORCE_C3PACK", "1")
    monkeypatch.setattr(jax_c3, "c3_packed_pallas",
                        lambda x, *a, **k: jax_calls.append(x.shape) or real_jax(x, *a, **k))
    real_port = blocks.c3
    monkeypatch.setattr(blocks, "c3",
                        lambda x, *a: port_calls.append(tuple(x.shape)) or real_port(x, *a))

    (zs, _), seg_j, _ = jax_forward(spec, fuse_conv_bn(params, state), state,
                                    jnp.asarray(img, jnp.float32) / 255.0, train=False,
                                    fused=True, decode="planar", seg_up=False)
    z_j = np.concatenate([np.asarray(z).transpose(2, 0, 1, 3).reshape(
        2, z.shape[0], -1) for z in zs], 2)
    z_p, seg_p = peng.forward(torch.from_numpy(img))
    assert [tuple(s) for s in jax_calls] == port_calls == [(2, 32, 64, 64)]
    assert z_p.shape == z_j.shape and seg_p.shape == seg_j.shape
    np.testing.assert_allclose(z_p[:, :4].numpy(), z_j[:, :4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(z_p[:, 4:].numpy(), z_j[:, 4:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(seg_p.numpy(), np.asarray(seg_j), rtol=0, atol=1e-4)


def _k7_sites(cfg):
    """(input stride, c1, c_, c2, bottlenecks) of each K7 call of a fused
    eval ``cfg`` forward at bs2, recorded at 64x128 on the CPU."""
    with torch.device("meta"):
        n_k7 = sum(isinstance(m, blocks.C3) and m.c3_kernel
                   for m in Model(load_spec(cfg), fused=True).modules())
    if not n_k7:
        return []
    sites = []

    def rec(x, wcv1, bcv1, wcv2, bcv2, wcv3, bcv3, mws, shortcut):
        sites.append((64 // x.shape[1], x.shape[3], wcv1.shape[0], wcv3.shape[0], len(mws)))
        return c3_plain(x, wcv1, bcv1, wcv2, bcv2, wcv3, bcv3, mws, shortcut)

    model = Model(load_spec(cfg), fused=True).eval()
    real = blocks.c3
    blocks.c3 = rec
    try:
        with torch.no_grad():
            model(torch.zeros(2, 3, 64, 128))
    finally:
        blocks.c3 = real
    assert len(sites) == n_k7
    return sites


@pytest.mark.parametrize("cfg", zoo.available())
def test_k7_plan_every_zoo_site(cfg):
    sites = _k7_sites(cfg)
    # row 2 of the s and m models (c_ 32, 48) takes K7; l and x are past its width gate
    assert bool(sites) == any(k in cfg for k in ("yolov5s", "yolov5m"))
    for s_in, c1, ch, c2, nb in sites:
        for bsz, (h, w) in ((4, (512, 1024)), (8, (1024, 1024)), (2, (1024, 1024))):
            hs, ws = h // s_in, w // s_in
            for dt in (torch.float32, torch.bfloat16):
                p = plan(bsz, hs, ws, c1, ch, c2, nb, dt)
                assert (p.th, p.tw, p.nbuf, p.rows) in PLANS[dt]
                assert p.smem == smem_bytes(c1, ch, c2, nb, p.th, p.tw, p.nbuf, p.rows,
                                            dt) <= SMEM_LIMIT
                tiles = bsz * -(-hs // p.th) * -(-ws // p.tw)
                if dt == torch.bfloat16:   # persistent CTAs, one an SM
                    assert (p.nbuf, p.rows) == (1, 0) and p.ctas == min(tiles, SMS)
                else:
                    assert p.ctas == tiles


# hand-counted layouts, in elements.  float32: x's slab (th + 2n) x
# (tw + 2n) rows of c1 + pad (pad: 16 bytes), A's slab of c_p + pad, B (the
# bottleneck 1x1's output) in x's rows when c_p <= c1, else its own slab,
# cv2's tile, and nbuf buffers of the largest step's weights (a stage's
# rows 16-row padded, at most `rows` of them unless 0; rows of taps x c_p +
# pad).  bfloat16: 512 to align to, x's slab (c1 / KC chunks of the
# slab's rows of KC = 64, 32 or 16 channels, each rounded up to 512), A's
# slab (rows of c_p + 8), the larger of B's slab and y's staging tile (th x
# tw rows of c2 + 8), cv2's tile, and every stage's weights: cv1 and cv2
# c_p x (c1 + 8), cv3 c2 (16-row padded) x (2 c_p + 8), each bottleneck's
# 1x1 c_p x (c_p + 8) and 3x3 c_p x (9 c_p + 8)
@pytest.mark.parametrize("args,dtype,elems", [
    # eval's float32 pspv5s C3: 180 x 68 + 180 x 36 + 128 x 36 + 2 x 32 x 292
    ((64, 32, 64, 1, 8, 16, 2, 0), torch.float32, 12240 + 6480 + 4608 + 2 * 9344),
    # the same in bf16: 11776 (180 x 64 -> 11776) + 180 x 40 + 128 x 72 +
    # 128 x 40 + 2 x 32 x 72 + 64 x 72 + 32 x 40 + 32 x 296
    ((64, 32, 64, 1, 8, 16, 1, 0), torch.bfloat16,
     512 + 11776 + 7200 + 9216 + 5120 + 2 * 2304 + 4608 + 1280 + 9472),
    # bs8 serving's bf16 16x16 tile: 324 x 64 -> 20992; y's tile 256 x 72
    # outweighs B's slab 324 x 40
    ((64, 32, 64, 1, 16, 16, 1, 0), torch.bfloat16,
     512 + 20992 + 12960 + 18432 + 10240 + 2 * 2304 + 4608 + 1280 + 9472),
    # pspv5m in bf16 on an 8x8 tile: three boxes of 32 channels of 144
    # pixels; A's and B's slabs 144 x 56 outweigh y's 64 x 104; cv2's 64 x
    # 56; weights 2 x 48 x 104 + 96 x 104 + 2 x (48 x 56 + 48 x 440)
    ((96, 48, 96, 2, 8, 8, 1, 0), torch.bfloat16,
     512 + 3 * 4608 + 2 * 8064 + 3584 + 2 * 4992 + 9984 + 2 * (2688 + 21120)),
    # c1 16 (boxes of 16 channels: 100 x 16 -> 2048), c_ 8 padded to 16:
    # 100 x 24 twice (y's 64 x 24 is smaller), 64 x 24, 2 x 16 x 24 + 16 x
    # 40 + 16 x 24 + 16 x 152
    ((16, 8, 16, 1, 8, 8, 1, 0), torch.bfloat16,
     512 + 2048 + 2 * 2400 + 1536 + 2 * 384 + 640 + 384 + 2432),
    # pspv5m (c_ 48, 2 bottlenecks), 8x8 tile: 144 x 100 + 144 x 52 + 64 x 52 + 48 x 436
    ((96, 48, 96, 2, 8, 8, 1, 0), torch.float32, 14400 + 7488 + 3328 + 20928),
    # the same on an 8x16 tile in passes of 16 channels: 240 x 100 + 240 x 52
    # + 128 x 52 + 2 x 16 x 436
    ((96, 48, 96, 2, 8, 16, 2, 16), torch.float32, 24000 + 12480 + 6656 + 2 * 6976),
    # passes of 32: the 3x3's 32 rows (32 x 436) outweigh cv3's 32 (32 x 100)
    ((96, 48, 96, 2, 8, 16, 1, 32), torch.float32, 24000 + 12480 + 6656 + 13952),
    # c_p 24 > c1 16, so B has its own slab: 100 x 20 + 2 x 100 x 28 + 64 x 28,
    # and the 3x3's weights, 24 rows padded to 32, of 9 x 24 + 4: 32 x 220
    ((16, 24, 24, 1, 8, 8, 1, 0), torch.float32, 2000 + 2 * 2800 + 1792 + 32 * 220),
])
def test_k7_smem_bytes_layout(args, dtype, elems):
    assert smem_bytes(*args, dtype) == elems * (4 if dtype == torch.float32 else 2)


@pytest.mark.parametrize("c1,ch,c2,nb,dtype", [
    (24, 32, 64, 1, torch.float32), (64, 12, 64, 1, torch.float32), (64, 32, 60, 1, torch.bfloat16),
    (64, 32, 64, 0, torch.float32), (64, 32, 64, 5, torch.bfloat16), (64, 32, 64, 1, torch.float16),
    (1024, 256, 1024, 1, torch.float32),
    # the bf16 form keeps every stage's weights: c_ 48 with 3 or 4
    # bottlenecks and c_ 64 (c1 128) with 2 do not fit beside a 4x8 tile
    (96, 48, 96, 3, torch.bfloat16), (96, 48, 96, 4, torch.bfloat16),
    (128, 64, 128, 2, torch.bfloat16)])
def test_k7_plan_raises_on_shapes_without_a_kernel(c1, ch, c2, nb, dtype):
    with pytest.raises(ValueError):
        plan(2, 32, 64, c1, ch, c2, nb, dtype)


@pytest.mark.parametrize("nbuf,rows", [(1, 16), (2, 0)])
def test_k7_bf16_layout_has_one_slab_and_resident_weights(nbuf, rows):
    """The bf16 form has one x slab and no weight passes: any other buffer
    or row count raises."""
    with pytest.raises(ValueError):
        smem_bytes(64, 32, 64, 1, 8, 16, nbuf, rows, torch.bfloat16)


@pytest.mark.parametrize("bsz,h,w,c1,ch,c2,nb,sms", [
    (8, 256, 256, 64, 32, 64, 1, 132), (8, 256, 256, 96, 48, 96, 2, 132),
    (2, 256, 256, 96, 48, 96, 2, 132), (3, 37, 53, 64, 32, 64, 1, 2), (1, 1, 1, 64, 32, 64, 1, 132)])
def test_k7_bf16_grid(bsz, h, w, c1, ch, c2, nb, sms):
    """The bf16 grid: a persistent CTA an SM, never more than the tiles."""
    p = plan(bsz, h, w, c1, ch, c2, nb, torch.bfloat16, sms)
    assert p.ctas == min(bsz * -(-h // p.th) * -(-w // p.tw), sms)
