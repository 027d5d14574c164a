"""The model surface beside the serving path, in the port against the JAX
package, on the CPU in float32: models whose input is not 3 channels, every
``nn.Upsample`` mode, and the ``Model`` facade.

* **Channels.** ``hub.create(cfg, channels=1 or 4, pretrained=npz,
  autoshape=False)`` in both packages, ``cfg`` ``yolov5s`` narrowed to
  ``width_multiple`` 0.125, the npz the port's seeded weights for that
  model (``seeded_state_dict`` seed 0, BN statistics measured) written by
  the JAX ``save_npz``.  The JAX ``create`` builds a bfloat16 ``Engine``;
  the test process hands it ``half=False``.  One seeded 64x128 frame to
  128x256, conf 3e-4.  ``__call__`` on the uint8 frame, the port's call
  on the float frame x / 255 against the JAX call on the uint8 frame, and
  TTA (``augment``): equal counts, scores within 1e-5, boxes within 1 px
  with at most 1% of the coordinates past 1e-3 (whole pixels on both
  sides).  Both engines fold rows 0-1, the port with the /255 in w1, the
  JAX XLA stem on frame / 255, and the scaled TTA frames differ by up to
  ~1.1e-5 between ``F.interpolate`` and the JAX matrices
  (tests/test_torch_engine_args.py): a box edge within rounding of a half
  pixel can round the other way (measured: 1 coordinate of 436 at C = 4
  on the uint8 call, scores within 3.1e-7).  Such an ``Engine`` folds rows 0-1 as
  the JAX one does: K1 (its plain version here) takes the C-channel frame,
  and its output equals the fused rows 0-1 of the model on frame / 255
  within 1e-5 of the largest |value|; a model of more channels than K1
  reads (14) runs them in the model.  ``AutoShape`` raises ``ValueError``
  where the JAX one raises, before it reads or runs anything.
* **Upsample.** The row module in each of torch's 4-D modes against
  torch's own ``nn.Upsample(None, s, mode)``, forward and backward,
  exactly; ``linear``, ``trilinear`` and an unknown mode raise
  ``ValueError`` when the model is built.  ``bilinear`` against the JAX
  ``resize_bilinear(align_corners=False)`` and its ``jax.vjp`` within
  1e-6 (the JAX package builds its matrices in float64); the JAX row in
  each mode but nearest computes an align-corners bilinear (within 1e-5)
  and is off torch's by more than 0.1 (a fault of the JAX package).  A
  narrow ``yolov5s_city_seg`` (width 0.125) with its two neck upsamples
  bilinear, against the JAX ``forward``
  (``sever=False``: no LazyCat) with the Upsample rows' resize given
  ``align_corners=False`` in this process only, unfused and folded:
  boxes within 5e-4 of their largest |value|, obj/cls within 1e-4, the
  1/8-res seg logits within 1e-4 of max(1, their largest |value|)
  (tests/test_torch_hub_models.py's bounds).
* **Facade.** ``Model(cfg, ch, nc, anchors)``'s spec against the JAX
  ``Model``'s row for row, with ``nc``, ``stride`` and ``names``.  On a
  narrow ``yolov5s_city_seg`` (width 0.125) with the JAX facade's weights
  carried across (its seg head's last conv scaled by 1e6, bias zeroed, so
  the class map is not one class): the eval forward against the JAX
  facade's call under the bounds above (the seg logits at input
  resolution through the head's align-corners x8); ``fuse()`` against the
  unfused forward within 1e-5 of the largest |value| and against the JAX
  ``fuse()``'s call; the kernel routes after ``fuse()`` those of
  ``Model(spec, fused=True)``; ``info()``'s parameters equal the JAX
  count and its GFLOPs the JAX count plus exactly the Focus conv's
  products (ROADMAP §3); ``autoshape()`` against the JAX ``autoshape()``
  on one 100x200 image at size 128, conf 3e-4, under the serving bounds
  and at most 1e-4 of the class-map pixels differing.
"""

import copy
import functools
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import multiyolov5_tpu.hub as jax_hub
import multiyolov5_tpu.models.model as jax_model_mod
import multiyolov5_tpu_torch.engine as engine_mod
import multiyolov5_tpu_torch.hub as port_hub
from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import Model as JaxModel
from multiyolov5_tpu.models.model import _apply_row
from multiyolov5_tpu.models.model import forward as jax_forward
from multiyolov5_tpu.ops.nn import Ctx
from multiyolov5_tpu.ops.nn import fuse_conv_bn as jax_fuse
from multiyolov5_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from multiyolov5_tpu.utils import checkpoint as jax_ckpt
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models import blocks as B
from multiyolov5_tpu_torch.models import zoo
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import Model, _build_row, seeded_state_dict
from multiyolov5_tpu_torch.ops.kernels.stem import MAX_CHANNELS as STEM_MAX_CHANNELS
from multiyolov5_tpu_torch.ops.nn import fuse_conv_bn
from multiyolov5_tpu_torch.ops.resize import UPSAMPLE_MODES
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params, to_jax_params
from test_torch_profiling import _focus_flops, one_torch_thread  # noqa: F401 (autouse)

IN_HW, ORIG_HW = (64, 128), (128, 256)
CONF = 3e-4
BOX_REL, OBJCLS_ABS, SEG_REL = 5e-4, 1e-4, 1e-4


def narrow(name: str, width: float = 0.125, upsample: str = None) -> dict:
    """A zoo config at ``width``, its ``nn.Upsample`` rows in ``upsample``
    mode where given."""
    cfg = zoo.get(name)
    cfg["width_multiple"] = width
    if upsample is not None:
        cfg["head"] = [[f, n, m, [a[0], a[1], upsample] if m == "nn.Upsample" else a]
                       for f, n, m, a in cfg["head"]]
    return cfg


def _same_dets(got, want, flips=False):
    """tests/test_torch_serving.py's bounds on (dets, masks); with ``flips``
    a box edge may round the other way (module docstring)."""
    (dp, mp), (dj, mj) = got, want
    assert len(dp) == len(dj)
    for a, b in zip(dp, dj):
        assert a.shape == b.shape and len(a) >= 10
        off = np.abs(a[:, :4] - b[:, :4])
        if flips:
            assert off.max() <= 1.0 and (off > 1e-3).mean() <= 0.01, off.max()
        else:
            assert off.max() <= 1e-3, off.max()
        np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=0, atol=1e-5)
    for a, b in zip(mp, mj):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and (a != b).mean() <= 1e-4


# -- channels -----------------------------------------------------------------

CH_CFG = narrow("yolov5s")


@pytest.fixture(scope="module", params=[1, 4], ids=["ch1", "ch4"])
def channel_pair(request, tmp_path_factory):
    ch = request.param
    spec = load_spec(CH_CFG, ch=ch)
    params, state = to_jax_params(seeded_state_dict(spec, 0))
    path = str(tmp_path_factory.mktemp("ch") / f"w{ch}.npz")
    jax_ckpt.save_npz(path, {"params": params, "state": state,
                             "spec_yaml": json.dumps(spec.yaml)})
    with mock.patch.object(jax_hub, "Engine", functools.partial(JaxEngine, half=False)):
        jeng = jax_hub.create(CH_CFG, pretrained=path, channels=ch, autoshape=False)
    peng = port_hub.create(CH_CFG, pretrained=path, channels=ch, autoshape=False,
                           device="cpu", half=False)
    img = (np.random.RandomState(5).rand(1, *IN_HW, ch) * 255).astype(np.uint8)
    return ch, jeng, peng, img


def test_channels_engine_folds_the_stem(channel_pair):
    ch, jeng, peng, img = channel_pair
    assert peng.spec.ch_in == jeng.spec.ch_in == ch
    assert isinstance(peng, Engine) and peng.fold_stem and jeng.fold_stem
    assert peng.stem_weights[0].shape[:3] == (3, 3, 16 * ch)
    frames, real = [], engine_mod.stem

    def spy(frame, *a, **kw):
        frames.append(tuple(frame.shape))
        return real(frame, *a, **kw)

    with mock.patch.object(engine_mod, "stem", side_effect=spy):
        z, _ = peng.forward(torch.from_numpy(img))
        peng.warmup(IN_HW, ORIG_HW)
    assert z.shape[:2] == (1, 85) and frames == [(1, *IN_HW, ch)] * 2
    x = torch.from_numpy(img)
    with torch.inference_mode():
        got = real(x, *peng.stem_weights).permute(0, 3, 1, 2)
        rows = peng.model.model
        want = rows[1](rows[0](x.permute(0, 3, 1, 2).float() / 255))
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    wide = load_spec(CH_CFG, ch=STEM_MAX_CHANNELS + 1)      # wider than K1 reads
    assert not Engine(spec=wide, state_dict=Model(wide).state_dict(), device="cpu",
                      half=False).fold_stem


@pytest.mark.parametrize("case", ["call", "float_frame", "augment"])
def test_channels_engine_matches_jax_hub(channel_pair, case):
    _, jeng, peng, img = channel_pair
    want = jeng(img, ORIG_HW, conf=CONF, augment=case == "augment")
    frame = img.astype(np.float32) / 255 if case == "float_frame" else img
    got = peng(frame, ORIG_HW, conf=CONF, augment=case == "augment")
    assert got[1] == [None]
    _same_dets(got, want, flips=True)


def test_channels_autoshape_raises_where_jax_raises(channel_pair):
    ch, jeng, peng, img = channel_pair
    frame = np.ascontiguousarray(np.repeat(img[0, :, :, :1], 3, 2))
    with pytest.raises(ValueError):
        jax_hub.AutoShape(jeng)(frame, size=128)
    with mock.patch.object(Engine, "__call__", side_effect=AssertionError("ran")), \
            mock.patch.object(port_hub, "letterbox", side_effect=AssertionError("read")):
        with pytest.raises(ValueError, match=f"3-channel images; the model takes {ch} "):
            port_hub.AutoShape(peng)(frame, size=128)


# -- nn.Upsample --------------------------------------------------------------

@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("mode", UPSAMPLE_MODES)
def test_upsample_row_equals_torch(mode, scale):
    x = torch.randn(2, 4, 5, 7, generator=torch.Generator().manual_seed(scale))
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    spec = load_spec(_upsample_cfg(mode, scale), ch=4)
    row = _build_row(spec, spec.rows[1], fused=False, kernel=False, c3_kernel=False)
    got, want = row(xs[0]), torch.nn.Upsample(None, scale, mode)(xs[1])
    assert got.shape == (2, 4, 5 * scale, 7 * scale)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(7))
    got.backward(g)
    want.backward(g)
    assert torch.equal(xs[0].grad, xs[1].grad)


def _upsample_cfg(mode, scale=2):
    return {"nc": 1, "depth_multiple": 1.0, "width_multiple": 1.0,
            "anchors": [[10, 13, 16, 30, 33, 23]],
            "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "nn.Upsample", ["None", scale, mode]]],
            "head": [[[1], 1, "Detect", ["nc", "anchors"]]]}


@pytest.mark.parametrize("mode", ["linear", "trilinear", "lanczos"])
def test_upsample_mode_torch_rejects_raises_at_build(mode):
    with pytest.raises(ValueError, match=f"mode '{mode}'"):
        Model(load_spec(_upsample_cfg(mode)))


def test_bilinear_row_matches_jax_resize():
    x = np.random.RandomState(0).randn(1, 5, 7, 4).astype(np.float32)
    g = np.random.RandomState(1).randn(1, 10, 14, 4).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_(True)
    got = B.Upsample(2, "bilinear")(xt)
    got.backward(torch.from_numpy(g.transpose(0, 3, 1, 2)))
    want, vjp = jax.vjp(lambda t: jax_resize_bilinear(t, (10, 14), align_corners=False),
                        jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(vjp(jnp.asarray(g))[0]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", [m for m in UPSAMPLE_MODES if m != "nearest"])
def test_jax_row_is_align_corners_bilinear(mode):
    """The JAX package's rows in these modes compute an align-corners
    bilinear (multiyolov5_tpu/models/model.py:179-186, ROADMAP §3): off
    torch's ``nn.Upsample`` and the port's row by more than 0.1."""
    x = np.random.RandomState(0).randn(1, 5, 7, 4).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    row = jax_load_spec(_upsample_cfg(mode), ch=4).rows[1]
    jrow = np.asarray(_apply_row(Ctx(p={}, s={}, train=False), row, jnp.asarray(x)))
    ac = F.interpolate(xt, size=(10, 14), mode="bilinear", align_corners=True)
    np.testing.assert_allclose(jrow, ac.numpy().transpose(0, 2, 3, 1), rtol=0, atol=1e-5)
    port = B.Upsample(2, mode)(xt).numpy().transpose(0, 2, 3, 1)
    assert np.array_equal(port, torch.nn.Upsample(None, 2, mode)(xt).numpy().transpose(0, 2, 3, 1))
    assert np.abs(jrow - port).max() > 0.1


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bilinear_model_matches_jax_forward(fused, monkeypatch):
    cfg = narrow("yolov5s_city_seg", upsample="bilinear")
    spec, jspec = load_spec(cfg), jax_load_spec(cfg)
    assert [r.i for r in spec.rows if r.module == "nn.Upsample"] == [11, 15]
    sd = seeded_state_dict(spec, 0)
    params, state = to_jax_params(sd)
    if fused:
        params = jax_fuse(params, state)
        state = {k: v for k, v in state.items()
                 if "running_" not in k or k.rsplit(".running_", 1)[0] + ".weight" in params}
        sd = fuse_conv_bn(sd)
    monkeypatch.setattr(jax_model_mod, "resize_bilinear",
                        functools.partial(jax_resize_bilinear, align_corners=False))
    x = np.random.RandomState(5).rand(1, *IN_HW, 3).astype(np.float32)
    (zj, _), segj, _ = jax_forward(jspec, params, state, jnp.asarray(x), train=False,
                                   fused=fused, sever=False, seg_up=False)
    model = Model(spec, fused=fused).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        z, seg = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    _hold_forward(z, seg, np.asarray(zj), np.asarray(segj))


def _hold_forward(z, seg, zj, segj):
    """Decoded candidates (B, no, N) and 1/8-res logits against the JAX
    (B, N, no) and (B, C, h, w) under the bounds of the module docstring."""
    z = z.transpose(1, 2).numpy()
    assert z.shape == zj.shape
    np.testing.assert_allclose(z[..., :4], zj[..., :4], rtol=0,
                               atol=BOX_REL * np.abs(zj[..., :4]).max())
    np.testing.assert_allclose(z[..., 4:], zj[..., 4:], rtol=0, atol=OBJCLS_ABS)
    assert np.ptp(zj[..., 4]) > 1e-3
    seg = seg.numpy()
    assert seg.shape == segj.shape
    np.testing.assert_allclose(seg, segj, rtol=0, atol=SEG_REL * max(1.0, np.abs(segj).max()))


# -- the Model facade ------------------------------------------------------------

def _rows(spec):
    return [(r.i, r.f, r.n, r.module, r.args, r.c1, r.c2, r.stride) for r in spec.rows]


FACADE_CASES = {
    "yolov5s_ch1_nc5": ("yolov5s", dict(ch=1, nc=5)),
    "city_seg_dict": (narrow("yolov5s_city_seg"), {}),
    "city_seg_anchors_ch4": (narrow("yolov5s_city_seg"),
                             dict(ch=4, anchors=[[10, 14, 23, 27, 37, 58]] * 3)),
}


@pytest.mark.parametrize("case", list(FACADE_CASES))
def test_facade_spec_matches_jax(case):
    cfg, kw = FACADE_CASES[case]
    got, want = Model(cfg, **kw), JaxModel(cfg, **kw)
    assert _rows(got.spec) == _rows(want.spec)
    assert got.spec.save == want.spec.save and got.spec.anchors == want.spec.anchors
    assert (got.nc, got.stride, got.names) == (want.nc, want.stride, want.names)
    assert got.spec.ch_in == kw.get("ch", 3)
    # a seeded init: the same seed gives the same weights, another seed others
    again, other = Model(cfg, **kw).state_dict(), Model(cfg, seed=1, **kw).state_dict()
    for k, v in got.state_dict().items():
        assert torch.equal(v, again[k]), k
    assert not torch.equal(got.state_dict()["model.0.conv.conv.weight"],
                           other["model.0.conv.conv.weight"])


def test_facade_spec_argument_keeps_its_behaviour():
    spec = load_spec(narrow("yolov5s_city_seg"))
    model = Model(spec, fused=True, kernels=False)
    assert model.spec is spec and model.fused and not model.kernels
    assert not any(getattr(m, "kernel", False) for m in model.modules())
    with pytest.raises(ValueError, match="ModelSpec"):
        Model(spec, ch=1)


@pytest.fixture(scope="module")
def facade_pair():
    cfg = narrow("yolov5s_city_seg")
    jm = JaxModel(cfg, seed=0)
    params = dict(jm.params)
    params["model.24.out.3.weight"] = params["model.24.out.3.weight"] * 1e6
    params["model.24.out.3.bias"] = params["model.24.out.3.bias"] * 0.0
    jm.params = params
    pm = Model(cfg).eval()
    pm.load_state_dict(from_jax_params(jm.params, jm.state), strict=True)
    x = np.random.RandomState(6).rand(1, *IN_HW, 3).astype(np.float32)
    return jm, pm, x


def _port_call(model, x):
    with torch.no_grad():
        z, seg = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    return z, seg


def _hold_facade_call(z, seg, jm, x):
    """The port's (det, 1/8-res seg) against the JAX facade's call (decoded
    (B, N, no), NHWC logits at input resolution)."""
    (zj, _), segj, _ = jm(jnp.asarray(x))
    up = F.interpolate(seg, scale_factor=8, mode="bilinear", align_corners=True)
    _hold_forward(z, up, np.asarray(zj), np.asarray(segj).transpose(0, 3, 1, 2))


def test_facade_forward_matches_jax(facade_pair):
    jm, pm, x = facade_pair
    _hold_facade_call(*_port_call(pm, x), jm, x)


def test_facade_fuse_matches_unfused_and_jax(facade_pair):
    jm, pm, x = facade_pair
    z, seg = _port_call(pm, x)
    fused = copy.deepcopy(pm)
    assert fused.fuse() is fused and fused.fused and not fused.training
    assert not any(".bn." in k for k in fused.state_dict())
    zf, segf = _port_call(fused, x)
    assert (zf - z).abs().max() <= 1e-5 * z.abs().max()
    assert (segf - seg).abs().max() <= 1e-5 * max(1.0, seg.abs().max().item())
    jf = copy.copy(jm).fuse()
    _hold_facade_call(zf, segf, jf, x)
    # the kernel routes of Model(spec, fused=True): K2 at the neck, K7 at row 2
    ref = Model(pm.spec, fused=True)
    def routes(m):
        return [[n for n, q in m.named_modules() if getattr(q, flag, False)]
                for flag in ("kernel", "c3_kernel")]
    assert routes(fused) == routes(ref) and all(routes(ref))
    # the device and dtype stay; the fold runs in float32
    half = copy.deepcopy(pm).to(torch.bfloat16).fuse()
    assert {t.dtype for t in half.state_dict().values()} == {torch.bfloat16}
    assert half.model[0].conv.conv.bias.dtype == torch.bfloat16
    assert fused.fuse() is fused


def test_facade_info_matches_jax(facade_pair, capsys):
    jm, pm, _ = facade_pair
    got = pm.info(img_size=128)
    want = jm.info(img_size=128)
    out = capsys.readouterr().out.splitlines()
    assert got["parameters"] == want["parameters"] and got["layers"] == want["layers"]
    assert abs(got["gflops"] * 1e9 - (want["gflops"] * 1e9 + _focus_flops(pm.spec, 128))) \
        <= 1e-12 * got["gflops"] * 1e9
    assert out[0].split(",")[:2] == out[1].split(",")[:2]


def test_facade_autoshape_matches_jax(facade_pair):
    jm, pm, _ = facade_pair
    img = (np.random.RandomState(8).rand(100, 200, 3) * 255).astype(np.uint8)
    runs = []
    shapes = jm.autoshape(), pm.autoshape()
    assert isinstance(shapes[1], port_hub.AutoShape)
    assert shapes[1].engine.device == torch.device("cpu")
    assert shapes[1].engine.dtype == torch.float32 and shapes[1].engine.fold_stem
    for shape in shapes:
        shape.conf = CONF
        runs.append(shape(img.copy(), size=128))
    want, got = runs
    assert got.names == want.names == pm.names
    _same_dets((got.pred, got.masks), (want.pred, want.masks))
    assert len(np.unique(got.masks[0])) >= 2
