"""The port's other model families against the JAX package, on the CPU in float32.

The seg-head variants ``yolov5s_city_seg_{base,bise,lab}``, the
detection-only ``yolov5s`` and the 4-level P6 ``yolov5s6``, narrowed to
``width_multiple`` 0.125 (P6 0.25) so a JAX forward costs seconds.  The
port's seeded weights (``seeded_state_dict``, seed 0: BN statistics measured
on a seeded batch, so scores spread and the class map varies) go through
``to_jax_params`` to the JAX ``Engine`` and back through ``from_jax_params``
into the port's ``Engine``.  One seeded 64x128 uint8 frame from a 128x256
original.  The two sides differ by float32 rounding, which these
unit-scale activations amplify: against the same port network in float64,
each side's boxes are off by up to 1.2e-2 px (about 1e-4 of their scale),
obj/cls by up to 1.8e-5 and seg logits by up to 1.8e-4 of theirs.  So the
bounds are, on the CPU:
  * decoded candidates: boxes within 5e-4 of their largest |value|, obj/cls
    probabilities within 1e-4;
  * 1/8-res seg logits: within 5e-4 of their largest |value|;
  * final detections (conf 0.001): equal count, and each port detection
    has a JAX detection of its class with boxes within 1 px (both are
    rounded to whole pixels) and score within 1e-4, so near-tied scores
    may swap places;
  * class map: at most 1e-3 of the pixels differ; None for both on a
    detection-only model.
Separately, JAX ``init_model`` weights of every zoo entry (narrowed) load
into the port's ``Model`` and ``Engine`` with ``strict=True``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models import zoo as jax_zoo
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import forward as jax_forward
from multiyolov5_tpu.models.model import init_model
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import Model, seeded_state_dict
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params, to_jax_params
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

IN_HW, ORIG_HW = (64, 128), (128, 256)

CONF = 0.001
WIDTHS = {"yolov5s_city_seg_base": 0.125, "yolov5s_city_seg_bise": 0.125,
          "yolov5s_city_seg_lab": 0.125, "yolov5s": 0.125, "yolov5s6": 0.25}


def _narrow(name: str, width: float = 0.125) -> dict:
    cfg = jax_zoo.get(name)
    cfg["width_multiple"] = width
    return cfg


@pytest.fixture(scope="module", params=list(WIDTHS))
def family(request):
    name = request.param
    cfg = _narrow(name, WIDTHS[name])
    spec = jax_load_spec(cfg)
    params, state = to_jax_params(seeded_state_dict(load_spec(cfg), seed=0))
    jeng = JaxEngine(spec=spec, params=params, state=state, half=False)
    peng = Engine(spec=load_spec(cfg), state_dict=from_jax_params(params, state),
                  device="cpu", half=False)
    img = (np.random.RandomState(5).rand(1, *IN_HW, 3) * 255).astype(np.uint8)
    return name, spec, jeng, peng, img


@pytest.mark.parametrize("name", jax_zoo.available())
def test_jax_init_weights_load_strict(name):
    """Every zoo entry's JAX ``init_model`` weights load whole into the
    port: the unfused ``Model`` and the fused ``Engine``, ``strict=True``."""
    cfg = _narrow(name)
    params, state = init_model(jax_load_spec(cfg), seed=0)
    sd = from_jax_params(params, state)
    Model(load_spec(cfg)).load_state_dict(sd, strict=True)
    eng = Engine(spec=load_spec(cfg), state_dict=sd, device="cpu", half=False)
    assert (eng.spec.seg_index is None) == ("n_segcls" not in cfg)


def test_candidates_and_seg_logits_match(family):
    name, spec, jeng, peng, img = family
    x = jnp.asarray(img, jnp.float32) / 255.0
    (zs, _), seg_j, _ = jax_forward(spec, jeng.params, jeng.state, x, train=False,
                                    fused=True, decode="planar", seg_up=False)
    assert len(zs) == (4 if name.endswith("6") else 3)
    z_j = np.concatenate([np.asarray(z).transpose(2, 0, 1, 3).reshape(
        1, z.shape[0], -1) for z in zs], 2)
    z_p, seg_p = peng.forward(torch.from_numpy(img))
    assert z_p.shape == z_j.shape and z_p.dtype == torch.float32
    box_scale = np.abs(z_j[:, :4]).max()
    np.testing.assert_allclose(z_p[:, :4].numpy(), z_j[:, :4], rtol=0, atol=5e-4 * box_scale)
    np.testing.assert_allclose(z_p[:, 4:].numpy(), z_j[:, 4:], rtol=0, atol=1e-4)
    if spec.seg_index is None:
        assert seg_j is None and seg_p is None and spec.n_segcls is None
        return
    assert seg_p.shape == seg_j.shape == (1, 19, IN_HW[0] // 8, IN_HW[1] // 8)
    seg_scale = np.abs(np.asarray(seg_j)).max()
    assert seg_scale > 0.5                                   # O(1) logits
    np.testing.assert_allclose(seg_p.numpy(), np.asarray(seg_j), rtol=0, atol=5e-4 * seg_scale)


def test_dets_and_masks_match(family):
    _, spec, jeng, peng, img = family
    dj, mj = jeng(img, ORIG_HW, conf=CONF)
    dp, mp = peng(img, ORIG_HW, conf=CONF)
    assert len(dp[0]) >= 5 and len(dp[0]) == len(dj[0])    # NMS has work to do
    for det in dp[0]:
        same = dj[0][dj[0][:, 5] == det[5]]
        near = ((np.abs(same[:, :4] - det[:4]).max(1) <= 1.0)
                & (np.abs(same[:, 4] - det[4]) <= 1e-4))
        assert near.any(), det
    if spec.seg_index is None:
        assert mp == [None] and mj == [None]
        return
    assert mp[0].shape == ORIG_HW and mp[0].dtype == np.uint8
    assert len(np.unique(mp[0])) >= 3                      # a non-trivial class map
    assert (mp[0] != mj[0]).mean() <= 1e-3
