"""The port's whole serving slice against the JAX package, on the CPU in float32.

JAX ``init_model`` weights go through ``from_jax_params`` into the port's
``Engine``; the JAX ``Engine`` gets the same weights.  Off the TPU the JAX
engine runs its plain XLA math (no Pallas path is taken), and it computes
the neck's upsample+concat lazily (1x1 convs before the upsample), so the
two differ by float reassociation only:
  * decoded candidates: 1e-4 absolute on pixel coordinates up to ~400,
    1e-5 on the obj/cls probabilities;
  * 1/8-res seg logits: 1e-4 absolute;
  * final detections: equal count, boxes within 1e-3 (they are rounded to
    whole pixels on both sides), scores within 1e-5;
  * class map: at most 1e-4 of the pixels differ.
With these random weights the seg features are ~1e-7, so the seg head's
last conv is scaled by 1e6 and its bias zeroed: the logits are then O(1)
and the class map is not one class everywhere."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models import zoo as jax_zoo
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import forward as jax_forward
from multiyolov5_tpu.models.model import init_model
from multiyolov5_tpu.utils.checkpoint import save_npz
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models import zoo
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

ORIG_HW = (256, 512)
CONF = 0.001


@pytest.fixture(scope="module")
def slice_pair():
    spec = jax_load_spec("yolov5s_city_seg")
    params, state = init_model(spec, seed=0)
    params = dict(params)
    params["model.24.out.3.weight"] = params["model.24.out.3.weight"] * 1e6
    params["model.24.out.3.bias"] = params["model.24.out.3.bias"] * 0.0
    jeng = JaxEngine(spec=spec, params=params, state=state, half=False)
    peng = Engine(spec=load_spec("yolov5s_city_seg"),
                  state_dict=from_jax_params(params, state), device="cpu",
                  half=False)
    img = (np.random.RandomState(5).rand(1, 128, 256, 3) * 255).astype(np.uint8)
    return spec, params, state, jeng, peng, img


def test_zoo_names_match_jax():
    assert zoo.available() == jax_zoo.available()


@pytest.mark.parametrize("cfg", jax_zoo.available())
def test_spec_matches_jax(cfg):
    a, b = jax_load_spec(cfg), load_spec(cfg)
    assert [vars(r) for r in a.rows] == [vars(r) for r in b.rows]
    assert (a.anchors, a.strides, a.save) == (b.anchors, b.strides, b.save)
    assert ((a.nc, a.n_segcls, a.seg_index, a.detect_index)
            == (b.nc, b.n_segcls, b.seg_index, b.detect_index))


def test_candidates_and_seg_logits_match(slice_pair):
    spec, _, _, jeng, peng, img = slice_pair
    x = jnp.asarray(img, jnp.float32) / 255.0
    (zs, _), seg_j, _ = jax_forward(spec, jeng.params, jeng.state, x,
                                    train=False, fused=True, decode="planar",
                                    seg_up=False)
    z_j = np.concatenate([np.asarray(z).transpose(2, 0, 1, 3).reshape(
        1, z.shape[0], -1) for z in zs], 2)
    z_p, seg_p = peng.forward(torch.from_numpy(img))
    assert z_p.shape == z_j.shape and z_p.dtype == torch.float32
    np.testing.assert_allclose(z_p[:, :4].numpy(), z_j[:, :4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(z_p[:, 4:].numpy(), z_j[:, 4:], rtol=0, atol=1e-5)
    assert seg_p.shape == seg_j.shape
    np.testing.assert_allclose(seg_p.numpy(), np.asarray(seg_j), rtol=0, atol=1e-4)


def _assert_same_outputs(got, want, exact=False):
    (dp, mp), (dj, mj) = got, want
    assert len(dp) == len(dj)
    for a, b in zip(dp, dj):
        assert a.shape == b.shape
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
            np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=0, atol=1e-5)
    for a, b in zip(mp, mj):
        assert a.shape == b.shape == ORIG_HW and a.dtype == np.uint8
        assert (a != b).mean() <= (0 if exact else 1e-4)


def test_dets_and_masks_match(slice_pair):
    _, _, _, jeng, peng, img = slice_pair
    want = jeng(img, ORIG_HW, conf=CONF)
    got = peng(img, ORIG_HW, conf=CONF)
    assert len(got[0][0]) >= 10                     # NMS has work to do
    assert len(np.unique(got[1][0])) >= 3           # a non-trivial class map
    _assert_same_outputs(got, want)


def test_npz_checkpoint_loads(slice_pair, tmp_path):
    """A JAX-package ``save_npz`` checkpoint loads in the port, preferring
    its EMA weights and the EMA BN statistics, and serves the same output."""
    spec, params, state, _, peng, img = slice_pair
    poisoned = {k: (np.asarray(v) * 0 + 1e6 if "running_var" in k else np.asarray(v))
                for k, v in state.items()}
    path = str(tmp_path / "ck.npz")
    save_npz(path, {"params": {k: np.asarray(v) * 0 for k, v in params.items()},
                    "state": poisoned,
                    "ema_params": {k: np.asarray(v) for k, v in params.items()},
                    "ema_state": {k: np.asarray(v) for k, v in state.items()},
                    "spec_yaml": json.dumps(spec.yaml)})
    eng = Engine(path, device="cpu", half=False)
    _assert_same_outputs(eng(img, ORIG_HW, conf=CONF), peng(img, ORIG_HW, conf=CONF),
                         exact=True)
