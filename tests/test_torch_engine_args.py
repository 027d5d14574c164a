"""``Engine``'s whole call surface against the JAX package, on the CPU in float32.

The JAX ``Engine(..., half=False)`` and the port's get the same weights
(tests/test_torch_engine.py's fixture: seed 0, the seg head's last conv
scaled by 1e6 so the class map is not one class everywhere) and the same
seeded 128x256 frame, mapped back to 256x512.  Each case of
``classes``, ``agnostic``, ``multi_label``, ``max_det`` and ``augment``,
two combined, a batch of two, and an ensemble of two ``.npz`` checkpoints
(seeds 0 and 1, written by the JAX ``save_npz``) are held to
tests/test_torch_engine.py's bounds: equal counts, boxes within 1e-3
(whole pixels on both sides), scores within 1e-5, at most 1e-4 of the
class-map pixels differing.

Under ``augment`` the 0.83 and 0.67 passes resize the frame with
``F.interpolate`` here and with the JAX package's own bilinear matrices
there (the scaled frames differ by up to ~1.1e-5, held at 2e-5 in
``test_scale_img_pad_matches_jax``), and the unscaled pass reads the uint8
frame through the folded stem here and x / 255 there.  The detections and
class maps still meet the same bounds.
"""

import json

import numpy as np
import pytest
import torch

from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.engine import scale_img_pad as jax_scale_img_pad
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import init_model
from multiyolov5_tpu.utils.checkpoint import save_npz
from multiyolov5_tpu_torch.engine import Engine, scale_img_pad
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params
from test_torch_engine import _assert_same_outputs
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

ORIG_HW = (256, 512)
CONF = 0.001


def _weights(spec, seed):
    params, state = init_model(spec, seed=seed)
    params = dict(params)
    params["model.24.out.3.weight"] = params["model.24.out.3.weight"] * 1e6
    params["model.24.out.3.bias"] = params["model.24.out.3.bias"] * 0.0
    return params, state


@pytest.fixture(scope="module")
def pair():
    spec = jax_load_spec("yolov5s_city_seg")
    params, state = _weights(spec, 0)
    jeng = JaxEngine(spec=spec, params=params, state=state, half=False)
    peng = Engine(spec=load_spec("yolov5s_city_seg"),
                  state_dict=from_jax_params(params, state), device="cpu", half=False)
    rng = np.random.RandomState(5)
    img = (rng.rand(2, 128, 256, 3) * 255).astype(np.uint8)
    return spec, jeng, peng, img


def test_names_match_jax(pair):
    spec, jeng, peng, _ = pair
    assert peng.names == jeng.names == [str(j) for j in range(spec.nc)]


CASES = {
    "classes": dict(classes=[0, 2]),
    "agnostic": dict(agnostic=True),
    "multi_label": dict(multi_label=True),
    "max_det": dict(max_det=7),
    "augment": dict(augment=True),
    "classes+multi_label": dict(classes=[1, 3, 4], multi_label=True),
    "augment+agnostic+max_det": dict(augment=True, agnostic=True, max_det=50),
}


@pytest.mark.parametrize("case", list(CASES))
def test_call_arguments_match_jax(pair, case):
    _, jeng, peng, img = pair
    kw = CASES[case]
    want = jeng(img[:1], ORIG_HW, conf=CONF, **kw)
    got = peng(img[:1], ORIG_HW, conf=CONF, **kw)
    assert len(got[0][0]) >= min(kw.get("max_det", 300), 10)
    if "classes" in kw:
        assert set(np.unique(got[0][0][:, 5]).astype(int)) <= set(kw["classes"])
    _assert_same_outputs(got, want)


def test_batch_of_two_matches_jax(pair):
    _, jeng, peng, img = pair
    want = jeng(img, ORIG_HW, conf=CONF, classes=[0, 1, 2])
    got = peng(img, ORIG_HW, conf=CONF, classes=[0, 1, 2])
    assert len(got[0]) == 2 and min(len(d) for d in got[0]) >= 10
    _assert_same_outputs(got, want)


def test_scale_img_pad_matches_jax():
    """torch computes the source coordinates of the bilinear taps in float32,
    the JAX package's matrices in float64: on frames in [0, 1] the resized
    values differ by up to ~1.1e-5 (read at these shapes), held at 2e-5."""
    x = np.random.RandomState(2).rand(1, 128, 256, 3).astype(np.float32)
    for ratio in (0.83, 0.67):
        want = np.asarray(jax_scale_img_pad(x, ratio, 32))
        got = scale_img_pad(torch.from_numpy(x), ratio, 32).numpy()
        assert got.shape == want.shape and got.shape[1] % 32 == got.shape[2] % 32 == 0
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("augment", [False, True])
def test_ensemble_of_two_checkpoints_matches_jax(pair, tmp_path, augment):
    spec, _, _, img = pair
    paths = []
    for seed in (0, 1):
        params, state = _weights(spec, seed)
        paths.append(str(tmp_path / f"s{seed}.npz"))
        save_npz(paths[-1], {"params": {k: np.asarray(v) for k, v in params.items()},
                             "state": {k: np.asarray(v) for k, v in state.items()},
                             "spec_yaml": json.dumps(spec.yaml)})
    jeng = JaxEngine(paths, half=False)
    peng = Engine(paths, device="cpu", half=False)
    assert len(peng.ensemble) == 1
    want = jeng(img[:1], ORIG_HW, conf=CONF, augment=augment)
    got = peng(img[:1], ORIG_HW, conf=CONF, augment=augment)
    assert len(got[0][0]) >= 10
    _assert_same_outputs(got, want)


def test_missing_weights_take_the_seeded_init_as_jax(tmp_path, capsys):
    """A weights path that does not exist: with a cfg, both engines warn
    and build that cfg's seeded random init
    (multiyolov5_tpu/engine.py:211-216); without one, both raise
    ``FileNotFoundError``."""
    missing = str(tmp_path / "missing.npz")
    jeng = JaxEngine(missing, cfg="yolov5s_city_seg", half=False)
    jax_out = capsys.readouterr().out
    peng = Engine(missing, cfg="yolov5s_city_seg", device="cpu", half=False)
    port_out = capsys.readouterr().out
    for out in (jax_out, port_out):
        assert "WARNING" in out and "missing.npz" in out and "yolov5s_city_seg" in out
    assert peng.spec.nc == jeng.spec.nc and peng.names == jeng.names
    seeded = Engine(cfg="yolov5s_city_seg", device="cpu", half=False)
    got, want = peng.model.state_dict(), seeded.model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    for build in (lambda: JaxEngine(missing, half=False),
                  lambda: Engine(missing, device="cpu", half=False)):
        with pytest.raises(FileNotFoundError, match="missing.npz"):
            build()
