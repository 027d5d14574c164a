"""The port's letterbox and ``InferenceServer`` against the JAX package's, on
the CPU.

* ``letterbox``: the port reproduces cv2's ``INTER_LINEAR`` (the JAX
  package's resize) in integer torch ops, so the two are equal pixel for
  pixel at every scale, down and up, and the padded geometry, the ratio
  and (dw, dh) are equal too.
* ``InferenceServer`` against the JAX server on the same weights
  (tests/test_torch_engine.py's ``slice_pair``: JAX ``init_model`` seed 0,
  the seg head's last conv scaled by 1e6) at ``img_size=128``, two frames in
  one batch, so the port's forward runs the row-2 C3 through the K7 route.
  Tolerances of tests/test_torch_engine.py: equal detection counts, boxes
  within 1e-3 px (rounded to whole pixels on both sides), scores within
  1e-5, at most 1e-4 of the class-map pixels differ.
* The dispatcher, on a stub engine: buckets, ``stats()``, ``close()``
  cancelling what is queued, and an engine error reaching every future of
  its batch.
"""

import threading
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from multiyolov5_tpu.data.letterbox import letterbox as jax_letterbox
from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import init_model
from multiyolov5_tpu.serving import InferenceServer as JaxServer
from multiyolov5_tpu_torch.data.letterbox import check_img_size, letterbox
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models import blocks
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.serving import InferenceServer
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("hw,size,auto,scaleup", [
    ((1024, 2048), 1024, False, True),    # serving: 2:1
    ((1024, 2048), 853, False, True),     # 853/2048
    ((480, 640), 640, True, True),        # minimum rectangle, 4:3 up-scale
    ((100, 200), 256, False, False),      # no up-scale: pad only
    ((1080, 1920), 1024, False, True),    # a camera frame, 0.533x
    ((720, 1280), 1024, False, True),     # an HD frame, 0.8x
    ((300, 500), 1111, False, True),      # 2.2x up-scale: clipped edge rows
])
def test_letterbox_matches_jax(hw, size, auto, scaleup):
    img = (np.random.RandomState(hw[0] + size).rand(*hw, 3) * 255).astype(np.uint8)
    want, ratio_j, pad_j = jax_letterbox(img, size, auto=auto, scaleup=scaleup)
    got, ratio_p, pad_p = letterbox(img, size, auto=auto, scaleup=scaleup)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape and ratio_p == ratio_j and pad_p == pad_j
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() == 0 and (diff > 0).mean() == 0.0
    assert check_img_size(size, 32) == -(-size // 32) * 32


def test_letterbox_gray_and_fill():
    img = (np.random.RandomState(3).rand(64, 128) * 255).astype(np.uint8)
    want = jax_letterbox(img, 128, auto=False)[0]
    got = letterbox(torch.from_numpy(img), 128, auto=False)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:32] == 114).all()


@pytest.fixture(scope="module")
def weights():
    spec = jax_load_spec("yolov5s_city_seg")
    params, state = init_model(spec, seed=0)
    params = dict(params)
    params["model.24.out.3.weight"] = params["model.24.out.3.weight"] * 1e6
    params["model.24.out.3.bias"] = params["model.24.out.3.bias"] * 0.0
    return spec, params, state


def test_server_matches_jax_server(weights, monkeypatch):
    spec, params, state = weights
    rng = np.random.RandomState(11)
    frames = [(rng.rand(128, 256, 3) * 255).astype(np.uint8) for _ in range(2)]
    k7 = []
    real = blocks.c3
    monkeypatch.setattr(blocks, "c3", lambda x, *a: k7.append(tuple(x.shape)) or real(x, *a))
    outs, stats = [], []
    for server in (
            InferenceServer(engine=Engine(spec=load_spec("yolov5s_city_seg"),
                                          state_dict=from_jax_params(params, state),
                                          device="cpu", half=False),
                            img_size=128, max_batch=4, max_wait_ms=500, conf=0.001),
            JaxServer(engine=JaxEngine(spec=spec, params=params, state=state, half=False),
                      img_size=128, max_batch=4, max_wait_ms=500, conf=0.001)):
        try:
            futs = [server.submit(f) for f in frames]
            outs.append([f.result(timeout=600) for f in futs])
            stats.append(server.stats())
        finally:
            server.close()
    assert k7 == [(2, 32, 32, 64)]
    assert [s["batches"] for s in stats] == [1, 1] and [s["frames"] for s in stats] == [2, 2]
    for (dp, mp), (dj, mj) in zip(*outs):
        assert dp.shape == dj.shape and len(dp) >= 10
        np.testing.assert_allclose(dp[:, :4], dj[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(dp[:, 4:], dj[:, 4:], rtol=0, atol=1e-5)
        assert mp.shape == mj.shape == (128, 256) and mp.dtype == np.uint8
        assert (mp != mj).mean() <= 1e-4 and len(np.unique(mp)) >= 3


class StubEngine:
    """Stands in for ``Engine``: records each batch, optionally blocks or
    raises, and returns one empty detection list and blank map per row."""
    stride = 32
    device = torch.device("cpu")

    def __init__(self, error=None):
        self.batches = []
        self.error = error
        self.entered = threading.Event()
        self.release = threading.Event()
        self.release.set()

    def __call__(self, x, orig_hw, conf=0.25, iou=0.45):
        self.batches.append(x.clone())
        self.entered.set()
        self.release.wait(30)
        if self.error is not None:
            raise self.error
        n = x.shape[0]
        return [np.zeros((0, 6), np.float32)] * n, [np.zeros(orig_hw, np.uint8)] * n


def _frames(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(64, 128, 3) * 255).astype(np.uint8) for _ in range(n)]


def test_buckets_pad_by_repeating_the_last_frame():
    eng = StubEngine()
    server = InferenceServer(engine=eng, img_size=64, max_batch=8, max_wait_ms=500)
    try:
        assert server._buckets == [1, 2, 4, 8]
        frames = _frames(3)
        futs = [server.submit(f) for f in frames]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        server.close()
    assert len(outs) == 3 and all(m.shape == (64, 128) for _, m in outs)
    (x,) = eng.batches
    assert tuple(x.shape) == (4, 64, 64, 3) and torch.equal(x[3], x[2])
    for f, row in zip(frames, x):     # letterboxed, BGR -> RGB
        want = jax_letterbox(f, 64, auto=False)[0][:, :, ::-1]
        np.testing.assert_array_equal(row.numpy(), want)
    assert server.stats()["frames"] == 3 and server.stats()["batches"] == 1


def test_close_cancels_queued_and_rejects_submit():
    eng = StubEngine()
    eng.release.clear()
    server = InferenceServer(engine=eng, img_size=64, max_batch=4, max_wait_ms=0.1)
    first = server.submit(_frames(1)[0])
    assert eng.entered.wait(30)               # the dispatcher is inside the engine
    queued = [server.submit(f) for f in _frames(3, seed=1)]
    threading.Timer(0.2, eng.release.set).start()
    server.close()
    assert first.result(timeout=30)[1].shape == (64, 128)
    for f in queued:
        assert f.cancelled()
        with pytest.raises(CancelledError):
            f.result(timeout=1)
    with pytest.raises(RuntimeError):
        server.submit(_frames(1)[0])


def test_engine_error_reaches_every_future_of_its_batch():
    server = InferenceServer(engine=StubEngine(error=ValueError("boom")), img_size=64,
                             max_batch=4, max_wait_ms=500)
    try:
        futs = [server.submit(f) for f in _frames(2)]
        for f in futs:
            with pytest.raises(ValueError, match="boom"):
                f.result(timeout=30)
    finally:
        server.close()
