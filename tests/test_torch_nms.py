"""Port's NMS against the JAX package.

* K3's plain version keeps exactly the boxes that the TPU fixpoint kernel
  ``nms_fixpoint_pallas`` keeps (interpret mode on the CPU): both test
  IoU > t in the same division-free float32 form, so no tolerance.
* The port's ``nms_planar`` gives the JAX ``nms_planar``'s detections on the
  same decoded candidates, ties in the top-k included (scores drawn from a
  few levels, so many candidates tie; both resolve lower index first).
  The JAX CPU path tests IoU with a division, which can differ only for a
  pair within an ulp of the threshold; none occurs at these seeds, so the
  comparison is exact up to float32 box arithmetic (1e-5 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.ops.nms import nms_planar as jax_nms_planar
from multiyolov5_tpu.ops.pallas.nms_fixpoint_kernel import nms_fixpoint_pallas
from multiyolov5_tpu_torch.ops.kernels import nms, nms_plain
from multiyolov5_tpu_torch.ops.nms import nms_planar


def _clustered_boxes(rng, n, n_valid, img=160):
    """Boxes crowded into a small image, so that most pairs overlap and the
    suppression chains run deep."""
    xy = rng.rand(n, 2) * img
    wh = rng.rand(n, 2) * 60 + 4
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
    scores = np.sort(rng.rand(n).astype(np.float32))[::-1] + 1e-4
    scores[n_valid:] = 0.0
    return boxes, scores.copy()


@pytest.mark.parametrize("n,n_valid,iou", [(128, 128, 0.45), (256, 200, 0.45),
                                           (256, 256, 0.6)])
def test_nms_plain_equals_fixpoint_kernel(n, n_valid, iou):
    boxes, scores = _clustered_boxes(np.random.RandomState(n + n_valid), n, n_valid)
    want = np.asarray(nms_fixpoint_pallas(jnp.asarray(boxes), jnp.asarray(scores), iou))
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = nms(tb, ts, iou).numpy()        # CPU: plain
    np.testing.assert_array_equal(got, nms_plain(tb, ts, iou).numpy())
    assert 0 < got.sum() < n_valid        # the test exercises suppression
    np.testing.assert_array_equal(got, want)


def _planar_candidates(rng, b, nc, na, grids, img=256):
    """Per-scale JAX-layout (no, na, B, HW) decoded candidates."""
    no = nc + 5
    zs = []
    for hw in grids:
        z = np.empty((no, na, b, hw), np.float32)
        z[0:2] = rng.rand(2, na, b, hw) * img
        z[2:4] = rng.rand(2, na, b, hw) * 80 + 4
        z[4] = rng.choice([0.1, 0.3, 0.5, 0.7, 0.9], size=(na, b, hw))
        z[5:] = rng.choice([0.2, 0.4, 0.6, 0.8], size=(nc, na, b, hw))
        zs.append(z)
    return zs


@pytest.mark.parametrize("conf,agnostic,max_nms", [(0.25, False, 1024),
                                                   (0.05, True, 1024),
                                                   (0.25, False, 128)])
def test_nms_planar_matches_jax(conf, agnostic, max_nms):
    rng = np.random.RandomState(3)
    b = 2
    zs = _planar_candidates(rng, b, nc=10, na=3, grids=(128, 32, 8))
    want_det, want_valid = jax_nms_planar([jnp.asarray(z) for z in zs],
                                          conf_thres=conf, iou_thres=0.45,
                                          agnostic=agnostic, max_nms=max_nms,
                                          max_det=300)
    z = np.concatenate([zi.transpose(2, 0, 1, 3).reshape(b, zi.shape[0], -1)
                        for zi in zs], 2)
    got_det, got_valid = nms_planar(torch.from_numpy(z), conf, 0.45, agnostic,
                                    max_nms=max_nms, max_det=300)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert got_valid.sum() > 10
    np.testing.assert_allclose(got_det.numpy(), np.asarray(want_det),
                               rtol=1e-5, atol=1e-5)


def test_nms_planar_bs8_is_one_k5_launch(monkeypatch):
    """bs8 serving: 8 lists of 1024 candidates go to one K5 call (its plain
    version here) and give the JAX package's detections."""
    import multiyolov5_tpu_torch.ops.nms as nms_mod
    rng = np.random.RandomState(8)
    b = 8
    zs = _planar_candidates(rng, b, nc=10, na=3, grids=(320, 80, 20))
    want_det, want_valid = jax_nms_planar([jnp.asarray(z) for z in zs], conf_thres=0.25,
                                          iou_thres=0.45, max_nms=1024, max_det=300)
    z = np.concatenate([zi.transpose(2, 0, 1, 3).reshape(b, zi.shape[0], -1)
                        for zi in zs], 2)
    calls = []
    real = nms_mod.nms_greedy
    monkeypatch.setattr(nms_mod, "nms_greedy",
                        lambda boxes, *a: calls.append(tuple(boxes.shape)) or real(boxes, *a))
    got_det, got_valid = nms_planar(torch.from_numpy(z), 0.25, 0.45, max_nms=1024, max_det=300)
    assert calls == [(8, 1024, 4)]
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert got_valid.sum(1).min() > 10
    np.testing.assert_allclose(got_det.numpy(), np.asarray(want_det), rtol=1e-5, atol=1e-5)
