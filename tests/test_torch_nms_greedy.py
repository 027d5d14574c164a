"""K5's plain version and the port's eval-path NMS against the JAX package.

* ``nms_greedy_plain`` picks exactly what the TPU kernel ``nms_pallas``
  picks (interpret mode on the CPU, as tests/test_nms_kernels.py runs it),
  index for index: both take the first active row of the score-sorted list
  and test IoU > t in the same division form with float32 constants.
  Scores come from a few levels, so many tie.
* The port's ``nms_batched`` gives the JAX ``nms_batched``'s detections
  exactly (its ``lax.scan`` path off the TPU), multi-label and
  single-label, with and without a class mask, on lists below and above
  1024 rows: every list goes to K5 (here its plain version), which divides
  as the scan does.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.ops.nms import nms_batched as jax_nms_batched
from multiyolov5_tpu.ops.pallas.nms_kernel import nms_pallas
from multiyolov5_tpu_torch.ops import nms as port_nms
from multiyolov5_tpu_torch.ops.kernels import nms_greedy, nms_greedy_plain

nms_greedy_mod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.nms_greedy")
MAX_WH = 4096.0


def _sorted_set(rng, n, n_valid, img=512):
    """Overlapping boxes, scores sorted descending from 40 levels (ties),
    an invalid tail of zeros."""
    xy = rng.rand(n, 2) * img
    wh = rng.rand(n, 2) * 100 + 4
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
    scores = np.sort(rng.randint(1, 41, n).astype(np.float32) / 40)[::-1].copy()
    scores[n_valid:] = 0.0
    return boxes, scores


@pytest.mark.parametrize("n,n_valid,iou", [(256, 200, 0.45), (1280, 1100, 0.6),
                                           (4224, 4100, 0.6)])
def test_nms_greedy_plain_equals_tpu_kernel(n, n_valid, iou):
    boxes, scores = _sorted_set(np.random.RandomState(n), n, n_valid)
    idx, valid = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), iou, 300)
    tb, ts = torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None]
    got_idx, got_valid = nms_greedy(tb, ts, iou, 300)        # CPU: plain
    want_idx, want_valid = nms_greedy_plain(tb, ts, iou, 300)
    assert torch.equal(got_idx, want_idx) and torch.equal(got_valid, want_valid)
    assert got_idx.dtype == torch.int32 and got_valid.dtype == torch.bool
    np.testing.assert_array_equal(got_idx[0].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_valid[0].numpy(), np.asarray(valid))
    assert 0 < got_valid.sum() <= 300


def test_nms_greedy_plain_batches_and_stops_early():
    """Two images at once; an image whose picks run out before max_det
    leaves -1 / invalid behind its last pick, and an all-invalid image none."""
    rng = np.random.RandomState(7)
    b0, s0 = _sorted_set(rng, 640, 40)
    b1, s1 = _sorted_set(rng, 640, 0)
    idx, valid = nms_greedy_plain(torch.from_numpy(np.stack([b0, b1])),
                                  torch.from_numpy(np.stack([s0, s1])), 0.5, 300)
    n0 = int(valid[0].sum())
    assert 0 < n0 <= 40 and not valid[1].any()
    assert (idx[0, n0:] == -1).all() and (idx[1] == -1).all()
    want, _ = nms_pallas(jnp.asarray(b0), jnp.asarray(s0), 0.5, 300)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want))


def _pred(rng, b, n, nc, img=256):
    """(B, N, 5+nc) decoded candidates with scores drawn from few levels."""
    p = np.empty((b, n, 5 + nc), np.float32)
    p[..., 0:2] = rng.rand(b, n, 2) * img
    p[..., 2:4] = rng.rand(b, n, 2) * 60 + 4
    p[..., 4] = rng.choice([0.05, 0.2, 0.4, 0.6, 0.8, 0.95], size=(b, n))
    p[..., 5:] = rng.choice([0.01, 0.1, 0.3, 0.5, 0.7, 0.9], size=(b, n, nc))
    return p


@pytest.mark.parametrize("multi_label", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,conf", [(120, 0.1), (700, 0.05)])
def test_nms_batched_matches_jax(multi_label, masked, n, conf):
    """Lists of K = min(max_nms, rows) rows: 480 (n=120, 4 classes,
    multi-label), 120 or 700 (single-label) and 2800 (n=700, multi-label);
    each batch is one K5 call over its whole list."""
    nc, iou = 4, 0.6
    p = _pred(np.random.RandomState(n + 2 * masked + multi_label), 2, n, nc)
    cmask = np.array([1, 0, 1, 1], np.float32) if masked else None
    kw = dict(conf_thres=conf, iou_thres=iou, multi_label=multi_label, max_nms=30000,
              max_det=300)
    want_det, want_valid = jax_nms_batched(
        jnp.asarray(p), class_mask=None if cmask is None else jnp.asarray(cmask), **kw)
    seen = []
    real_greedy, real_k3 = port_nms.nms_greedy, port_nms.nms_packed

    def spy(boxes, scores, iou_thres, max_det):
        seen.append(scores.shape)
        return real_greedy(boxes, scores, iou_thres, max_det)

    port_nms.nms_greedy, port_nms.nms_packed = spy, None    # K3 is not on this path
    try:
        got_det, got_valid = port_nms.nms_batched(
            torch.from_numpy(p), class_mask=None if cmask is None else torch.from_numpy(cmask),
            **kw)
    finally:
        port_nms.nms_greedy, port_nms.nms_packed = real_greedy, real_k3
    assert seen == [(2, n * nc if multi_label else n)]
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert got_valid.sum() > 20
    np.testing.assert_array_equal(got_det.numpy(), np.asarray(want_det))
    if masked:
        assert not (got_det[..., 5][got_valid] == 1).any()


def test_non_max_suppression_labels_and_classes():
    """The host wrapper: injected labels become conf-1.0 candidates, and
    ``classes`` filters; per-image numpy (n, 6), as the JAX wrapper."""
    from multiyolov5_tpu.ops.nms import non_max_suppression as jax_nms
    from multiyolov5_tpu_torch.ops.nms import non_max_suppression

    p = _pred(np.random.RandomState(11), 2, 150, 3)
    labels = [np.array([[1, 40, 40, 30, 20], [2, 100, 60, 25, 25]], np.float32),
              np.zeros((0, 5), np.float32)]
    for kw in (dict(labels=labels), dict(classes=[0, 2], multi_label=True)):
        want = jax_nms(jnp.asarray(p), conf_thres=0.1, iou_thres=0.5, **kw)
        got = non_max_suppression(torch.from_numpy(p), conf_thres=0.1, iou_thres=0.5, **kw)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape[1] == 6 and len(g) > 0
            np.testing.assert_array_equal(g, w)
    assert (got[0][:, 5] != 1).all()


# K5's launch plan (pure Python): every list shape the port's paths give,
# each slice and shared-memory boundary, and the domain's ends.
_EVAL = [(b, 30000) for b in range(1, 9)]
_SERVING = [(8, 1024), (4, 1024), (2, 1024)]
_ONE = [(1, n) for n in (1, 31, 32, 33, 1025, 30000, 512, 513, 2048, 2049, 182784, 182785,
                         nms_greedy_mod.MAX_N)]


@pytest.mark.parametrize("bsz,n", _EVAL + _SERVING + _ONE)
def test_nms_greedy_plan_covers_each_row_once(bsz, n):
    p = nms_greedy_mod.plan(bsz, n)
    assert 1 <= p.cluster <= nms_greedy_mod.MAX_CLUSTER
    assert p.rows >= 32 and p.rows % 32 == 0
    owner = np.full(n, -1)
    for r in range(p.cluster):
        lo, hi = r * p.rows, min((r + 1) * p.rows, n)
        assert lo < hi                              # no slice is empty
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = r
    assert (owner >= 0).all()
    fits = 20 * p.rows + p.rows // 8 <= nms_greedy_mod.SMEM_LIMIT
    assert p.resident == fits
    assert p.smem == nms_greedy_mod.smem_bytes(p.rows, p.resident) <= nms_greedy_mod.SMEM_LIMIT


@pytest.mark.parametrize("bsz,n,cluster,want", [
    # boxes 16 B + area 4 B a row, and a bit a row
    (4, 30000, 16, (16, 1888, 1888 * 16 + 1888 * 4 + 1888 // 8, True)),
    (8, 1024, 1, (1, 1024, 16384 + 4096 + 128, True)),
    (1, 513, 16, (9, 64, 64 * 20 + 8, True)),        # 33 rows a CTA round up to 64
    (1, 182784, 16, (16, 11424, 11424 * 20 + 1428, True)),   # the last that fits
    (1, 182785, 16, (16, 11456, 1432, False)),       # boxes in device memory
    (1, nms_greedy_mod.MAX_N, 16, (16, 112640, 14080, False)),
    (1, nms_greedy_mod.MAX_N, 1, (1, nms_greedy_mod.MAX_N, 225280, False)),
])
def test_nms_greedy_plan_smem_by_hand(bsz, n, cluster, want):
    p = nms_greedy_mod.plan(bsz, n, cluster=cluster)
    assert (p.cluster, p.rows, p.smem, p.resident) == want


def test_nms_greedy_plan_raises():
    for bsz, n in ((1, 0), (1, nms_greedy_mod.MAX_N + 1), (0, 1024)):
        with pytest.raises(ValueError):
            nms_greedy_mod.plan(bsz, n)
    for kw in (dict(cluster=17), dict(cluster=0), dict(resident=True, cluster=1)):
        with pytest.raises(ValueError):
            nms_greedy_mod.plan(1, 200000, **kw)
