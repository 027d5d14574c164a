"""The port's eval path against the JAX package, on the CPU in float32.

Both packages get the ``slice_pair`` weights of tests/test_torch_engine.py
(yolov5s_city_seg, full width, JAX ``init_model`` seed 0, the seg head's
last conv scaled by 1e6; BN folded for the JAX side's fused=True) and the
same seeded in-memory loaders: two batches of two uint8 128x256 images,
letterboxed from 256x512 originals.

* Detection: the labels are a jittered subset of the JAX run's own
  detections plus a few boxes no detection covers, so mAP is neither 0 nor
  1.  The list is min(30000, 2016 anchors x 10 classes) = 20160 rows, so
  every image goes to K5's plain version, as every eval list goes to B6 on
  the TPU.  With these weights the stride-32 (box, class) pairs pass conf
  0.001 (960 valid rows an image), and conf 0.0003 lets the stride-16
  pairs through too (4800), so K5 stops at a short and at a long valid
  prefix.  The networks
  differ by float reassociation (1e-4 on pixel boxes, 1e-5 on scores;
  tests/test_torch_engine.py), so P, R, mAP@.5 and mAP@.5:.95 agree within
  1e-4 absolute and the per-image detection counts are equal.
* Segmentation: pixAcc and mIoU within 1e-4 (the port composes the x8 and
  the label-size resizes into one K4 map; a pixel whose top two logits tie
  within rounding can flip).
* The numpy metric code is a copy: ``ap_per_class``, ``SegMetric`` and
  ``_match_predictions`` give exactly the JAX module's results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiyolov5_tpu.evaluation as jax_eval
import multiyolov5_tpu_torch.evaluation as port_eval
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import forward as jax_forward
from multiyolov5_tpu.models.model import init_model
from multiyolov5_tpu.ops.nms import non_max_suppression as jax_nms
from multiyolov5_tpu.ops.nn import fuse_conv_bn
from multiyolov5_tpu.utils import metrics as jax_metrics
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.ops import nms as port_nms
from multiyolov5_tpu_torch.utils import metrics as port_metrics
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params

IN_HW, ORIG_HW = (128, 256), (256, 512)
RATIO_PAD = ((0.5, 0.5), (0.0, 0.0))


@pytest.fixture(scope="module")
def slice_pair():
    spec = jax_load_spec("yolov5s_city_seg")
    params, state = init_model(spec, seed=0)
    params = dict(params)
    params["model.24.out.3.weight"] = params["model.24.out.3.weight"] * 1e6
    params["model.24.out.3.bias"] = params["model.24.out.3.bias"] * 0.0
    peng = Engine(spec=load_spec("yolov5s_city_seg"),
                  state_dict=from_jax_params(params, state), device="cpu", half=False)
    # the JAX side runs fused=True, as its Engine does: BN folded into the convs
    return spec, fuse_conv_bn(params, state), state, peng


@pytest.fixture(scope="module")
def det_loader(slice_pair):
    """Two batches (imgs, targets, tmask, paths, shapes); the labels come
    from the JAX package's detections on the same images."""
    spec, params, state, _ = slice_pair
    rng = np.random.RandomState(2)
    fwd = jax.jit(lambda x: jax_forward(spec, params, state, x, train=False,
                                        fused=True, decode=True)[0][0])
    batches = []
    for b in range(2):
        imgs = (rng.rand(2, *IN_HW, 3) * 255).astype(np.uint8)
        dets = jax_nms(fwd(jnp.asarray(imgs, jnp.float32) / 255.0), conf_thres=0.001,
                       iou_thres=0.6, multi_label=True, max_nms=30000)
        targets = np.zeros((2, 24, 5), np.float32)
        tmask = np.zeros((2, 24), bool)
        for i, d in enumerate(dets):
            pick = d[rng.choice(len(d), 16, replace=False)]
            xyxy = pick[:, :4] + rng.randn(16, 4).astype(np.float32) * 3
            extra = rng.rand(4, 2) * [200, 100]
            xyxy = np.concatenate([xyxy, np.concatenate([extra, extra + 40], 1)])
            cls = np.concatenate([pick[:, 5], rng.randint(0, spec.nc, 4)])
            h, w = IN_HW
            xywh = np.stack([(xyxy[:, 0] + xyxy[:, 2]) / 2 / w, (xyxy[:, 1] + xyxy[:, 3]) / 2 / h,
                             (xyxy[:, 2] - xyxy[:, 0]) / w, (xyxy[:, 3] - xyxy[:, 1]) / h], 1)
            targets[i, :20] = np.concatenate([cls[:, None], xywh], 1)
            tmask[i, :20] = True
        shapes = [(ORIG_HW, RATIO_PAD), None if b else (ORIG_HW, RATIO_PAD)]
        batches.append((imgs, targets, tmask, [f"im{b}{i}.png" for i in range(2)], shapes))
    return batches


def _spy(monkeypatch, module, name, record):
    real = getattr(module, name)

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        record.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("conf,over_1024", [(0.001, False), (0.0003, True)])
def test_evaluate_detection_matches_jax(slice_pair, det_loader, monkeypatch, conf,
                                        over_1024):
    spec, params, state, peng = slice_pair
    jax_preds, port_preds, counts = [], [], []
    _spy(monkeypatch, jax_eval, "non_max_suppression", jax_preds)
    _spy(monkeypatch, port_eval, "non_max_suppression", port_preds)
    real_greedy = port_nms.nms_greedy

    def greedy_spy(boxes, scores, iou_thres, max_det):
        assert scores.shape[1] == 20160
        counts.extend((scores > 0).sum(1).tolist())
        return real_greedy(boxes, scores, iou_thres, max_det)

    monkeypatch.setattr(port_nms, "nms_greedy", greedy_spy)
    monkeypatch.setattr(port_nms, "nms_packed", lambda *a: pytest.fail("a list went to K3"))
    want, want_maps, _ = jax_eval.evaluate_detection(
        spec, params, state, det_loader, conf_thres=conf, iou_thres=0.6, fused=True)
    got, got_maps, (_, _, seen) = port_eval.evaluate_detection(
        peng, det_loader, conf_thres=conf, iou_thres=0.6)
    assert seen == 4 and len(counts) == 4
    assert all((n > 1024) == over_1024 for n in counts), counts
    jp = [p for batch in jax_preds for p in batch]
    pp = [p for batch in port_preds for p in batch]
    assert [len(p) for p in pp] == [len(p) for p in jp]
    assert all(len(p) > 100 for p in pp)
    assert 0.05 < got[2] < 0.95                      # mAP@.5 neither 0 nor 1
    np.testing.assert_allclose(got[:4], want[:4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-4)


def test_seg_validation_matches_jax(slice_pair):
    spec, params, state, peng = slice_pair
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(2):
        imgs = (rng.rand(2, *IN_HW, 3) * 255).astype(np.uint8)
        cmap = port_eval.upsample_argmax(peng.forward(torch.from_numpy(imgs))[1],
                                         ORIG_HW, via_hw=IN_HW).numpy().astype(np.int32)
        noise = rng.randint(0, spec.n_segcls, cmap.shape)
        masks = np.where(rng.rand(*cmap.shape) < 0.3, noise, cmap).astype(np.uint8)
        masks[rng.rand(*cmap.shape) < 0.1] = 255
        masks = masks.astype(np.int32)
        masks[masks == 255] = -1                     # the seg loader's ignore
        batches.append((imgs.astype(np.float32) / 255.0, masks))
    want = jax_eval.seg_validation(spec, params, state, batches, nclass=spec.n_segcls,
                                   fused=True)
    got = port_eval.seg_validation(peng, batches, nclass=spec.n_segcls)
    assert 0.3 < got[0] < 0.95 and 0.1 < got[1] < 0.95
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_forward_takes_rect_eval_shapes(slice_pair):
    """A rect batch shape (96x256: 3x8 cells at stride 32) gives the JAX
    forward's candidates and seg logits (tolerances of
    tests/test_torch_engine.py); a frame that is not a multiple of the
    stride raises instead of running."""
    spec, params, state, peng = slice_pair
    img = (np.random.RandomState(8).rand(1, 96, 256, 3) * 255).astype(np.uint8)
    (zs, _), seg_j, _ = jax_forward(spec, params, state, jnp.asarray(img, jnp.float32) / 255.0,
                                    train=False, fused=True, decode="planar", seg_up=False)
    z_j = np.concatenate([np.asarray(z).transpose(2, 0, 1, 3).reshape(1, z.shape[0], -1)
                          for z in zs], 2)
    z_p, seg_p = peng.forward(torch.from_numpy(img))
    np.testing.assert_allclose(z_p[:, :4].numpy(), z_j[:, :4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(z_p[:, 4:].numpy(), z_j[:, 4:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(seg_p.numpy(), np.asarray(seg_j), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="stride"):
        peng.forward(torch.zeros((1, 80, 256, 3), dtype=torch.uint8))


def test_match_predictions_copy_is_exact():
    rng = np.random.RandomState(10)
    iouv = np.linspace(0.5, 0.95, 10)
    for _ in range(8):
        nl, nd = rng.randint(1, 9), rng.randint(0, 14)
        labels = np.zeros((nl, 5))
        labels[:, 0] = rng.randint(0, 3, nl)
        xy = rng.rand(nl, 2) * 200
        labels[:, 1:3], labels[:, 3:5] = xy, xy + rng.rand(nl, 2) * 60 + 10
        dets = np.zeros((nd, 6), np.float32)
        for k in range(nd):
            j = k % nl
            dets[k, :4] = labels[j, 1:5] + rng.randn(4) * 5
            dets[k, 4], dets[k, 5] = rng.rand(), labels[j, 0] if rng.rand() < 0.8 else 2
        np.testing.assert_array_equal(port_eval._match_predictions(dets, labels, iouv),
                                      jax_eval._match_predictions(dets, labels, iouv))


def test_ap_per_class_and_fitness_copy_is_exact():
    rng = np.random.RandomState(11)
    n = 400
    tp = rng.rand(n, 10) < np.linspace(0.7, 0.2, 10)
    conf = rng.choice(np.linspace(0.01, 1, 50), n)      # tied confidences
    pred_cls = rng.randint(0, 6, n).astype(np.float64)
    target_cls = rng.randint(0, 7, 120).astype(np.float64)
    got = port_metrics.ap_per_class(tp, conf, pred_cls, target_cls)
    want = jax_metrics.ap_per_class(tp, conf, pred_cls, target_cls)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    x = rng.rand(3, 7)
    np.testing.assert_array_equal(port_metrics.fitness(x), jax_metrics.fitness(x))
    np.testing.assert_array_equal(port_metrics.fitness2(x, 0.4), jax_metrics.fitness2(x, 0.4))
    with pytest.raises(NotImplementedError):
        port_metrics.ap_per_class(tp, conf, pred_cls, target_cls, plot=True)


def test_seg_metric_and_confusion_copy_is_exact():
    rng = np.random.RandomState(12)
    a, b = port_metrics.SegMetric(7), jax_metrics.SegMetric(7)
    for _ in range(3):
        pred = rng.randint(0, 7, (2, 33, 47))
        target = rng.randint(-1, 7, (2, 33, 47))
        logits = rng.rand(2, 33, 47, 7)
        for m in (a, b):
            m.update(pred, target)
            m.update(logits, target)
    assert (a.pix_acc, a.miou) == (b.pix_acc, b.miou)
    np.testing.assert_array_equal(a.iou, b.iou)
    ca, cb = port_metrics.ConfusionMatrix(4), jax_metrics.ConfusionMatrix(4)
    labels = np.concatenate([rng.randint(0, 4, (9, 1)), rng.rand(9, 2) * 100,
                             rng.rand(9, 2) * 100 + 100], 1)
    dets = np.concatenate([labels[:, 1:5] + rng.randn(9, 4) * 8, rng.rand(9, 1),
                           rng.randint(0, 4, (9, 1))], 1)
    for c in (ca, cb):
        c.process_batch(dets, labels)
    np.testing.assert_array_equal(ca.matrix, cb.matrix)


def test_float_batches_are_not_quantised(slice_pair, monkeypatch):
    """A float batch off the k/255 lattice (``rng.rand``, float32) goes to
    the forward as float, through K1's float mode (its plain version here),
    as the JAX package's ``seg_validation`` feeds it to its forward: the
    1/8-res logits of ``Engine.forward`` and of the forward inside
    ``seg_validation`` match the JAX forward's within 1e-4 (the tolerance of
    tests/test_torch_engine.py), and pixAcc and mIoU match within 1e-4.
    Rounding the batch to uint8 first moves the logits far past that."""
    spec, params, state, peng = slice_pair
    rng = np.random.RandomState(11)
    imgs = rng.rand(2, *IN_HW, 3).astype(np.float32)
    _, seg_j, _ = jax_forward(spec, params, state, jnp.asarray(imgs), train=False,
                              fused=True, decode=False, seg_up=False)
    seg_j = np.array(seg_j)
    _, seg_p = peng.forward(torch.from_numpy(imgs))
    np.testing.assert_allclose(seg_p.numpy(), seg_j, rtol=0, atol=1e-4)

    cmap = port_eval.upsample_argmax(torch.from_numpy(seg_j), ORIG_HW,
                                     via_hw=IN_HW).numpy().astype(np.int32)
    masks = np.where(rng.rand(*cmap.shape) < 0.3,
                     rng.randint(0, spec.n_segcls, cmap.shape), cmap).astype(np.int32)
    masks[rng.rand(*cmap.shape) < 0.1] = -1
    seen = []
    real = Engine.forward
    monkeypatch.setattr(Engine, "forward",
                        lambda self, x: seen.append(x.dtype) or real(self, x))
    want = jax_eval.seg_validation(spec, params, state, [(imgs, masks)],
                                   nclass=spec.n_segcls, fused=True)
    got = port_eval.seg_validation(peng, [(imgs, masks)], nclass=spec.n_segcls)
    assert seen == [torch.float32]
    assert 0.3 < got[0] < 0.95 and 0.1 < got[1] < 0.95
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
