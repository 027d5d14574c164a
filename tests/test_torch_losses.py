"""The port's training losses against the JAX package's, on the CPU in float32.

Same seeded inputs (numpy) to both; the raw detection maps go in the
(B, na, ny, nx, no) layout both take, the segmentation logits planar to
the port and NHWC to JAX.  Bounds: detection values within 1e-5 relative,
segmentation values within 5e-5 relative (n * eps for the float32 sums
over their 768 pixels, taken in another order; read: 3.3e-6), gradients
within 1e-4 relative + 1e-6 absolute (float32 summation order; the JAX
loss gathers by a one-hot contraction, the port by indexing, which give
the same values).  The detection cases include two targets in one
cell, where ``tobj`` takes the larger IoU (a last-write-wins scatter would
not), and a case with label smoothing and focal loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.train import losses as JL
from multiyolov5_tpu.utils.boxes import bbox_iou_ciou as jax_ciou
from multiyolov5_tpu_torch.train import losses as PL
from multiyolov5_tpu_torch.utils.boxes import bbox_iou_ciou
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]]
STRIDES = [8, 16, 32]
HYP = {"box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0, "obj_pw": 1.0, "anchor_t": 4.0,
       "fl_gamma": 0.0, "label_smoothing": 0.0}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-6,
                               err_msg=what)


def _det_inputs(seed, nc=3, sz=64, B=2, T=6):
    rng = np.random.RandomState(seed)
    preds = [rng.randn(B, 3, sz // s, sz // s, nc + 5).astype(np.float32) for s in STRIDES]
    tgts = np.zeros((B, T, 5), np.float32)
    tgts[:, :, 0] = rng.randint(0, nc, (B, T))
    tgts[:, :, 1:3] = rng.rand(B, T, 2) * 0.8 + 0.1
    tgts[:, :, 3:5] = rng.rand(B, T, 2) * 0.4 + 0.05
    # two targets in one cell with different sizes: tobj keeps the larger IoU
    tgts[0, 1, 1:3] = tgts[0, 0, 1:3] + 0.001
    tgts[0, 1, 3:5] = tgts[0, 0, 3:5] * 1.3
    mask = np.ones((B, T), bool)
    mask[1, T - 2:] = False
    return preds, tgts, mask


@pytest.mark.parametrize("hyp_over", [{}, {"label_smoothing": 0.1, "fl_gamma": 1.5}],
                         ids=["plain", "smoothing_focal"])
def test_detection_loss_matches_jax(hyp_over):
    hyp = {**HYP, **hyp_over}
    anchors = np.asarray(ANCHORS, np.float32).reshape(3, 3, 2) / np.asarray(
        STRIDES, np.float32)[:, None, None]
    preds, tgts, mask = _det_inputs(7)
    jl = JL.DetectionLoss(nc=3, na=3, anchors=anchors, strides=STRIDES, hyp=hyp)
    (jv, jitems), jgrads = jax.value_and_grad(
        lambda ps: jl(ps, jnp.asarray(tgts), jnp.asarray(mask)), has_aux=True)(
        [jnp.asarray(p) for p in preds])
    pl = PL.DetectionLoss(nc=3, na=3, anchors=anchors, strides=STRIDES, hyp=hyp)
    pt = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    pv, pitems = pl(pt, torch.from_numpy(tgts), torch.from_numpy(mask))
    pv.backward()
    np.testing.assert_allclose(pv.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(pitems.numpy(), np.asarray(jitems), rtol=1e-5)
    for i, (a, b) in enumerate(zip(pt, jgrads)):
        _close(a.grad.numpy(), b, f"dpred level {i}")


def test_detection_loss_same_cell_is_order_free():
    """Image 0's first two targets share their centre cell with different
    sizes, so their IoUs there differ: a last-write-wins ``tobj`` would
    change with their order, the max-scatter does not, and both orders
    equal the JAX loss."""
    anchors = np.asarray(ANCHORS, np.float32).reshape(3, 3, 2) / np.asarray(
        STRIDES, np.float32)[:, None, None]
    preds, tgts, mask = _det_inputs(8)
    pl = PL.DetectionLoss(nc=3, na=3, anchors=anchors, strides=STRIDES, hyp=HYP)
    jl = JL.DetectionLoss(nc=3, na=3, anchors=anchors, strides=STRIDES, hyp=HYP)
    pt = [torch.from_numpy(p[:1]) for p in preds]
    items = []
    for order in ([0, 1], [1, 0]):
        t, m = tgts[:1, order], mask[:1, order]
        got = pl(pt, torch.from_numpy(t), torch.from_numpy(m))[1].numpy()
        want = jl([jnp.asarray(p[:1]) for p in preds], jnp.asarray(t), jnp.asarray(m))[1]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
        items.append(got)
    np.testing.assert_allclose(items[0], items[1], rtol=1e-6)


def test_bbox_iou_ciou_matches_jax():
    rng = np.random.RandomState(9)
    b1 = np.concatenate([rng.rand(64, 2) * 4, rng.rand(64, 2) * 3 + 0.1], 1).astype(np.float32)
    b2 = np.concatenate([rng.rand(64, 2) * 4, rng.rand(64, 2) * 3 + 0.1], 1).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda a: jnp.sum(jax_ciou(a, jnp.asarray(b2))))(jnp.asarray(b1))
    t1 = torch.from_numpy(b1).requires_grad_(True)
    v = bbox_iou_ciou(t1, torch.from_numpy(b2))
    v.sum().backward()
    _close(v.detach().numpy(), jax_ciou(jnp.asarray(b1), jnp.asarray(b2)), "ciou")
    np.testing.assert_allclose(v.sum().item(), float(jv), rtol=1e-5)
    _close(t1.grad.numpy(), jg, "dciou (alpha carries no gradient)")


def _seg_inputs(seed, b=2, c=5, h=16, w=24):
    rng = np.random.RandomState(seed)
    z = (rng.randn(b, h, w, c) * 2).astype(np.float32)
    y = rng.randint(0, c, (b, h, w))
    y = np.where(rng.rand(b, h, w) < 0.2, -1, y).astype(np.int32)
    return z, y, rng.rand(c).astype(np.float32) + 0.5


SEG = {
    "ce_weighted": (lambda z, y, w: JL.cross_entropy_seg(z, y, w),
                    lambda z, y, w: PL.cross_entropy_seg(z, y, w)),
    "segmentation_loss": (lambda z, y, w: JL.segmentation_loss(z, y),
                          lambda z, y, w: PL.segmentation_loss(z, y)),
    "ohem": (lambda z, y, w: JL.ohem_ce_loss(z, y), lambda z, y, w: PL.ohem_ce_loss(z, y)),
    "focal": (lambda z, y, w: JL.seg_focal_loss(z, y), lambda z, y, w: PL.seg_focal_loss(z, y)),
}


@pytest.mark.parametrize("name", list(SEG))
def test_seg_losses_match_jax(name):
    jfn, pfn = SEG[name]
    z, y, wv = _seg_inputs(11)
    jv, jg = jax.value_and_grad(lambda zz: jfn(zz, jnp.asarray(y), jnp.asarray(wv)))(
        jnp.asarray(z))
    zt = torch.from_numpy(z.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    pv = pfn(zt, torch.from_numpy(y).long(), torch.from_numpy(wv))
    pv.backward()
    np.testing.assert_allclose(pv.item(), float(jv), rtol=5e-5)
    _close(zt.grad.numpy().transpose(0, 2, 3, 1), jg, f"d{name}")


def test_pad_targets_matches_jax():
    labels = [np.ones((3, 5), np.float32), np.zeros((0, 5), np.float32),
              np.arange(50, dtype=np.float32).reshape(10, 5)]
    for a, b in zip(PL.pad_targets(labels, 8), JL.pad_targets(labels, 8)):
        np.testing.assert_array_equal(a, b)
