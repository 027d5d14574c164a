"""The port's remaining augmentations and helpers against the JAX package,
on the CPU.

* ``DetectionDataset.load_mosaic9`` after ``random.seed(s)`` (JAX) against
  the port's with ``random.Random(s)``: the same image, bit for bit, and
  the labels within 1e-6 (as tests/test_torch_train_data.py's items), on
  that file's PNG tree, with and without a perspective warp.
* ``replicate`` and ``cutout`` seeded alike: equal images and labels.
* ``hist_equalize`` (CLAHE and ``equalizeHist``, RGB and BGR) equal to the
  JAX one value for value, at sides that are and are not multiples of the
  8 x 8 tile grid (cv2 pads those); the YUV conversions equal cv2 on every
  8-bit colour; CLAHE and ``equalizeHist`` equal cv2 on flat, narrow and
  tiny images.
* ``prune_params`` / ``sparsity`` on a seeded pspv5s state dict: the same
  zero set as the JAX function on the same weights (its params), the same
  fraction; the quantile equals ``jnp.quantile`` bit for bit.
* ``wh_iou`` within 1e-6 of the JAX one, on numpy and torch inputs.
* ``seg_confusion_device`` (NCHW logits, labels with -1 and labels past
  the classes): the same integer counts as the JAX one, and as the host
  ``SegMetric`` histograms where the labels are all below the classes.
* ``check_requirements``, ``check_git_status`` and ``copy_attr`` behave as
  the JAX ones.
"""

import random

import cv2
import numpy as np
import pytest
import torch

from multiyolov5_tpu.data import detection as jax_det
from multiyolov5_tpu_torch.data import augment as A
from multiyolov5_tpu_torch.data import detection as port_det

from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_data import IMG, _close_item, _frame, _hyp, det_tree  # noqa: F401

MOSAIC9 = {"plain": dict(), "perspective": dict(perspective=1e-3, degrees=5.0, shear=2.0)}


@pytest.mark.parametrize("case", sorted(MOSAIC9))
def test_load_mosaic9_matches_jax(det_tree, case):  # noqa: F811 (fixture)
    kw = dict(img_size=IMG, batch_size=4, augment=True, hyp=_hyp(**MOSAIC9[case]), stride=32)
    jds = jax_det.DetectionDataset(det_tree, **kw)
    pds = port_det.DetectionDataset(det_tree, **kw)
    for i in range(len(pds)):
        s = 300 + 11 * i
        random.seed(s)
        want = jds.load_mosaic9(i)
        got = pds.load_mosaic9(i, random.Random(s))
        _close_item(got + (None, None), want + (None, None), f"{case} mosaic9 {i}")


def _boxes(rng, n, h, w):
    xy = rng.rand(n, 2) * [w * 0.7, h * 0.7]
    wh = rng.rand(n, 2) * [w * 0.3, h * 0.3] + 2
    return np.concatenate([rng.randint(0, 5, (n, 1)), xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replicate_and_cutout_match_jax(seed):
    rng = np.random.RandomState(seed)
    img = _frame(rng, 96, 128)
    labels = _boxes(rng, 6 + seed, 96, 128)
    random.seed(seed)
    want = jax_det.replicate(img.copy(), labels.copy())
    got = port_det.replicate(img.copy(), labels.copy(), random.Random(seed))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    random.seed(seed + 10)
    want_img = img.copy()
    want_lab = jax_det.cutout(want_img, labels.copy())
    got_img = img.copy()
    got_lab = port_det.cutout(got_img, labels.copy(), random.Random(seed + 10))
    assert np.array_equal(got_img, want_img) and np.array_equal(got_lab, want_lab)


@pytest.mark.parametrize("hw", [(64, 128), (96, 96), (61, 83), (37, 200), (130, 64)])
@pytest.mark.parametrize("clahe,bgr", [(True, False), (True, True), (False, False),
                                       (False, True)])
def test_hist_equalize_matches_jax(hw, clahe, bgr):
    img = _frame(np.random.RandomState(hw[0] * 3 + hw[1]), *hw)
    want = jax_det.hist_equalize(img.copy(), clahe=clahe, bgr=bgr)
    got = port_det.hist_equalize(img.copy(), clahe=clahe, bgr=bgr)
    assert got.dtype == np.uint8 and np.array_equal(got, want), \
        f"{(got != want).sum()} values differ"


def test_yuv_conversions_equal_cv2_on_every_colour():
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    rgb = rgb.reshape(4096, 4096, 3)
    assert np.array_equal(A.rgb2yuv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV))
    assert np.array_equal(A.yuv2rgb(rgb), cv2.cvtColor(rgb, cv2.COLOR_YUV2RGB))


@pytest.mark.parametrize("hw", [(64, 64), (64, 80), (60, 64), (37, 53), (3, 5), (1, 1),
                                (17, 9), (512, 1024)])
def test_clahe_and_equalize_hist_equal_cv2(hw):
    rng = np.random.RandomState(hw[0] + 7 * hw[1])
    c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    for img in (rng.randint(0, 256, hw).astype(np.uint8),
                (rng.rand(*hw) ** 3 * 80 + 40).astype(np.uint8),      # a narrow range
                np.full(hw, 77, np.uint8)):                             # one level
        assert np.array_equal(A.clahe(img, 2.0, (8, 8)), c.apply(img))
        assert np.array_equal(A.equalize_hist(img), cv2.equalizeHist(img))


def test_prune_params_and_sparsity_match_jax(capsys):
    import jax.numpy as jnp
    from multiyolov5_tpu.utils import general as JG
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.utils import general as G
    from multiyolov5_tpu_torch.utils.checkpoint import to_jax_params

    sd = seeded_state_dict(load_spec("yolov5s_city_seg"), 0)
    params, _ = to_jax_params(sd)
    want = JG.prune_params({k: jnp.asarray(v) for k, v in params.items()}, 0.3)
    got = G.prune_params(sd, 0.3)
    got_p, _ = to_jax_params(got)
    assert set(got_p) == set(want)
    for k, v in want.items():
        assert np.array_equal(np.asarray(got_p[k]) == 0, np.asarray(v) == 0), k
    # over the same tensors (the JAX params leave out the BN buffers)
    assert G.sparsity(got_p) == JG.sparsity(want) > 0.29
    rng = np.random.RandomState(0)
    for n in (2, 3, 100, 12345):
        for q in (0.1, 0.3, 0.77):
            a = np.abs(rng.randn(n)).astype(np.float32)
            assert G._quantile(a, q) == np.float32(jnp.quantile(jnp.asarray(a), q)), (n, q)


def test_wh_iou_matches_jax():
    from multiyolov5_tpu.utils.boxes import wh_iou as jax_wh_iou
    from multiyolov5_tpu_torch.utils.boxes import wh_iou

    rng = np.random.RandomState(5)
    a = (rng.rand(9, 2) * 50 + 1).astype(np.float32)
    b = (rng.rand(7, 2) * 50 + 1).astype(np.float32)
    want = np.asarray(jax_wh_iou(a, b))
    np.testing.assert_allclose(wh_iou(a, b), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(wh_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("nclass,hi", [(5, 5), (19, 22)])
def test_seg_confusion_device_counts_match_jax(nclass, hi):
    import jax.numpy as jnp
    from multiyolov5_tpu.utils.metrics import seg_confusion_device as jax_counts
    from multiyolov5_tpu_torch.utils.metrics import SegMetric, seg_confusion_device

    rng = np.random.RandomState(nclass)
    logits = rng.randn(2, nclass, 24, 40).astype(np.float32)
    target = rng.randint(-1, hi, (2, 24, 40))
    ji, ju = jax_counts(jnp.asarray(logits.transpose(0, 2, 3, 1)), jnp.asarray(target), nclass)
    pi, pu = seg_confusion_device(torch.from_numpy(logits), torch.from_numpy(target), nclass)
    assert pi.dtype == torch.int64 and pu.dtype == torch.int64
    assert np.array_equal(pi.numpy(), np.asarray(ji).astype(np.int64))
    assert np.array_equal(pu.numpy(), np.asarray(ju).astype(np.int64))
    if hi == nclass:
        m = SegMetric(nclass)
        m.update(logits.argmax(1), target)
        assert np.array_equal(pi.numpy(), m.total_inter) and np.array_equal(pu.numpy(),
                                                                            m.total_union)


def test_small_helpers_match_jax(capsys):
    from multiyolov5_tpu.utils import general as JG
    from multiyolov5_tpu_torch.utils import general as G

    G.check_requirements(["numpy>=1.0", "no_such_module_x", "torch"], exclude=["torch"])
    JG.check_requirements(["numpy>=1.0", "no_such_module_x", "torch"], exclude=["torch"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1] and "no_such_module_x" in out[0]
    assert G.check_git_status() is None and JG.check_git_status() is None

    class Src:
        def __init__(self):
            self.a, self.b, self._c, self.d = 1, 2, 3, 4

    for copy in (G.copy_attr, JG.copy_attr):
        dst = type("Dst", (), {})()
        copy(dst, Src(), include=("a", "b", "_c"), exclude=("b",))
        assert vars(dst) == {"a": 1}
        dst = type("Dst", (), {})()
        copy(dst, Src())
        assert vars(dst) == {"a": 1, "b": 2, "d": 4}
