"""The eval loaders' host resamplers (multiyolov5_tpu_torch/data/resize.py)
against the libraries the JAX loaders call, on seeded uint8 frames of 1
and 3 channels.

* ``resize_area`` against ``cv2.resize(..., INTER_AREA)``: integer
  factors 2 (cv2's rounded 2x2 mean), 3 and 4 (its float32 block mean),
  and fractional factors 0.5-0.9 of odd and even sizes (its coverage
  weights); the Cityscapes 2048x1024 -> 1024x512 shrink.  Equal, every
  value: no bound is needed.
* ``resize_bilinear_pil`` against PIL's ``Image.resize(..., BILINEAR)``,
  shrinking (the widened support) and growing, at the same sizes.  Equal.
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from multiyolov5_tpu_torch.data.resize import resize_area, resize_bilinear_pil
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

SIZES = [(37, 53), (64, 128), (120, 333), (101, 77)]
FACTORS = [2, 3, 4, 0.5, 0.6, 0.7, 0.75, 0.8, 0.9, 2 / 3, 0.999]


def _frame(rng, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2)[..., None] + np.arange(c) * 50
    img = ((base + rng.randint(0, 60, (h, w, c))) % 256).astype(np.uint8)
    img[: h // 4] = rng.randint(0, 256, img[: h // 4].shape)          # a noisy band
    return img[..., 0] if c == 1 else img


def _target(h, w, f):
    if f >= 1:
        return w // f, h // f
    return max(1, int(w * f)), max(1, int(h * f))


def _cases():
    for h, w in SIZES:
        for f in FACTORS:
            yield h, w, f


@pytest.mark.parametrize("c", [1, 3])
def test_resize_area_equals_cv2(c):
    rng = np.random.RandomState(c)
    n = 0
    for h, w, f in _cases():
        img = _frame(rng, h, w, c)
        wh = _target(h, w, f)
        got = resize_area(img, wh)
        want = cv2.resize(img, wh, interpolation=cv2.INTER_AREA)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} -> {wh}")
        n += 1
    assert n == len(SIZES) * len(FACTORS)


@pytest.mark.parametrize("c", [1, 3])
def test_resize_bilinear_equals_pil(c):
    rng = np.random.RandomState(10 + c)
    for h, w, f in list(_cases()) + [(37, 53, 1.7), (64, 128, 1.25)]:
        img = _frame(rng, h, w, c)
        wh = _target(h, w, f) if f < 1 or f == int(f) else (int(w * f), int(h * f))
        got = resize_bilinear_pil(img, wh)
        want = np.asarray(Image.fromarray(img).resize(wh, Image.BILINEAR))
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} -> {wh}")
    # one axis kept: PIL skips that pass
    img = _frame(rng, 40, 90, c)
    for wh in ((90, 23), (31, 40), (90, 40)):
        np.testing.assert_array_equal(resize_bilinear_pil(img, wh),
                                      np.asarray(Image.fromarray(img).resize(wh, Image.BILINEAR)))


def test_cityscapes_frame_both_resamplers():
    """A 2048x1024 frame to 1024x512: the detection loader's INTER_AREA
    shrink by exactly 2 and the testval transform's PIL shrink."""
    img = _frame(np.random.RandomState(7), 1024, 2048, 3)
    np.testing.assert_array_equal(resize_area(img, (1024, 512)),
                                  cv2.resize(img, (1024, 512), interpolation=cv2.INTER_AREA))
    np.testing.assert_array_equal(resize_bilinear_pil(img, (1024, 512)),
                                  np.asarray(Image.fromarray(img).resize((1024, 512),
                                                                         Image.BILINEAR)))


def test_resize_area_refuses_a_grow_and_other_types():
    img = np.zeros((10, 10, 3), np.uint8)
    with pytest.raises(ValueError, match="shrinks"):
        resize_area(img, (11, 10))
    with pytest.raises(ValueError, match="uint8"):
        resize_bilinear_pil(img.astype(np.float32), (5, 5))
