"""K6's plain version, and the ``seg_ce`` wrapper's CPU path, against the JAX
package's ``seg_ce_up8`` (interpret mode on the CPU) and against its
reference ``cross_entropy_seg . resize_bilinear``: value and dz.

The cases mirror tests/test_seg_ce_kernel.py.  The port takes planar
(B, C, h, w) logits, the JAX function NHWC; the same seeded numbers go to
both.  Bounds, float32: the loss within 5e-5 relative and dz within 2e-4
relative + 1e-7 absolute, the bounds tests/test_seg_ce_kernel.py holds
the kernel to (summation order; torch interpolates with float32 weights,
the JAX package with float64-built matrices rounded to float32).  bf16
logits: the JAX kernel rounds its column-interpolated plane to bf16 (its
MXU input) where the port computes in float32, so the loss is held within
2e-2 relative and dz within 0.1 relative + 2e-4, as there.
All labels ignored: exactly 0 and a zero gradient, not NaN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.ops.pallas.seg_ce_kernel import seg_ce_up8
from multiyolov5_tpu.ops.resize import resize_bilinear
from multiyolov5_tpu.train.losses import cross_entropy_seg
from multiyolov5_tpu_torch.ops.kernels import seg_ce, seg_ce_plain


def _data(seed, b=2, h=8, w=16, c=7, k=8, ignore_frac=0.2):
    rng = np.random.RandomState(seed)
    z = rng.randn(b, h, w, c).astype(np.float32)          # NHWC, the JAX layout
    y = rng.randint(0, c, (b, k * h, k * w))
    y = np.where(rng.rand(*y.shape) < ignore_frac, -1, y).astype(np.int32)
    wv = rng.rand(c).astype(np.float32) + 0.5
    return z, y, wv


def _jax(fn, z, y, wv, scale, dtype):
    zj = jnp.asarray(z, dtype)
    yj = jnp.asarray(y)
    wj = None if wv is None else jnp.asarray(wv)
    val, grad = jax.value_and_grad(lambda zz: scale * fn(zz, yj, wj))(zj)
    return float(val) / scale, np.asarray(grad, np.float32).transpose(0, 3, 1, 2)


def _ref(zz, y, w):
    return cross_entropy_seg(resize_bilinear(zz, y.shape[1:]), y, w)


def _kernel(zz, y, w):
    return seg_ce_up8(zz, y, weight=w)


def _port(fn, z, y, wv, scale, dtype):
    zt = torch.from_numpy(z.transpose(0, 3, 1, 2).copy()).to(dtype).requires_grad_(True)
    loss = fn(zt, torch.from_numpy(y).long(), None if wv is None else torch.from_numpy(wv))
    (scale * loss).backward()
    assert loss.dtype == torch.float32 and zt.grad.dtype == dtype
    return loss.item(), zt.grad.float().numpy()


CASES = {
    "unweighted": dict(seed=1, weighted=False, scale=1.0),
    "weighted_scaled": dict(seed=2, weighted=True, scale=3.5, c=5),
    "nondivisible_6x12": dict(seed=3, weighted=False, scale=1.0, b=1, h=6, w=12, c=4),
}


@pytest.mark.parametrize("fn", [seg_ce_plain, seg_ce], ids=["plain", "wrapper"])
@pytest.mark.parametrize("case", list(CASES))
def test_seg_ce_matches_jax_float32(fn, case):
    kw = dict(CASES[case])
    seed, weighted, scale = kw.pop("seed"), kw.pop("weighted"), kw.pop("scale")
    z, y, wv = _data(seed, **kw)
    wv = wv if weighted else None
    got, dz = _port(fn, z, y, wv, scale, torch.float32)
    for ref in (_ref, _kernel):
        want, dz_want = _jax(ref, z, y, wv, scale, jnp.float32)
        np.testing.assert_allclose(got, want, rtol=5e-5)
        np.testing.assert_allclose(dz, dz_want, rtol=2e-4, atol=1e-7)


def test_seg_ce_matches_jax_bf16():
    z, y, _ = _data(4, b=1)
    got, dz = _port(seg_ce, z, y, None, 1.0, torch.bfloat16)
    want, dz_want = _jax(_kernel, z, y, None, 1.0, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    np.testing.assert_allclose(dz, dz_want, rtol=0.1, atol=2e-4)


@pytest.mark.parametrize("fn", [seg_ce_plain, seg_ce], ids=["plain", "wrapper"])
def test_seg_ce_all_ignored_is_zero(fn):
    z, y, wv = _data(5, b=1, h=4, w=8, c=3)
    y[:] = -1
    got, dz = _port(fn, z, y, wv, 1.0, torch.float32)
    assert got == 0.0 and not np.any(dz)
    want, _ = _jax(_kernel, z, y, wv, 1.0, jnp.float32)
    assert want == 0.0
