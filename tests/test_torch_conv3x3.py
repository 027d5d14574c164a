"""Port's 3x3 conv (K2's plain version) against the three JAX Pallas 3x3
kernels it replaces, in interpret mode on the CPU, and K2's launch planner.

float32 on both sides; the summation order differs (im2col dots vs
F.conv2d), so outputs agree to 1e-4 relative and absolute.

The planner (``plan``) is pure Python: it must give a tile and a K split
for every K2 site of every zoo entry at bs1 1024x512 and at bs8 1024x1024
(the sites recorded from a forward at 128x256 and scaled), at least one
CTA an SM (132) at each of pspv5s's bs1 sites, a split a cluster can hold
(<= 8) with at least one K step a CTA, and it raises on c_in % 16 != 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.ops.pallas.c3_kernel import conv3x3_packed_pallas, packed_q_for
from multiyolov5_tpu.ops.pallas.conv3x3_kernel import (conv3x3_silu_pallas,
                                                       conv3x3s2_silu_pallas)
from multiyolov5_tpu_torch.models import blocks, zoo
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import Model
from multiyolov5_tpu_torch.ops.kernels import conv3x3, conv3x3_plain
from multiyolov5_tpu_torch.ops.kernels.conv3x3 import MAX_SPLIT, SMS, plan

TOL = 1e-4


def _jax_conv(kind, x, w, b, d, act):
    if kind == "s1":
        return conv3x3_silu_pallas(x, w, b, d=d, act=act)
    if kind == "s2":
        return conv3x3s2_silu_pallas(x, w, b, act=act)
    q = packed_q_for(x.shape[-1], x.shape[2], d)
    assert q > 1
    return conv3x3_packed_pallas(x, w, b, q=q, d=d, act=act)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("kind,d,shape", [
    ("s1", 1, (1, 16, 24, 32, 48)),
    ("s1", 2, (1, 16, 24, 32, 48)),
    ("s1", 3, (2, 12, 20, 16, 32)),
    ("s2", 1, (1, 16, 24, 32, 48)),
    ("packed", 1, (1, 8, 32, 32, 32)),
    ("packed", 2, (1, 8, 32, 32, 32)),
])
def test_conv3x3_plain_matches_pallas(kind, d, shape, act):
    b, h, w, ci, co = shape
    rng = np.random.RandomState(ci + co + d + h)
    x = rng.randn(b, h, w, ci).astype(np.float32)
    wt = (rng.randn(3, 3, ci, co) * 0.1).astype(np.float32)
    bi = (rng.randn(co) * 0.1).astype(np.float32)
    want = np.asarray(_jax_conv(kind, jnp.asarray(x), jnp.asarray(wt),
                                jnp.asarray(bi), d, act))
    stride = 2 if kind == "s2" else 1
    args = (torch.from_numpy(x), torch.from_numpy(wt.transpose(3, 0, 1, 2).copy()),
            torch.from_numpy(bi))       # the port's kernel takes OHWI weights
    got = conv3x3(*args, stride=stride, dilation=d, act=act)   # CPU: plain
    np.testing.assert_array_equal(
        got.numpy(), conv3x3_plain(*args, stride, d, act).numpy())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _k2_sites(cfg):
    """(stride of the site's input, c_in, c_out, conv stride, dilation) of
    each K2 launch of a fused ``cfg`` forward, recorded at 128x256 on the
    CPU."""
    sites = []

    def rec(x, w, b, stride=1, dilation=1, act=True):
        sites.append((128 // x.shape[1], x.shape[3], w.shape[0], stride, dilation))
        return conv3x3_plain(x, w, b, stride, dilation, act)

    model = Model(load_spec(cfg), fused=True).eval()
    real = blocks.conv3x3
    blocks.conv3x3 = rec
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, 128, 256))
    finally:
        blocks.conv3x3 = real
    return sites


def _check_plan(p, bsz, ho, wo, ci, co, dt):
    nk = 9 * ci // p.bk
    assert ci % p.bk == 0 and p.bn in (64, 128) and p.bm in (64, 128)
    assert p.bn == 64 or (co % 128 == 0 and dt == torch.bfloat16)
    if dt == torch.bfloat16:    # an 8 x bm/8 rectangle of one image
        assert p.tiles == bsz * -(-ho // 8) * -(-wo // (p.bm // 8)) * -(-co // p.bn)
    else:                       # bm consecutive output pixels
        assert p.tiles == -(-bsz * ho * wo // p.bm) * -(-co // p.bn)
    assert 1 <= p.split <= min(MAX_SPLIT, max(1, nk // 2))
    assert p.ctas == p.tiles * p.split and p.k_steps == -(-nk // p.split)
    # one CTA an SM, unless the split is at its cap
    assert p.ctas >= SMS or p.split == min(MAX_SPLIT, max(1, nk // 2))


@pytest.mark.parametrize("cfg", zoo.available())
def test_k2_plan_every_zoo_site(cfg):
    sites = _k2_sites(cfg)
    assert sites                # every zoo entry's neck has K2 sites
    for s_in, ci, co, stride, dil in sites:
        for bsz, (h, w) in ((1, (512, 1024)), (8, (1024, 1024))):
            ho, wo = (h // s_in - 1) // stride + 1, (w // s_in - 1) // stride + 1
            for dt in (torch.bfloat16, torch.float32):
                _check_plan(plan(bsz, ho, wo, ci, co, dt, stride, dil), bsz, ho, wo, ci, co, dt)


def test_k2_plan_fills_the_card_at_pspv5s_bs1():
    sites = _k2_sites("yolov5s_city_seg")
    assert len(sites) == 10
    for s_in, ci, co, stride, dil in sites:
        ho, wo = (512 // s_in - 1) // stride + 1, (1024 // s_in - 1) // stride + 1
        for dt in (torch.bfloat16, torch.float32):
            p = plan(1, ho, wo, ci, co, dt, stride, dil)
            assert p.ctas >= SMS, (s_in, ci, co, stride, p)
    # the 1/32-res sites: 16x32 output pixels, c_out 256, c_in 256: 32 tiles,
    # a 6-way split (the least >= 132 / 32 that divides the 36 K steps)
    assert plan(1, 16, 32, 256, 256, torch.bfloat16).split == 6


@pytest.mark.parametrize("ci,co,dt", [(24, 64, torch.bfloat16), (8, 64, torch.float32),
                                      (64, 36, torch.bfloat16), (64, 64, torch.float16)])
def test_k2_plan_raises_on_shapes_without_a_kernel(ci, co, dt):
    with pytest.raises(ValueError):
        plan(1, 32, 64, ci, co, dt)
