"""Port's 3x3 conv (K2's plain version) against the three JAX Pallas 3x3
kernels it replaces, in interpret mode on the CPU, and K2's launch planner.

float32 on both sides; the summation order differs (im2col dots vs
F.conv2d), so outputs agree to 1e-4 relative and absolute.

The planner (``plan``) is pure Python: it must give a tile and a K split
for every K2 site of every zoo entry at bs1 1024x512, at eval's bs4
1024x512 and at bs8 1024x1024 (the sites recorded from a forward at
128x256 and scaled), in both types an 8 x bm/8 rectangle of one image by
64 or 128 channels, at least one CTA an SM (132) at each of pspv5s's bs1
sites and at each of its bs4 eval sites unless the split is at its cap, a
split a cluster can hold (<= 8) with at least one K step a CTA, only
plans that csrc/conv3x3.cu has a kernel for, and it raises on c_in % 16
!= 0 and c_out % 8 != 0."""

import itertools
import re
from pathlib import Path

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
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
# bs1 serving, bs4 eval (cli/test.py's batch at 1024x512), bs8 serving
GEOMETRIES = ((1, (512, 1024)), (4, (512, 1024)), (8, (1024, 1024)))
KERNEL_SRC = (Path(__file__).resolve().parents[1] / "multiyolov5_tpu_torch" / "csrc"
              / "conv3x3.cu")


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
    assert p.bk * dt.itemsize in (32, 64, 128) and p.bk >= 16
    assert p.bn == 64 or co % 128 == 0
    # an 8 x bm/8 rectangle of one image, in both types
    assert p.tiles == bsz * -(-ho // 8) * -(-wo // (p.bm // 8)) * -(-co // p.bn)
    cap = min(MAX_SPLIT, max(1, nk // 2))
    assert 1 <= p.split <= cap
    assert p.ctas == p.tiles * p.split and p.k_steps == -(-nk // p.split)
    if dt == torch.float32:     # splits of 1, 2, 4 or 8; no 8x16 x 128 tile
        cap = 1 << (cap.bit_length() - 1)
        assert p.split in (1, 2, 4, 8) and (p.bm, p.bn) != (128, 128)
    # one CTA an SM, unless the split is at its cap
    assert p.ctas >= SMS or p.split == cap


def _kernel_plans():
    """{dtype: {(bk, bm, bn)}} that csrc/conv3x3.cu's C entry launches."""
    names = {"__nv_bfloat16": torch.bfloat16, "float": torch.float32}
    found = {torch.bfloat16: set(), torch.float32: set()}
    for t, bk, bm, bn in re.findall(r"MK_TMA\((\w+), (\d+), (\d+), (\d+)\)",
                                    KERNEL_SRC.read_text()):
        found[names[t]].add((int(bk), int(bm), int(bn)))
    return found


@pytest.mark.parametrize("cfg", zoo.available())
def test_k2_plan_every_zoo_site(cfg):
    sites = _k2_sites(cfg)
    assert sites                # every zoo entry's neck has K2 sites
    kernels = _kernel_plans()
    for s_in, ci, co, stride, dil in sites:
        for bsz, (h, w) in GEOMETRIES:
            ho, wo = (h // s_in - 1) // stride + 1, (w // s_in - 1) // stride + 1
            for dt in (torch.bfloat16, torch.float32):
                p = plan(bsz, ho, wo, ci, co, dt, stride, dil)
                _check_plan(p, bsz, ho, wo, ci, co, dt)
                assert (p.bk, p.bm, p.bn) in kernels[dt], (cfg, p)


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


def test_k2_plan_fills_the_card_at_eval_bs4():
    sites = _k2_sites("yolov5s_city_seg")
    assert len(sites) == 10
    for s_in, ci, co, stride, dil in sites:
        ho, wo = (512 // s_in - 1) // stride + 1, (1024 // s_in - 1) // stride + 1
        p = plan(4, ho, wo, ci, co, torch.float32, stride, dil)
        _check_plan(p, 4, ho, wo, ci, co, torch.float32)
        assert p.ctas >= SMS, (s_in, ci, co, stride, p)
    # FFM's site, (4, 64, 128, 256) -> 128: 512 tiles of 8x8 px x 128 ch, no
    # split; the 1/32-res site, (4, 16, 32, 256) -> 256: 64 such tiles, split 4
    assert plan(4, 64, 128, 256, 128, torch.float32)[:4] == (64, 128, 32, 1)
    assert plan(4, 16, 32, 256, 256, torch.float32)[:4] == (64, 128, 32, 4)


def test_k2_plan_has_a_kernel_for_every_shape():
    """Every plan the planner can give, over tile counts from one to many,
    c_in 16-640 and c_out 8-640, is one that csrc/conv3x3.cu launches."""
    kernels = _kernel_plans()
    for dt in (torch.bfloat16, torch.float32):
        picked = set()
        for (bsz, ho, wo), ci, co in itertools.product(
                ((1, 4, 4), (1, 16, 32), (4, 32, 64), (8, 128, 128)),
                (16, 32, 48, 64, 96, 128, 640), (8, 24, 64, 128, 256, 640)):
            p = plan(bsz, ho, wo, ci, co, dt)
            picked.add((p.bk, p.bm, p.bn))
        assert picked <= kernels[dt], picked - kernels[dt]
    # the float32 form's rows are 128 or 64 bytes (BK 32 or 16 channels)
    assert {bk for bk, _, _ in kernels[torch.float32]} == {32, 16}


@pytest.mark.parametrize("ci,co,dt", [(24, 64, torch.bfloat16), (8, 64, torch.float32),
                                      (64, 36, torch.bfloat16), (64, 64, torch.float16),
                                      (64, 36, torch.float32), (24, 64, torch.float32),
                                      (48, 12, torch.float32)])
def test_k2_plan_raises_on_shapes_without_a_kernel(ci, co, dt):
    with pytest.raises(ValueError):
        plan(1, 32, 64, ci, co, dt)
