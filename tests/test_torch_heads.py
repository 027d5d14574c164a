"""The port's new blocks and seg heads against the JAX package's functions,
on the CPU in float32.

Blocks (``C3SPP``, ``ASPP`` with and without its global branch, ``RFB2``
with its global branch) take JAX ``Initializer`` weights with BN affine
parameters and running statistics drawn from a seed, unfused in eval mode
and BN-folded (``fuse_conv_bn`` on each side); the heads (``SegMaskBase``,
``SegMaskBiSe``, ``SegMaskLab``) take the port's seeded weights of their
zoo entry narrowed to ``width_multiple`` 0.25 (``seeded_state_dict``: BN
statistics measured, so activations keep unit scale), in the JAX layout
through ``to_jax_params``, BN-folded, built as the engine builds them
(``fused=True, kernel=True``: their K2 sites run K2's plain version here),
against ``heads.seg_*`` in fused eval with
``seg_up=False`` (1/8-res NCHW logits), on seeded random neck maps.
Float32 reassociation only: outputs within 1e-5 of their largest |value|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.models import blocks as JB
from multiyolov5_tpu.models import heads as JH
from multiyolov5_tpu.models import zoo as jax_zoo
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.ops.nn import Ctx, Initializer
from multiyolov5_tpu.ops.nn import fuse_conv_bn as jax_fuse
from multiyolov5_tpu_torch.models import blocks, heads
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import seeded_state_dict
from multiyolov5_tpu_torch.ops.nn import fuse_conv_bn
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params, to_jax_params
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

REL = 1e-5


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert got.shape == want.shape and scale > 0.1
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=REL * scale)


def _sub(sd: dict, prefix: str) -> dict:
    """The entries of ``sd`` under ``prefix.``, with the prefix removed."""
    return {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _random_bn(ini: Initializer, rng) -> None:
    for k in list(ini.state):
        if k.endswith(".running_mean"):
            b = k[:-len(".running_mean")]
            c = ini.state[k].shape[0]
            ini.state[k] = rng.randn(c).astype(np.float32) * 0.1
            ini.state[b + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            ini.params[b + ".weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
            ini.params[b + ".bias"] = rng.randn(c).astype(np.float32) * 0.1


# name: (port module, JAX init, JAX apply, c_in)
BLOCKS = {
    "c3spp": (lambda f: blocks.C3SPP(32, 48, fused=f),
              lambda ini: JB.init_c3spp(ini, "b", 32, 48),
              lambda ctx, x: JB.c3spp(ctx, "b", x, 32, 48), 32),
    "aspp_global": (lambda f: blocks.ASPP(64, 32, fused=f),
                    lambda ini: JB.init_aspp(ini, "b", 64, 32),
                    lambda ctx, x: JB.aspp(ctx, "b", x), 64),
    "aspp": (lambda f: blocks.ASPP(64, 32, has_globel=False, map_reduce=2, fused=f),
             lambda ini: JB.init_aspp(ini, "b", 64, 32, has_globel=False, map_reduce=2),
             lambda ctx, x: JB.aspp(ctx, "b", x, has_globel=False), 64),
    "rfb2_global": (lambda f: blocks.RFB2(64, 32, map_reduce=4, has_globel=True, fused=f),
                    lambda ini: JB.init_rfb2(ini, "b", 64, 32, map_reduce=4, has_globel=True),
                    lambda ctx, x: JB.rfb2(ctx, "b", x, d=(2, 3), has_globel=True), 64),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name, fused):
    make, init, apply, c_in = BLOCKS[name]
    rng = np.random.RandomState(3)
    ini = Initializer(seed=1)
    init(ini)
    _random_bn(ini, rng)
    params, state = ini.params, ini.state
    sd = _sub(from_jax_params(params, state), "b")
    if fused:
        params, sd = jax_fuse(params, state), fuse_conv_bn(sd)
    mod = make(fused)
    mod.load_state_dict(sd, strict=True)
    x = rng.randn(2, 12, 20, c_in).astype(np.float32)
    want = apply(Ctx(p=params, s=state, train=False, fused=fused), jnp.asarray(x))
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want)


# the seg heads: zoo entry, JAX apply (the row's args a), neck strides read
HEADS = {
    "yolov5s_city_seg_base": (lambda ctx, xs, a: JH.seg_base(
        ctx, "model.24", xs, n=a[1], c_hid=a[2], shortcut=a[3], ch=a[4]), (8,)),
    "yolov5s_city_seg_bise": (lambda ctx, xs, a: JH.seg_bise(ctx, "model.24", xs), (8, 16, 32)),
    "yolov5s_city_seg_lab": (lambda ctx, xs, a: JH.seg_lab(ctx, "model.24", xs, c_hid=a[2]),
                             (8, 16)),
}


def _head(name: str):
    cfg = jax_zoo.get(name)
    cfg["width_multiple"] = 0.25
    spec = jax_load_spec(cfg)
    params, state = to_jax_params(seeded_state_dict(load_spec(cfg), seed=0))
    fused = jax_fuse(params, state)
    row = load_spec(cfg).rows[24]
    sd = fuse_conv_bn(_sub(from_jax_params(params, state), "model.24"))
    return spec.rows[24].args, row, fused, state, sd


@pytest.mark.parametrize("name", list(HEADS))
def test_seg_head_matches_jax(name):
    apply, strides = HEADS[name]
    args, row, params, state, sd = _head(name)
    mod = {"SegMaskBase": lambda: heads.SegMaskBase(*row.args[:5], fused=True, kernel=True),
           "SegMaskBiSe": lambda: heads.SegMaskBiSe(row.args[0], row.args[4], fused=True,
                                                    kernel=True),
           "SegMaskLab": lambda: heads.SegMaskLab(row.args[0], row.args[1], row.args[2],
                                                  row.args[4], fused=True, kernel=True),
           }[row.module]()
    mod.load_state_dict(sd, strict=True)
    rng = np.random.RandomState(7)
    xs = [rng.randn(1, 128 // s, 256 // s, c).astype(np.float32)
          for s, c in zip(strides, row.args[4])]
    ctx = Ctx(p=params, s=state, train=False, fused=True, seg_up=False)
    want = apply(ctx, [jnp.asarray(x) for x in xs], args)
    with torch.no_grad():
        got = mod.eval()([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    assert got.shape == (1, 19, 16, 32)
    _close(got, want)


def test_bise_training_raises():
    """BiSe's training forward no longer raises: it returns [main, aux16,
    aux32] at 1/8, 1/8 and 1/16 resolution, which the JAX head's training
    outputs are, upsampled x8, x8 and x16 (bilinear, align_corners)."""
    from multiyolov5_tpu.ops.resize import resize_bilinear as jax_resize
    apply, strides = HEADS["yolov5s_city_seg_bise"]
    args, row, params, state, sd = _head("yolov5s_city_seg_bise")
    mod = heads.SegMaskBiSe(row.args[0], row.args[4], fused=True)
    mod.load_state_dict(sd, strict=True)
    rng = np.random.RandomState(8)
    xs = [rng.randn(2, 128 // s, 256 // s, c).astype(np.float32)
          for s, c in zip(strides, row.args[4])]
    ctx = Ctx(p=params, s=state, train=True, fused=True, seg_up=True)
    want = apply(ctx, [jnp.asarray(x) for x in xs], args)
    with torch.no_grad():
        got = mod.train()([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    assert [tuple(g.shape) for g in got] == [(2, 19, 16, 32), (2, 19, 16, 32), (2, 19, 8, 16)]
    for g, w in zip(got, want):
        up = jax_resize(jnp.asarray(g.permute(0, 2, 3, 1).numpy()), w.shape[1:3])
        np.testing.assert_allclose(np.asarray(up), np.asarray(w), rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())))