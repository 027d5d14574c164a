"""K7's plain version and its route in the port, against the JAX package's
fused C3 (``c3_packed_pallas`` and ``c3_packed_pallas_hwbc``, run in
interpret mode off the TPU as tests/test_c3_kernel.py runs them), on the CPU
in float32.

* ``c3_plain`` (and the ``c3`` wrapper, which runs it for a CPU tensor)
  against both Pallas kernels on the same seeded weights: rtol/atol 2e-5,
  the bound of tests/test_c3_kernel.py (float32 sums in another order).
* The route: a fused eval ``Model`` calls ``kernels.c3`` for pspv5s's row-2
  C3 (c_ 32) at batch 2, and not at batch 1, unfused, or in training.  The
  width gate of B3b (8 <= c_ <= 48): across the zoo only row 2 of the s and
  m models takes K7; the l (c_ 64) and x (c_ 80) models' row 2 does not, and
  at batch 2 never calls it.
* The whole fused forward at bs2 on pspv5s at 128x256 against the JAX
  ``forward(fused=True)`` with ``MULTIYOLOV5_FORCE_C3PACK=1``, so the JAX
  side really runs ``c3_packed_pallas`` at row 2 (at 64x64 its geometry
  check, multiyolov5_tpu/models/blocks.py:156, would refuse the C3).  The
  weights are tests/test_torch_engine.py's ``slice_pair`` weights, with BN
  folded for the JAX side, and its tolerances: 1e-4 absolute on pixel
  boxes and seg logits, 1e-5 on the obj/cls probabilities.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import forward as jax_forward
from multiyolov5_tpu.models.model import init_model
from multiyolov5_tpu.ops.nn import fuse_conv_bn
from multiyolov5_tpu.ops.pallas import c3_kernel as jax_c3
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models import blocks
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import Model
from multiyolov5_tpu_torch.ops.kernels import c3, c3_plain
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params


def _weights(seed, c1, c_, c2, n):
    """Seeded HWIO weights and biases in the JAX kernel's argument order."""
    rng = np.random.RandomState(seed)

    def w(*s):
        fan = int(np.prod(s[:-1])) if len(s) > 1 else 1
        return (rng.randn(*s) / np.sqrt(fan)).astype(np.float32)

    return (w(1, 1, c1, c_), w(c_), w(1, 1, c1, c_), w(c_), w(1, 1, 2 * c_, c2), w(c2),
            tuple((w(1, 1, c_, c_), w(c_), w(3, 3, c_, c_), w(c_)) for _ in range(n)))


def _ohwi(wts):
    """The same weights as the port's wrapper takes them: OHWI tensors."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a.transpose(3, 0, 1, 2) if a.ndim == 4 else a))
    *head, mws = wts
    return [t(a) for a in head], [tuple(t(a) for a in m) for m in mws]


@pytest.mark.parametrize("pallas", ["c3_packed_pallas", "c3_packed_pallas_hwbc"])
@pytest.mark.parametrize("b,h,w,c1,c_,n,q,shortcut", [
    (2, 32, 64, 64, 32, 1, 4, True),     # pspv5s row 2
    (2, 16, 32, 96, 48, 2, 2, True),     # pspv5m row 2 (two-pixel halo)
    (2, 16, 32, 64, 32, 1, 4, False),    # no shortcut
])
def test_c3_plain_matches_pallas(pallas, b, h, w, c1, c_, n, q, shortcut):
    rng = np.random.RandomState(h * w + c1 + int(shortcut))
    x = rng.rand(b, h, w, c1).astype(np.float32)
    wts = _weights(c1 + n, c1, c_, c1, n)
    want = np.asarray(getattr(jax_c3, pallas)(
        jnp.asarray(x), *[jnp.asarray(a) for a in wts[:6]],
        tuple(tuple(jnp.asarray(a) for a in m) for m in wts[6]), q=q, shortcut=shortcut))
    head, mws = _ohwi(wts)
    xt = torch.from_numpy(x)
    for fn in (c3_plain, c3):
        got = fn(xt, *head, mws, shortcut).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bsz,fused,training,calls", [
    (2, True, False, 1), (1, True, False, 0), (2, False, False, 0), (2, True, True, 0)])
def test_model_routes_row2_c3_to_kernel(monkeypatch, bsz, fused, training, calls):
    spec = load_spec("yolov5s_city_seg")
    torch.manual_seed(0)
    model = Model(spec, fused=fused).train(training)
    seen = []
    real = blocks.c3
    monkeypatch.setattr(blocks, "c3", lambda x, *a: seen.append(tuple(x.shape)) or real(x, *a))
    x = torch.from_numpy(np.random.RandomState(1).rand(bsz, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        model(x)
    assert seen == [(bsz, 16, 16, 64)] * calls
    assert [i for i, m in enumerate(model.model)
            if isinstance(m, blocks.C3) and m.c3_kernel] == ([2] if fused else [])


@pytest.mark.parametrize("cfg,rows", [
    ("yolov5s_city_seg", [2]), ("yolov5m_city_seg", [2]), ("yolov5l_city_seg", []),
    ("yolov5x_city_seg", []), ("yolov5s6", [2]), ("yolov5x6", []), ("yolov5l", [])])
def test_k7_width_gate(monkeypatch, cfg, rows):
    spec = load_spec(cfg)
    with torch.device("meta"):
        model = Model(spec, fused=True)
    assert [i for i, m in enumerate(model.model)
            if isinstance(m, blocks.C3) and m.c3_kernel] == rows
    a = spec.rows[2].args                  # row 2 alone, on the CPU, at batch 2
    row2 = blocks.C3(a[0], a[1], n=a[2], fused=True, c3_kernel=True).eval()
    seen = []
    real = blocks.c3
    monkeypatch.setattr(blocks, "c3", lambda x, *w: seen.append(x.shape) or real(x, *w))
    with torch.no_grad():
        row2(torch.zeros(2, a[0], 16, 16))
    assert len(seen) == len(rows)


def test_fused_bs2_forward_matches_jax_with_c3_kernel(monkeypatch):
    spec = jax_load_spec("yolov5s_city_seg")
    params, state = init_model(spec, seed=0)
    params = dict(params)
    params["model.24.out.3.weight"] = params["model.24.out.3.weight"] * 1e6
    params["model.24.out.3.bias"] = params["model.24.out.3.bias"] * 0.0
    peng = Engine(spec=load_spec("yolov5s_city_seg"),
                  state_dict=from_jax_params(params, state), device="cpu", half=False)
    img = (np.random.RandomState(7).rand(2, 128, 256, 3) * 255).astype(np.uint8)

    jax_calls, port_calls = [], []
    real_jax = jax_c3.c3_packed_pallas
    monkeypatch.setenv("MULTIYOLOV5_FORCE_C3PACK", "1")
    monkeypatch.setattr(jax_c3, "c3_packed_pallas",
                        lambda x, *a, **k: jax_calls.append(x.shape) or real_jax(x, *a, **k))
    real_port = blocks.c3
    monkeypatch.setattr(blocks, "c3",
                        lambda x, *a: port_calls.append(tuple(x.shape)) or real_port(x, *a))

    (zs, _), seg_j, _ = jax_forward(spec, fuse_conv_bn(params, state), state,
                                    jnp.asarray(img, jnp.float32) / 255.0, train=False,
                                    fused=True, decode="planar", seg_up=False)
    z_j = np.concatenate([np.asarray(z).transpose(2, 0, 1, 3).reshape(
        2, z.shape[0], -1) for z in zs], 2)
    z_p, seg_p = peng.forward(torch.from_numpy(img))
    assert [tuple(s) for s in jax_calls] == port_calls == [(2, 32, 64, 64)]
    assert z_p.shape == z_j.shape and seg_p.shape == seg_j.shape
    np.testing.assert_allclose(z_p[:, :4].numpy(), z_j[:, :4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(z_p[:, 4:].numpy(), z_j[:, 4:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(seg_p.numpy(), np.asarray(seg_j), rtol=0, atol=1e-4)
