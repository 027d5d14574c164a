"""The port's export CLI (multiyolov5_tpu_torch/cli/export.py) against the JAX
export (multiyolov5_tpu/cli/export.py), on the CPU in float32.

tests/test_export.py's TINY spec at 64x64, with tests/test_torch_engine.py's
weights (JAX ``init_model`` seed 0, the seg head's last conv scaled by 1e6
and its bias zeroed, so the seg logits are O(1)) written as one ``.npz``
that both packages load.  Each format (``torchscript``,
``export``), with and without ``--raw``, is written, loaded back by
PyTorch alone and run on a seeded frame:
  * against the live plain build (``plain_model``) on the same input: to
    1e-6 of the output's scale (the same graph; read: equal);
  * against the JAX export's traced function (``forward(...,
    sever=False)``, run directly) on the same frame, under
    tests/test_torch_engine.py's float32 bounds: boxes 1e-4 absolute,
    obj/cls 1e-5, seg logits (NHWC there, NCHW here) and raw maps 1e-4;
  * the decoded output against the port's ``Engine.forward`` (the folded
    stem and the kernels' plain versions) on the same float frame, under
    the same bounds.
The JAX package's formats and ONNX raise ``NotImplementedError`` before
anything is written.  Narrowed yolov5s-transformer and yolov3-tiny
(tests/test_torch_hub_models.py's configs, seeded weights) export in
each format at 64x128 and equal the live plain build to 1e-6 of the
output's scale.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models.model import forward as jax_forward
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.utils.checkpoint import save_npz
from multiyolov5_tpu_torch.cli import export as port_export
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.ops.resize import resize_bilinear
from test_export import TINY
from test_torch_engine_args import _weights
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

HW = 64
BOX_ABS, OBJCLS_ABS, LOGIT_ABS = 1e-4, 1e-5, 1e-4


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    params, state = _weights(jax_load_spec(TINY), 0)
    w = str(root / "tiny.npz")
    save_npz(w, {"params": {k: np.asarray(v) for k, v in params.items()},
                 "state": {k: np.asarray(v) for k, v in state.items()},
                 "spec_yaml": json.dumps(TINY)})
    x = np.random.RandomState(3).rand(1, HW, HW, 3).astype(np.float32)
    return root, w, x, JaxEngine(w, half=False), Engine(w, device="cpu", half=False)


def _jax_outputs(eng, x, raw):
    """The JAX export's ``fn`` (multiyolov5_tpu/cli/export.py:35-48), run
    directly under ``jax.jit`` as the export traces it."""
    fn = jax.jit(lambda p, s, xx: jax_forward(eng.spec, p, s, xx, train=False, fused=eng.fused,
                                              decode=not raw, sever=False)[:2])
    det, seg = fn(eng.params, eng.state, jnp.asarray(x))
    out = tuple(det) if raw else (det[0],)
    return [np.asarray(t) for t in out + (seg,)]


def _load(path):
    if path.endswith(".torchscript.pt"):
        return torch.jit.load(path)
    return torch.export.load(path).module()


def _close(got, want, bound):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound


def _close_decoded(got, want):
    """(B, N, no) candidates: boxes and obj/cls each under its bound."""
    _close(got[..., :4], want[..., :4], BOX_ABS)
    _close(got[..., 4:], want[..., 4:], OBJCLS_ABS)


@pytest.mark.parametrize("raw", [False, True], ids=["decoded", "raw"])
def test_export_roundtrip(staged, raw):
    root, w, x, jeng, eng = staged
    out_dir = root / ("raw" if raw else "decoded")
    made = port_export.main(["--weights", w, "--img-size", str(HW), "--include", "torchscript",
                             "export", "--output", str(out_dir), "--device", "cpu"]
                            + (["--raw"] if raw else []))
    assert made == [str(out_dir / "tiny.torchscript.pt"), str(out_dir / "tiny.pt2")]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        live = port_export.ExportModel(port_export.plain_model(eng), raw=raw)(xt)
        outs = [_load(p)(xt) for p in made]
    jax_out = _jax_outputs(jeng, x, raw)
    assert len(live) == len(jax_out) == (4 if raw else 2)
    for got in outs:
        assert len(got) == len(live)
        for g, l in zip(got, live):
            assert g.shape == l.shape
            assert (g - l).abs().max().item() <= 1e-6 * max(l.abs().max().item(), 1.0)
    got = [t.numpy() for t in live]
    got[-1] = got[-1].transpose(0, 2, 3, 1)          # seg logits NCHW -> NHWC
    if raw:
        for g, j in zip(got[:3], jax_out[:3]):
            _close(g, j, LOGIT_ABS)
    else:
        _close_decoded(got[0], jax_out[0])
        # the engine's kernel path (here the kernels' plain versions)
        z, seg = eng.forward(torch.from_numpy(x))
        _close_decoded(got[0], z.transpose(1, 2).numpy())
        seg = resize_bilinear(seg, (HW, HW)).permute(0, 2, 3, 1).numpy()
        _close(got[-1], seg, LOGIT_ABS)
    _close(got[-1], jax_out[-1], LOGIT_ABS)
    assert np.ptp(got[-1]) > 0.05 and np.ptp(got[0][..., 4]) > 0.01   # outputs that vary


@pytest.mark.parametrize("fmt", ["stablehlo", "saved_model", "tflite", "onnx"])
def test_other_formats_raise(tmp_path, fmt):
    with pytest.raises(NotImplementedError, match="torchscript and export"):
        port_export.main(["--include", "torchscript", fmt, "--output", str(tmp_path),
                          "--device", "cpu"])
    assert not any(tmp_path.iterdir())


# The hub's models: the narrowed configs of tests/test_torch_hub_models.py
# on seeded weights, exported at 64x128 (the transformer's 2x4 tokens; the
# yolov3-tiny stem runs from row 0) and held against the live plain build.
HUB_EXPORTS = ["yolov5s-transformer", "yolov3-tiny"]


@pytest.mark.parametrize("fmt", list(port_export.FORMATS))
@pytest.mark.parametrize("name", HUB_EXPORTS)
def test_hub_model_export_equals_live_build(tmp_path, name, fmt):
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.utils.checkpoint import save_npz as port_save_npz
    from multiyolov5_tpu_torch.utils.checkpoint import to_jax_params
    from test_torch_hub_models import hub_cfg

    cfg = hub_cfg(name)
    params, state = to_jax_params(seeded_state_dict(load_spec(cfg), 0))
    w = str(tmp_path / f"{name}.npz")
    port_save_npz(w, {"params": params, "state": state, "spec_yaml": json.dumps(cfg)})
    made = port_export.main(["--weights", w, "--img-size", "64", "128", "--include", fmt,
                             "--output", str(tmp_path / "out"), "--device", "cpu"])
    assert len(made) == 1
    eng = Engine(w, device="cpu", half=False)
    x = torch.from_numpy(np.random.RandomState(3).rand(1, 3, 64, 128).astype(np.float32))
    with torch.no_grad():
        live = port_export.ExportModel(port_export.plain_model(eng))(x)
        got = _load(made[0])(x)
    assert len(got) == len(live) == 1                   # detection only
    n = 3 * sum((64 // s) * (128 // s) for s in eng.spec.strides)
    assert got[0].shape == live[0].shape == (1, n, 8)
    scale = max(live[0].abs().max().item(), 1.0)
    assert (got[0] - live[0]).abs().max().item() <= 1e-6 * scale
    assert np.ptp(live[0][..., 4].numpy()) > 1e-3        # scores that vary
