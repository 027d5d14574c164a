"""Reference ``.pt`` checkpoints in the port (multiyolov5_tpu_torch/utils/checkpoint.py
``load_pt``, tools/convert_pt.py, and ``Engine``, hub and the two CLIs on
``.pt`` weights) against the JAX package's ``load_pt``, ``convert`` and
``Engine``, on the CPU in float32.

No reference checkout is mounted, so the test writes its own files, with
tests/test_torch_engine.py's weights on tests/test_torch_train_step.py's
TINY spec (JAX ``init_model`` seed 0, the seg head's last conv scaled by
1e6):
  * a bare float32 ``state_dict`` (with ``num_batches_tracked``);
  * reference train.py's dict, ``model`` and ``ema`` as float16
    ``state_dict``s (``ema`` the weights + 0.001);
  * the same dict of whole pickled modules: a stand-in for the reference's
    ``models/yolo.py`` ``Model`` (a module tree holding the tensors, its
    config in ``yaml``), written under a temporary reference checkout that
    both packages find through ``MULTIYOLOV5_REF``;
  * a bare ``state_dict`` whose Detect anchors are 1.5x the yaml's.
Both packages' ``load_pt`` give equal tensors and ``meta`` (EMA preferred,
``prefer_ema=False`` takes ``model``); ``weights_only=True`` is tried
first.  ``Engine``, ``hub.create`` and ``cli/detect.py`` on the module
``.pt`` agree with the JAX ones on the same file under
tests/test_torch_engine.py's serving bounds (equal counts, boxes 1e-3,
scores 1e-5, at most 1e-4 of the class-map pixels differing; the app's
txt lines at tests/test_torch_detect_app.py's 2e-3 px and 2e-5);
``cli/test.py`` on the ``.pt`` prints the metrics it prints on the
converted ``.npz``.  ``convert_pt`` works both ways: the port's ``.npz``
is read by the JAX ``load_npz`` and ``Engine``, the JAX one by the port's
``Engine``, with bitwise equal outputs.
"""

import contextlib
import io
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import multiyolov5_tpu.hub as jax_hub
from multiyolov5_tpu.cli.detect import main as jax_detect
from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.tools.convert_pt import convert as jax_convert
from multiyolov5_tpu.utils import checkpoint as jax_ckpt
from multiyolov5_tpu_torch import hub as port_hub
from multiyolov5_tpu_torch.cli.detect import main as port_detect
from multiyolov5_tpu_torch.cli.test import main as port_test
from multiyolov5_tpu_torch.data import png
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.tools.convert_pt import convert as port_convert
from multiyolov5_tpu_torch.utils import checkpoint as ckpt
from test_torch_engine_args import _weights
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_step import TINY

HW, ORIG_HW, CONF = 64, (64, 128), 0.001
ANCHOR_SCALE = 1.5
STUB = '''"""Stands in for the reference's models/yolo.py: a module tree holding a
state_dict, with its config in ``yaml``."""
import torch.nn as nn


class Model(nn.Module):
    def __init__(self, sd, yaml):
        super().__init__()
        self.yaml = yaml
        for key, value in sd.items():
            *path, leaf = key.split(".")
            mod = self
            for p in path:
                if p not in mod._modules:
                    mod.add_module(p, nn.Module())
                mod = mod._modules[p]
            mod.register_buffer(leaf, value.clone())
'''


# top-level names a load imports from the stand-in reference, or stubs
# (the JAX loader's stand-ins for the reference's heavy imports)
_REF_MODULES = ("models", "onnx", "torchvision", "seaborn", "wandb")


def _drop_ref_modules(keep=()):
    for name in list(sys.modules):
        if name.split(".")[0] in _REF_MODULES and name not in keep:
            del sys.modules[name]


@contextlib.contextmanager
def _clean_modules():
    """Each load inside finds the stand-in reference afresh, and what the
    loads import or stub from it is gone afterwards."""
    keep = {n for n in sys.modules if n.split(".")[0] in _REF_MODULES[1:]}
    _drop_ref_modules(keep)
    try:
        yield
    finally:
        _drop_ref_modules(keep)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("pt")
    params, state = _weights(jax_load_spec(TINY), 0)
    sd = ckpt.from_jax_params(params, state)
    ema = {k: v + 0.001 for k, v in sd.items()}
    half = lambda d: {k: v.half() for k, v in d.items()}  # noqa: E731
    nbt = {"model.1.bn.num_batches_tracked": torch.tensor(7)}
    out = {"root": root, "sd": sd, "ema": ema}
    out["bare"] = str(root / "bare.pt")
    torch.save({**sd, **nbt}, out["bare"])
    out["dict"] = str(root / "dict.pt")
    torch.save({"epoch": 42, "best_fitness": 0.5, "training_results": "x",
                "model": {**half(sd), **nbt}, "ema": half(ema), "optimizer": None}, out["dict"])
    anchors = dict(sd)
    for k in ("model.25.anchors", "model.25.anchor_grid"):
        anchors[k] = sd[k] * ANCHOR_SCALE
    out["anchors"] = str(root / "anchors.pt")
    torch.save(anchors, out["anchors"])
    ref = root / "reference"
    (ref / "models").mkdir(parents=True)
    (ref / "models" / "__init__.py").write_text("")
    (ref / "models" / "yolo.py").write_text(STUB)
    out["ref"] = str(ref)
    out["module"] = str(root / "module.pt")
    sys.path.insert(0, str(ref))
    try:
        with _clean_modules():
            from models.yolo import Model
            torch.save({"epoch": 7, "best_fitness": np.array([0.25]), "training_results": "r",
                        "model": Model(sd, TINY).half(), "ema": Model(ema, TINY).half(),
                        "updates": 100, "optimizer": None}, out["module"])
    finally:
        sys.path.remove(str(ref))
    return out


@pytest.fixture
def ref_env(files, monkeypatch):
    monkeypatch.setenv("MULTIYOLOV5_REF", files["ref"])
    with _clean_modules():
        yield files


CASES = {"bare": ("bare", True, "sd"), "dict": ("dict", True, "ema"),
         "dict_model": ("dict", False, "sd"), "module": ("module", True, "ema"),
         "module_model": ("module", False, "sd")}


@pytest.mark.parametrize("case", list(CASES))
def test_load_pt_matches_jax(ref_env, case):
    name, prefer_ema, which = CASES[case]
    path = ref_env[name]
    cfg, sd, meta = ckpt.load_pt(path, prefer_ema=prefer_ema)
    with _clean_modules():
        jparams, jstate, jmeta = jax_ckpt.load_pt(path, prefer_ema=prefer_ema)
    params, state = ckpt.to_jax_params(sd)
    assert params.keys() == jparams.keys() and state.keys() == jstate.keys()
    for k in params:
        np.testing.assert_array_equal(params[k], jparams[k])
    for k in state:
        np.testing.assert_array_equal(state[k], jstate[k])
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    want = ref_env[which]
    if name != "bare":                         # stored as float16
        want = {k: v.half().float() for k, v in want.items()}
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in sd)
    assert json.dumps(meta, default=str, sort_keys=True) == \
        json.dumps(jmeta, default=str, sort_keys=True)
    assert cfg == jmeta.get("yaml") == (TINY if name == "module" else None)
    if name != "bare":
        assert meta["epoch"] == (7 if name == "module" else 42)


@pytest.mark.parametrize("name", ["bare", "module"])
def test_weights_only_first(ref_env, monkeypatch, name):
    calls = []
    real = torch.load
    monkeypatch.setattr(torch, "load",
                        lambda *a, **kw: calls.append(kw.get("weights_only")) or real(*a, **kw))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ckpt.load_pt(ref_env[name])
    assert calls[0] is True
    assert calls == ([True] if name == "bare" else [True, False, False])
    # the weights_only=False fallback warns once, naming the file
    warned = [str(w.message) for w in caught if "weights_only=False" in str(w.message)]
    assert len(warned) == (0 if name == "bare" else 1)
    assert all(ref_env[name] in w for w in warned)


def test_module_pickle_needs_a_reference(files, monkeypatch, tmp_path):
    monkeypatch.delenv("MULTIYOLOV5_REF", raising=False)
    monkeypatch.chdir(tmp_path)
    with _clean_modules(), pytest.raises(ModuleNotFoundError, match="convert_pt"):
        ckpt.load_pt(files["module"])
    with _clean_modules():                   # given explicitly, as convert_pt's --ref
        assert ckpt.load_pt(files["module"], ref=files["ref"])[0] == TINY


def _frame(seed=5):
    return (np.random.RandomState(seed).rand(HW, 2 * HW, 3) * 255).astype(np.uint8)


def _assert_serving_equal(got, want):
    (dp, mp), (dj, mj) = got, want
    assert len(dp) == len(dj)
    for a, b in zip(dp, dj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=0, atol=1e-5)
    for a, b in zip(mp, mj):
        assert a.shape == b.shape and (a != b).mean() <= 1e-4


def test_engine_and_hub_on_pt_match_jax(ref_env):
    path, img = ref_env["module"], _frame()
    peng = Engine(path, cfg="yolov5s", device="cpu", half=False)
    with _clean_modules():
        jeng = JaxEngine(path, cfg="yolov5s", half=False)
    assert peng.spec.yaml == jeng.spec.yaml == TINY      # the checkpoint's config wins
    got, want = peng(img, ORIG_HW, conf=CONF), jeng(img, ORIG_HW, conf=CONF)
    assert len(got[0][0]) >= 5
    _assert_serving_equal(got, want)
    # hub: create by zoo name, on the .pt's own config and EMA weights
    inputs = [_frame(6), (np.random.RandomState(7).rand(3, 48, 80) * 255).astype(np.uint8)]
    pshape = port_hub.create("yolov5s_city_seg", pretrained=path, device="cpu", half=False)
    jshape = jax_hub.AutoShape(jeng)
    for s in (pshape, jshape):
        s.conf = CONF
    p, j = pshape(inputs, size=HW), jshape(inputs, size=HW)
    _assert_serving_equal((p.pred, p.masks), (j.pred, j.masks))


def test_detect_and_eval_cli_on_pt(ref_env, tmp_path):
    root, path = tmp_path, ref_env["module"]
    src = root / "src"
    src.mkdir()
    png.imwrite(str(src / "f0.png"), _frame(8))
    argv = ["--weights", path, "--source", str(src), "--img-size", str(HW), "--no-half",
            "--save-txt", "--save-conf", "--conf-thres", str(CONF), "--project", str(root)]
    with contextlib.redirect_stdout(io.StringIO()):
        pdir = port_detect(argv + ["--name", "port", "--device", "cpu"])
        with _clean_modules():
            jdir = jax_detect(argv + ["--name", "jax"])
    lines = [np.array([[float(v) for v in ln.split()] for ln in open(f"{d}/labels/f0.txt")])
             for d in (pdir, jdir)]
    assert len(lines[0]) == len(lines[1]) >= 3
    np.testing.assert_array_equal(lines[0][:, 0], lines[1][:, 0])
    gn = np.array([2 * HW, HW, 2 * HW, HW])
    np.testing.assert_allclose(lines[0][:, 1:5] * gn, lines[1][:, 1:5] * gn, rtol=0, atol=2e-3)
    np.testing.assert_allclose(lines[0][:, 5], lines[1][:, 5], rtol=0, atol=2e-5)
    # the eval CLI on the .pt and on its conversion: the same metrics
    for sub in ("images/val", "labels/val"):
        os.makedirs(root / "det" / sub)
    png.imwrite(str(root / "det/images/val/d0.png"), _frame(9))
    (root / "det/labels/val/d0.txt").write_text("1 0.5 0.5 0.3 0.4\n0 0.3 0.3 0.2 0.2\n")
    (root / "data.json").write_text(json.dumps({"val": str(root / "det/images/val")}))
    npz = port_convert(path, str(root / "conv.npz"))
    res = []
    for w in (path, npz):
        with contextlib.redirect_stdout(io.StringIO()):
            res.append(port_test(["--weights", w, "--data", str(root / "data.json"),
                                  "--img-size", str(HW), "--batch-size", "2",
                                  "--device", "cpu", "--workers", "1"]))
    assert res[0] == res[1] and sorted(res[0]) == ["P", "R", "mAP", "mAP50"]


def test_checkpoint_anchors_decode(files):
    """The .pt's anchors, not the yaml's: boxes' w and h scale with them."""
    path, img = files["anchors"], _frame()
    eng = Engine(path, cfg=TINY, device="cpu", half=False)
    base = Engine(files["bare"], cfg=TINY, device="cpu", half=False)
    x = torch.from_numpy(img[None])
    (z, _), (z0, _) = eng.forward(x), base.forward(x)
    np.testing.assert_allclose(z[:, 2:4].numpy(), z0[:, 2:4].numpy() * ANCHOR_SCALE,
                               rtol=1e-6, atol=0)
    assert torch.equal(z[:, [0, 1, 4, 5, 6, 7]], z0[:, [0, 1, 4, 5, 6, 7]])
    jeng = JaxEngine(path, cfg=TINY, half=False)
    for k in ("anchors", "anchor_grid"):
        np.testing.assert_array_equal(getattr(eng.model.model[25], k).numpy(),
                                      np.asarray(jeng.state[f"model.25.{k}"]))


def test_convert_pt_both_ways(ref_env, tmp_path):
    path, img = ref_env["module"], _frame()
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        port_convert(path, ours)
        with _clean_modules():
            jax_convert(path, theirs)
    a, b = jax_ckpt.load_npz(ours), jax_ckpt.load_npz(theirs)
    assert a.keys() == b.keys() and json.loads(a["spec_yaml"]) == json.loads(b["spec_yaml"])
    assert (a["epoch"], float(np.asarray(a["best_fitness"])[0])) == \
        (b["epoch"], float(np.asarray(b["best_fitness"])[0])) == (7, 0.25)
    for part in ("params", "state"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k])
    # the JAX engine reads the port's file as its own
    jp, jj = JaxEngine(ours, half=False), JaxEngine(theirs, half=False)
    for k in jj.params:
        np.testing.assert_array_equal(np.asarray(jp.params[k]), np.asarray(jj.params[k]))
    # the port's engine reads the JAX file, and both equal the .pt
    outs = [Engine(w, device="cpu", half=False)(img, ORIG_HW, conf=CONF)
            for w in (theirs, ours, path)]
    for o in outs[1:]:
        for d, d0 in zip(o[0], outs[0][0]):
            np.testing.assert_array_equal(d, d0)
        for m, m0 in zip(o[1], outs[0][1]):
            np.testing.assert_array_equal(m, m0)
