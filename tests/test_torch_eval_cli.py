"""The port's eval CLI (multiyolov5_tpu_torch/cli/test.py) against the JAX
CLI (multiyolov5_tpu/cli/test.py), on the CPU in float32.

Both read the same ``.npz`` (tests/test_torch_engine_args.py's weights:
JAX ``init_model`` seed 0, the seg head's last conv scaled by 1e6; written
by the JAX ``save_npz``) and the same seeded PNG trees, at ``--img-size
128 --base-size 128 --batch-size 8`` (detection batches of 8 and 2, seg
batches of 1):

* detection: ``images/val`` + ``labels/val`` of 6 frames at 256x128 (a
  shrink by 2), 2 at 300x150 (a fractional shrink) and 2 portrait ones at
  128x192 (a second rect bin: 96x160 and 160x128 letterboxes).  The labels
  are a jittered subset of the model's own detections on each frame plus
  boxes no detection covers, so mAP is neither 0 nor 1.
* segmentation: the ``citys`` layout, 4 frames at 256x128 with labelId
  masks made from the model's own class map, 30% random classes and 10%
  255.

P, R, mAP@.5, mAP@.5:.95, pixAcc and mIoU agree within
tests/test_torch_eval.py's 1e-4; the ``--save-txt --save-conf``
files hold equal classes, boxes within 1e-3 px of the frame and scores
within 1e-5 (plus ``%g``'s six digits).  The parsers have the same flags
and defaults, ``--det-only`` runs no seg loader, and ``--plots`` writes
the JAX CLI's five plots (PR, F1, P and R curves, the confusion matrix) at
matplotlib's pixel sizes, with the same metrics.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import yaml

from multiyolov5_tpu.cli import test as jax_cli
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.utils.checkpoint import save_npz
from multiyolov5_tpu_torch.cli import test as port_cli
from multiyolov5_tpu_torch.data import png
from multiyolov5_tpu_torch.data.cityscapes import CITYSCAPES_IDMAP
from multiyolov5_tpu_torch.data.letterbox import letterbox
from multiyolov5_tpu_torch.engine import Engine
from test_torch_engine_args import _weights
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

DET_HW = [(128, 256)] * 6 + [(150, 300)] * 2 + [(192, 128)] * 2
SEG_HW = (128, 256)
METRICS = ("P", "R", "mAP50", "mAP", "pixAcc", "mIoU")


def _frame(rng, h, w):
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalcli")
    spec = jax_load_spec("yolov5s_city_seg")
    params, state = _weights(spec, 0)
    ckpt = str(root / "w.npz")
    save_npz(ckpt, {"params": {k: np.asarray(v) for k, v in params.items()},
                    "state": {k: np.asarray(v) for k, v in state.items()},
                    "spec_yaml": json.dumps(spec.yaml)})
    eng = Engine(ckpt, device="cpu", half=False)
    rng = np.random.RandomState(21)
    img_dir, lbl_dir = root / "det" / "images" / "val", root / "det" / "labels" / "val"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(DET_HW):
        bgr = _frame(rng, h, w)
        png.imwrite(str(img_dir / f"d{i:02d}.png"), bgr)
        lb = letterbox(bgr[..., ::-1].copy(), 128, auto=False)[0].numpy()
        det = eng(lb, (h, w), conf=0.001)[0][0]
        pick = det[rng.choice(len(det), min(12, len(det)), replace=False)]
        xyxy = pick[:, :4] + rng.randn(len(pick), 4) * 2
        extra = rng.rand(3, 2) * [w - 40, h - 40]
        xyxy = np.clip(np.concatenate([xyxy, np.concatenate([extra, extra + 30], 1)]),
                       0, [w, h, w, h])
        cls = np.concatenate([pick[:, 5], rng.randint(0, spec.nc, 3)])
        with open(lbl_dir / f"d{i:02d}.txt", "w") as fh:
            for c, (x0, y0, x1, y1) in zip(cls, xyxy):
                fh.write("%d %.6f %.6f %.6f %.6f\n" % (c, (x0 + x1) / 2 / w, (y0 + y1) / 2 / h,
                                                       (x1 - x0) / w, (y1 - y0) / h))
    for i in range(4):
        city = ("aachen", "bonn")[i % 2]
        idir = root / "citys" / "leftImg8bit" / "val" / city
        mdir = root / "citys" / "gtFine" / "val" / city
        idir.mkdir(parents=True, exist_ok=True)
        mdir.mkdir(parents=True, exist_ok=True)
        bgr = _frame(rng, *SEG_HW)
        stem = f"{city}_{i:06d}_000019"
        png.imwrite(str(idir / f"{stem}_leftImg8bit.png"), bgr)
        cmap = eng(letterbox(bgr[..., ::-1].copy(), 128, auto=False)[0].numpy(), SEG_HW)[1][0]
        ids = CITYSCAPES_IDMAP[np.where(rng.rand(*SEG_HW) < 0.3,
                                        rng.randint(0, spec.n_segcls, SEG_HW), cmap)]
        ids[rng.rand(*SEG_HW) < 0.1] = 255
        png.imwrite(str(mdir / f"{stem}_gtFine_labelIds.png"), ids)
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"val": str(img_dir), "segval": str(root / "citys"),
                                    "nc": spec.nc, "names": [str(i) for i in range(spec.nc)]}))
    return root, ckpt, str(data)


def _argv(staged, out, *extra):
    _, ckpt, data = staged
    return ["--weights", ckpt, "--data", data, "--img-size", "128", "--base-size", "128",
            "--batch-size", "8", "--workers", "2", "--save-dir", str(out), *extra]


@pytest.fixture(scope="module")
def runs(staged, tmp_path_factory):
    """Each CLI once over both splits, with ``--save-txt --save-conf``:
    (the JAX run's metrics, the port's, the port's printed JSON line, the
    JAX and the port's save dirs)."""
    out = tmp_path_factory.mktemp("runs")
    extra = ["--save-txt", "--save-conf"]
    want = jax_cli.main(_argv(staged, out / "jax", *extra))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = port_cli.main(_argv(staged, out / "port", *extra, "--device", "cpu"))
    line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")][-1]
    return want, got, line, out / "jax", out / "port"


def test_eval_cli_matches_jax(runs):
    want, got, line, _, _ = runs
    assert json.loads(line) == {k: round(float(got[k]), 5) for k in METRICS}
    assert sorted(got) == sorted(want) == sorted(METRICS)
    assert 0.05 < got["mAP50"] < 0.95 and 0.05 < got["mIoU"] < 0.95
    for k in METRICS:
        assert abs(float(got[k]) - float(want[k])) <= 1e-4, (k, got[k], want[k])


def _txt(path):
    return np.array([[float(v) for v in ln.split()] for ln in open(path)]).reshape(-1, 6)


def test_eval_cli_save_txt_matches_jax(runs):
    _, _, _, jax_dir, port_dir = runs
    jdir, pdir = jax_dir / "labels", port_dir / "labels"
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir)) and len(names) == len(DET_HW)
    for name, (h, w) in zip(names, DET_HW):
        a, b = _txt(pdir / name), _txt(jdir / name)
        assert len(a) == len(b) > 0
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        gn = np.array([w, h, w, h])
        np.testing.assert_allclose(a[:, 1:5] * gn, b[:, 1:5] * gn, rtol=0, atol=2e-3)
        np.testing.assert_allclose(a[:, 5], b[:, 5], rtol=0, atol=2e-5)


def test_eval_cli_det_only(staged, tmp_path, monkeypatch):
    """``--det-only`` runs no seg loader and returns the detection metrics."""
    monkeypatch.setattr(port_cli, "seg_validation",
                        lambda *a, **k: pytest.fail("--det-only ran seg_validation"))
    got = port_cli.main(_argv(staged, tmp_path, "--det-only", "--device", "cpu"))
    assert sorted(got) == ["P", "R", "mAP", "mAP50"]


PLOTS = ("F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png", "confusion_matrix.png")


def test_parsers_match_and_plots_raises(staged, tmp_path):
    """The parsers match; ``--plots`` (once raising, now drawn without
    matplotlib) writes the JAX CLI's files at its pixel sizes and leaves
    the metrics as they are."""
    import cv2

    jp, pp = jax_cli.build_parser(), port_cli.build_parser()
    flags = lambda p: sorted(o for a in p._actions for o in a.option_strings)  # noqa: E731
    assert flags(pp) == flags(jp)
    assert vars(pp.parse_args([])) == vars(jp.parse_args([]))
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    got = port_cli.main(_argv(staged, tmp_path / "port", "--plots", "--det-only",
                              "--device", "cpu"))
    want = jax_cli.main(_argv(staged, tmp_path / "jax", "--plots", "--det-only"))
    for k in ("P", "R", "mAP50", "mAP"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-4, (k, got[k], want[k])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == sorted(PLOTS)
    for f in PLOTS:
        assert png.imread(str(tmp_path / "port" / f)).shape == \
            cv2.imread(str(tmp_path / "jax" / f)).shape, f
    assert not (tmp_path / "port" / "labels").exists()
