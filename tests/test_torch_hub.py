"""The port's hub (multiyolov5_tpu_torch/hub.py) against the JAX hub, on the
CPU in float32.

Both ``AutoShape`` wrappers get an ``Engine`` on the same ``.npz`` (the
weights of tests/test_torch_engine_args.py: JAX ``init_model`` seed 0, the
seg head's last conv scaled by 1e6; written by the JAX ``save_npz``) and
the same mixed list at ``size`` 256: a PNG path (150x200), an HWC frame and
another of its size (128x256, one batched call of two), a CHW frame
(96x160) and a 2-D gray one (80x120).  Boxes and class maps are held to
tests/test_torch_serving.py's bounds: equal counts, boxes within 1e-3
(whole pixels on both sides), scores within 1e-5, at most 1e-4 of the
class-map pixels differing.  ``Detections``' views, ``print``,
``tolist``, ``pandas``, ``render`` and ``save`` (``.jpg`` files, byte
for byte PIL's ``save``) are checked too; a ``.jpg`` path serves as in
the JAX hub, its saved file's name and bytes included; a ``.dng`` path
raises; ``create(classes=N, pretrained=npz)`` must copy exactly the
tensors whose names and shapes match, as the JAX ``intersect_load`` does.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import multiyolov5_tpu.hub as jax_hub
import multiyolov5_tpu_torch.hub as port_hub
from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import init_model
from multiyolov5_tpu.utils import checkpoint as jax_ckpt
from multiyolov5_tpu_torch.data import images, png
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_engine_args import _weights
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

SIZE = 256
FILES = ["frame.jpg", "image1.jpg", "image2.jpg", "image3.jpg", "image4.jpg"]


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = tmp_path_factory.mktemp("hub")
    spec = jax_load_spec("yolov5s_city_seg")
    params, state = _weights(spec, 0)
    ckpt = str(root / "w.npz")
    jax_ckpt.save_npz(ckpt, {"params": {k: np.asarray(v) for k, v in params.items()},
                             "state": {k: np.asarray(v) for k, v in state.items()},
                             "spec_yaml": json.dumps(spec.yaml)})
    rng = np.random.RandomState(9)
    path = str(root / "frame.png")
    png.imwrite(path, (rng.rand(150, 200, 3) * 255).astype(np.uint8))
    hwc = (rng.rand(128, 256, 3) * 255).astype(np.uint8)
    chw = (rng.rand(3, 96, 160) * 255).astype(np.uint8)
    gray = (rng.rand(80, 120) * 255).astype(np.uint8)
    twin = (rng.rand(128, 256, 3) * 255).astype(np.uint8)
    return root, ckpt, spec, [path, hwc, chw, gray, twin]


@pytest.fixture(scope="module")
def results(staged):
    _, ckpt, _, inputs = staged
    jshape = jax_hub.AutoShape(JaxEngine(ckpt, half=False))
    pshape = port_hub.AutoShape(Engine(ckpt, device="cpu", half=False))
    for s in (jshape, pshape):
        s.conf = 0.001
    calls = []
    real = Engine.__call__

    def spy(self, img, orig_hw, **kw):
        calls.append((tuple(img.shape), tuple(orig_hw)))
        return real(self, img, orig_hw, **kw)

    Engine.__call__ = spy
    try:
        got = pshape([x.copy() if isinstance(x, np.ndarray) else x for x in inputs], size=SIZE)
    finally:
        Engine.__call__ = real
    want = jshape([x.copy() if isinstance(x, np.ndarray) else x for x in inputs], size=SIZE)
    return got, want, calls


def test_autoshape_matches_jax(results):
    got, want, calls = results
    # the letterbox is one shape for the list; same-size frames batch
    assert sorted(calls) == sorted([((1, 192, 256, 3), (150, 200)), ((2, 192, 256, 3), (128, 256)),
                                    ((1, 192, 256, 3), (96, 160)), ((1, 192, 256, 3), (80, 120))])
    assert len(got) == len(want) == 5
    assert [im.shape for im in got.imgs] == [im.shape for im in want.imgs]
    for a, b in zip(got.imgs, want.imgs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.pred, want.pred):
        assert a.shape == b.shape and len(a) >= 10
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=0, atol=1e-5)
    for a, b, im in zip(got.masks, want.masks, got.imgs):
        assert a.shape == b.shape == im.shape[:2] and a.dtype == np.uint8
        assert (a != b).mean() <= 1e-4
        assert len(np.unique(a)) >= 2
    assert got.files == want.files == FILES


def test_detections_views_match_jax(results):
    got, want, _ = results
    for name in ("xyxy", "xywh", "xyxyn", "xywhn"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            scale = 1e-3 if name in ("xyxy", "xywh") else 1e-3 / 80
            np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=scale)
            np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=0, atol=1e-5)
    parts = got.tolist()
    assert len(parts) == 5 and all(len(p) == 1 for p in parts)
    np.testing.assert_array_equal(parts[2].pred[0], got.pred[2])
    np.testing.assert_array_equal(parts[3].masks[0], got.masks[3])
    frames = got.pandas().xyxy
    assert list(frames[0].columns) == ["xmin", "ymin", "xmax", "ymax", "confidence", "class",
                                       "name"]
    assert len(frames[1]) == len(got.pred[1])


def test_print_render_and_save(results, tmp_path, capsys):
    got, want, _ = results
    got.print()
    want.print()
    out = capsys.readouterr().out.splitlines()
    assert out[:5] == out[5:] and out[0].startswith("image 1/5: 150x200 ")
    parts = got.tolist()
    before = [im.copy() for im in got.imgs]
    rendered = parts[1].render()
    assert (rendered[0] != before[1]).any()
    save_dir = tmp_path / "exp"
    parts[4].save(str(save_dir))
    Image.fromarray(parts[4].imgs[0]).save(tmp_path / "pil.jpg")
    assert (save_dir / "image4.jpg").read_bytes() == (tmp_path / "pil.jpg").read_bytes()
    saved = images.read_rgb(str(save_dir / "image4.jpg"))
    np.testing.assert_array_equal(saved, np.asarray(Image.open(save_dir / "image4.jpg")))
    assert (saved != before[4]).any()
    with pytest.raises(NotImplementedError, match="display"):
        got.show()


def test_factories_and_create(staged):
    assert [n for n in dir(port_hub) if n.startswith("yolov5")] == \
        [n for n in dir(jax_hub) if n.startswith("yolov5")]
    for name in ("yolov5s", "yolov5s_city_seg", "yolov5m6"):
        assert getattr(port_hub, name).__name__ == name
    _, ckpt, spec, inputs = staged
    shape = port_hub.yolov5s_city_seg(pretrained=ckpt, device="cpu", half=False)
    assert isinstance(shape, port_hub.AutoShape) and shape.names == [str(i) for i in range(10)]
    eng = port_hub.custom(ckpt, autoshape=False, device="cpu", half=False)
    assert isinstance(eng, Engine)
    # a reference-style .pt of the same weights serves the same network
    pt = staged[0] / "w.pt"
    torch.save({"model": load_checkpoint(ckpt)[1], "epoch": 3}, pt)
    eng_pt = port_hub.create("yolov5s_city_seg", pretrained=str(pt), autoshape=False,
                             device="cpu", half=False)
    for k, v in eng.model.state_dict().items():
        assert torch.equal(eng_pt.model.state_dict()[k], v), k
    with pytest.raises(NotImplementedError, match="frame.dng"):
        shape([inputs[1], str(staged[0] / "frame.dng")])


def test_create_with_classes_copies_matching_tensors(staged, monkeypatch):
    _, ckpt, _, _ = staged
    seen = []
    real = port_hub.intersect_load
    monkeypatch.setattr(port_hub, "intersect_load",
                        lambda sd, new: seen.append((sd, new, real(sd, new))) or seen[-1][2])
    eng = port_hub.create("yolov5s_city_seg", pretrained=ckpt, classes=3, autoshape=False,
                          device="cpu", half=False)
    assert eng.spec.nc == 3 and eng.names == ["0", "1", "2"]
    sd, new, (merged, n) = seen[0]
    # the JAX count on the same checkpoint, params and state
    tree = jax_ckpt.load_npz(ckpt)
    jspec = jax_load_spec("yolov5s_city_seg", nc=3)
    jp, js = init_model(jspec)
    n_jax = jax_ckpt.intersect_load(jp, tree["params"])[1] + \
        jax_ckpt.intersect_load(js, tree["state"])[1]
    assert n == n_jax and 0 < n < len(new)
    copied = [k for k in sd if k in new and tuple(sd[k].shape) == tuple(new[k].shape)]
    assert len(copied) == n
    for k in sd:
        src = new if k in copied else sd
        assert torch.equal(merged[k], src[k]), k
    assert any(k.startswith("model.25.m.") for k in sd if k not in copied)
    # the detections have 3 classes and the class map still comes out
    out = port_hub.AutoShape(eng)(staged[3][1], size=128)
    assert out.masks[0].shape == (128, 256)
    assert all((p[:, 5] < 3).all() for p in out.pred)



def test_autoshape_jpeg_path_matches_jax(staged, tmp_path):
    """A ``.jpg`` path is read as PIL reads it (EXIF orientation 6 not
    applied): its boxes, class map and file name are the JAX hub's, and
    ``save`` writes it under that name as PIL's ``save`` would."""
    _, ckpt, _, _ = staged
    path = tmp_path / "photo.jpg"
    exif = Image.Exif()
    exif[274] = 6
    Image.fromarray((np.random.RandomState(4).rand(72, 120, 3) * 255).astype(np.uint8)).save(
        path, quality=90, exif=exif.tobytes())
    runs = []
    want_px = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(images.read_rgb(str(path)), want_px)
    for shape in (jax_hub.AutoShape(JaxEngine(ckpt, half=False)),
                  port_hub.AutoShape(Engine(ckpt, device="cpu", half=False))):
        shape.conf = 0.001
        runs.append(shape(str(path), size=128))
    got, want = runs[1], runs[0]
    assert got.imgs[0].shape == want.imgs[0].shape == (72, 120, 3)
    assert got.files == want.files == ["photo.jpg"]
    a, b = got.pred[0], want.pred[0]
    assert a.shape == b.shape and len(a)
    np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=0, atol=1e-5)
    assert (got.masks[0] != want.masks[0]).mean() <= 1e-4
    # saved under the JAX name, its bytes PIL's save of the drawn image (the
    # JAX hub cannot draw on the read-only array it reads a path into)
    got.save(str(tmp_path / "port"))
    Image.fromarray(got.imgs[0]).save(tmp_path / "pil.jpg")
    assert (tmp_path / "port" / "photo.jpg").read_bytes() == (tmp_path / "pil.jpg").read_bytes()
