"""The port's detect app (multiyolov5_tpu_torch/cli/detect.py) against the JAX
app (multiyolov5_tpu/cli/detect.py), on the CPU in float32.

Both apps read the same two seeded 256x512 PNG frames and the same ``.npz``
checkpoint (the port's seeded weights, seed 0, whose BN statistics are
measured and so give spread scores, written by the JAX ``save_npz``), with
``--img-size 256 --no-half --save-txt --save-conf --conf-thres 0.8
--classes 3 6 8`` (13-15 boxes a frame),
once as it is (a 128x256 letterbox, ``auto``) and once with ``--submit``
(256x256).  They must write the same files.  The txt lines parse to equal
classes and numbers within tests/test_torch_engine.py's detection bounds
(boxes 1e-3 px, scores 1e-5, plus ``%g``'s six digits).  ``_pred.png`` and
``_mask`` decode to equal maps within its class-map share (1e-4).

The annotated image and ``_dst`` are equal outside each box's stroke band
(the box outline grown and shrunk by tl + 1 = 4 px) and its label
rectangle grown by 2 px, where ``_dst`` may differ only where the class
maps do.  Inside those bands the port blends cv2's coverage once where cv2
blends each stroke (and each overlapping box) in turn with its own
rounding: read here, 6.5-10.1% of the bands' pixels differ, by at most 4
levels; held at 15% and 8 levels.

The overlay and the drawing are also held alone against cv2: the overlay
byte-equal on random images and on every pair of levels, and
``plot_one_box`` of single labelled boxes on random images under the same
band rule.  There cv2 also clips a shape at the image's edge otherwise
than the port clips its stamp: read 4.8% of the band pixels differing on
average, 11.6% at most, by at most 26 levels (at an edge); held at 8%,
20% and 40 levels.
"""

import json

import cv2
import numpy as np
import pytest

from multiyolov5_tpu.cli.detect import main as jax_main
from multiyolov5_tpu.utils.checkpoint import save_npz
from multiyolov5_tpu_torch.cli.detect import main as port_main
from multiyolov5_tpu_torch.data import png
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import seeded_state_dict
from multiyolov5_tpu_torch.utils.checkpoint import to_jax_params
from multiyolov5_tpu_torch.utils import plots
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

TL = 3
# inside the bands (read: the app 6.5-10.1% of band pixels, by at most 4
# levels; single boxes on random images 4.8% on average, 11.6% at most, by
# at most 26 levels where a shape is clipped at the image's edge)
APP_BAND_SHARE, APP_BAND_MAX = 0.15, 8
BOX_BAND_MEAN, BOX_BAND_SHARE, BOX_BAND_MAX = 0.08, 0.2, 40
MASK_SHARE = 1e-4


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = tmp_path_factory.mktemp("app")
    spec = load_spec("yolov5s_city_seg")
    params, state = to_jax_params(seeded_state_dict(spec, 0))
    ckpt = str(root / "w.npz")
    save_npz(ckpt, {"params": params, "state": state, "spec_yaml": json.dumps(spec.yaml)})
    src = root / "src"
    src.mkdir()
    rng = np.random.RandomState(7)
    for i in range(2):
        cv2.imwrite(str(src / f"frame{i}.png"), (rng.rand(256, 512, 3) * 255).astype(np.uint8))
    return root, ckpt, str(src)


def _run(main, staged, name, extra):
    root, ckpt, src = staged
    return main(["--weights", ckpt, "--source", src, "--img-size", "256", "--no-half",
                 "--save-txt", "--save-conf", "--conf-thres", "0.8", "--classes", "3", "6", "8",
                 "--project", str(root),
                 "--name", name, "--exist-ok"] + extra)


def _files(d):
    import os
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _lines(path):
    return np.array([[float(v) for v in ln.split()] for ln in open(path)]).reshape(-1, 6)


def _bands(shape, lines):
    """Each txt line's box stroke band and label rectangle (grown), as a mask."""
    h, w = shape[:2]
    band = np.zeros((h, w), bool)
    g = TL + 1
    for cls, xc, yc, bw, bh, conf in lines:
        x0, y0 = int((xc - bw / 2) * w + 1e-3), int((yc - bh / 2) * h + 1e-3)
        x1, y1 = int((xc + bw / 2) * w + 1e-3), int((yc + bh / 2) * h + 1e-3)
        outer = np.zeros_like(band)
        outer[max(0, y0 - g):max(0, y1 + g + 1), max(0, x0 - g):max(0, x1 + g + 1)] = True
        inner = np.zeros_like(band)
        inner[max(0, y0 + g + 1):max(0, y1 - g), max(0, x0 + g + 1):max(0, x1 - g)] = True
        band |= outer & ~inner
        tw, th = plots.text_size(f"{int(cls)} {conf:.2f}")
        band[max(0, y0 - th - 3 - 2):max(0, y0 + 3), max(0, x0 - 2):max(0, x0 + tw + 3)] = True
    return band


def _hold_drawing(got, want, band, allowed=None):
    """Equal outside ``band`` (and ``allowed``); inside it, the differing
    share and the largest difference.  Returns (share, max)."""
    diff = np.abs(got.astype(int) - want.astype(int)).max(2)
    outside = ~band if allowed is None else ~band & ~allowed
    assert not diff[outside].any(), np.argwhere(diff * outside)[:5]
    share = (diff[band] > 0).mean() if band.any() else 0.0
    return share, int(diff[band].max()) if band.any() else 0


@pytest.mark.parametrize("submit", [False, True])
def test_app_matches_jax_app(staged, submit):
    extra = ["--submit"] if submit else []
    jdir = _run(jax_main, staged, f"jax{int(submit)}", extra)
    pdir = _run(port_main, staged, f"port{int(submit)}", extra + ["--device", "cpu"])
    assert _files(pdir) == _files(jdir)
    names = _files(pdir)
    assert sum(n.startswith("labels/") for n in names) == 2
    assert sum(n.startswith("results/") for n in names) == (2 if submit else 0)
    shares, maxes = [], []
    for i in range(2):
        stem = f"frame{i}"
        lp, lj = _lines(f"{pdir}/labels/{stem}.txt"), _lines(f"{jdir}/labels/{stem}.txt")
        assert len(lp) == len(lj) >= 3
        np.testing.assert_array_equal(lp[:, 0], lj[:, 0])
        gn = np.array([512, 256, 512, 256])
        np.testing.assert_allclose(lp[:, 1:5] * gn, lj[:, 1:5] * gn, rtol=0, atol=2e-3)
        np.testing.assert_allclose(lp[:, 5], lj[:, 5], rtol=0, atol=2e-5)
        if submit:
            pp, pj = png.imread(f"{pdir}/results/{stem}_pred.png"), cv2.imread(
                f"{jdir}/results/{stem}_pred.png")
            assert pp.shape == pj.shape == (256, 512, 3)
            assert (pp != pj).any(2).mean() <= MASK_SHARE
            assert len(np.unique(pp)) >= 2
        mp, mj = png.imread(f"{pdir}/{stem}_mask.png"), cv2.imread(f"{jdir}/{stem}_mask.png")
        mask_diff = (mp != mj).any(2)
        assert mask_diff.mean() <= MASK_SHARE
        band = _bands(mp.shape, lp)
        assert 0 < band.mean() < 0.9
        ip, ij = png.imread(f"{pdir}/{stem}.png"), cv2.imread(f"{jdir}/{stem}.png")
        dp, dj = png.imread(f"{pdir}/{stem}_dst.png"), cv2.imread(f"{jdir}/{stem}_dst.png")
        for got, want, allowed in ((ip, ij, None), (dp, dj, mask_diff)):
            share, mx = _hold_drawing(got, want, band, allowed)
            shares.append(share)
            maxes.append(mx)
    assert max(shares) <= APP_BAND_SHARE and max(maxes) <= APP_BAND_MAX, (shares, maxes)


def test_overlay_is_cv2_add_weighted():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (64, 97, 3)).astype(np.uint8)
    b = rng.randint(0, 256, (64, 97, 3)).astype(np.uint8)
    np.testing.assert_array_equal(plots.add_weighted(a, 0.4, b, 0.6, 0),
                                  cv2.addWeighted(a, 0.4, b, 0.6, 0))
    x, y = np.meshgrid(np.arange(256), np.arange(256))     # every pair of levels
    a, b = x.astype(np.uint8)[..., None], y.astype(np.uint8)[..., None]
    np.testing.assert_array_equal(plots.add_weighted(a, 0.4, b, 0.6, 0)[..., 0],
                                  cv2.addWeighted(a, 0.4, b, 0.6, 0))


def test_plot_one_box_matches_cv2_outside_its_bands():
    rng = np.random.RandomState(1)
    shares, maxes = [], []
    for _ in range(40):
        img = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
        x0, y0 = rng.randint(-5, 290, 2)
        w, h = rng.randint(0, 150, 2)
        box = [x0, y0, x0 + w, y0 + h]
        color = [int(v) for v in rng.randint(0, 255, 3)]
        cls, conf = int(rng.randint(0, 19)), float(rng.rand())
        label = f"{cls} {conf:.2f}"
        want, got = img.copy(), img.copy()
        c1, c2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        cv2.rectangle(want, c1, c2, color, thickness=TL, lineType=cv2.LINE_AA)
        t_size = cv2.getTextSize(label, 0, fontScale=TL / 3, thickness=TL - 1)[0]
        assert plots.text_size(label) == t_size
        cv2.rectangle(want, c1, (c1[0] + t_size[0], c1[1] - t_size[1] - 3), color, -1,
                      cv2.LINE_AA)
        cv2.putText(want, label, (c1[0], c1[1] - 2), 0, TL / 3, [225, 255, 255],
                    thickness=TL - 1, lineType=cv2.LINE_AA)
        plots.plot_one_box(box, got, color=color, label=label, line_thickness=TL)
        line = [[cls, (x0 + w / 2) / 300, (y0 + h / 2) / 200, w / 300, h / 200, conf]]
        share, mx = _hold_drawing(got, want, _bands(img.shape, line))
        shares.append(share)
        maxes.append(mx)
    assert max(shares) <= BOX_BAND_SHARE and max(maxes) <= BOX_BAND_MAX, (shares, maxes)
    assert np.mean(shares) <= BOX_BAND_MEAN


@pytest.mark.parametrize("auto", [True, False])
def test_load_images_matches_jax(staged, auto):
    from multiyolov5_tpu.data.sources import LoadImages as JaxLoadImages
    from multiyolov5_tpu_torch.data.sources import LoadImages
    _, _, src = staged
    got, want = LoadImages(src, 256, 32, auto), JaxLoadImages(src, 256, 32, auto)
    assert len(got) == len(want) == 2
    n = 0
    for (pp, ip, i0p, cap), (pj, ij, i0j, _) in zip(got, want):
        assert pp == pj and cap is None and ip.flags.c_contiguous
        np.testing.assert_array_equal(i0p, i0j)
        np.testing.assert_array_equal(ip, ij)
        n += 1
    assert n == 2 and ip.shape == ((128, 256, 3) if auto else (256, 256, 3))


def test_what_needs_cv2_raises_up_front(staged, tmp_path):
    from multiyolov5_tpu_torch.data.sources import LoadImages, LoadStreams, LoadWebcam
    root, ckpt, src = staged
    for name, what in (("a.dng", "DNG"), ("b.mp4", "VideoCapture")):
        d = tmp_path / name.split(".")[1]
        d.mkdir()
        (d / name).write_bytes(b"x")
        with pytest.raises(NotImplementedError, match=what):
            LoadImages(str(d))
    for cls in (LoadStreams, LoadWebcam):
        with pytest.raises(NotImplementedError, match="VideoCapture"):
            cls("0")
    for extra in (["--view-img"], ["--save-as-video"], ["--source", "0"]):
        with pytest.raises(NotImplementedError):
            port_main(["--weights", ckpt, "--source", src, "--device", "cpu",
                       "--project", str(tmp_path / "runs")] + extra)
    assert not (tmp_path / "runs").exists()
