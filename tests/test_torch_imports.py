"""The port stands without JAX: in a fresh interpreter where importing
``jax``, ``multiyolov5_tpu``, ``cv2``, ``PIL``, ``torchvision``,
``matplotlib``, ``seaborn`` or ``wandb`` raises (the card's machine has none
of them), every module of the port imports (and
so do chip_smoke.py and the ``prof_*_torch.py`` scripts), a
tiny seeded Engine serves one frame on the CPU, so does each other model
family (the Base, BiSe and Lab seg heads, detection-only, P6; narrowed) on
a float frame, the six hub configs load without PyYAML and yolov3-tiny
and yolov5s-transformer (narrowed) serve a frame, the eval path (multi-label
NMS over more than K3's 1024 rows, mAP, mIoU) runs on one batch, and the
dual-task train step of the TINY spec (tests/test_torch_train_step.py)
takes one update on the CPU, and an ``InferenceServer`` on the TINY spec
serves two frames in one batch (through the K7 route of its backbone C3s)
and closes, and the detect app (``cli/detect.py``) on the TINY spec
(``--submit --save-txt``) reads two PNGs written by ``data/png.py`` and
writes every artifact, each of which decodes, and the eval CLI
(``cli/test.py``) on the TINY spec reads a PNG detection split and a
Cityscapes-layout seg split through the port's loaders (the dataset file
in JSON, without PyYAML) and prints its metrics, with ``--plots`` writing
its five plots (``utils/charts.py``, no matplotlib), and hub's ``AutoShape``
serves a PNG path and a gray array.  PyYAML and pandas are blocked too:
the card's machine need not have them.  The host tools run the same way
(``tools/cityscapes2yolo.py``, ``tools/labelme_convert.py`` with the
numpy fill of ``data/draw.py`` and its JPEG output, ``hist_equalize``,
``replicate``, ``cutout``, ``prune_params``, ``wh_iou``,
``seg_confusion_device``), and so do the image codecs (``data/jpeg.py``,
``data/bmp.py``, ``data/tiff.py``, ``data/webp.py``, ``data/png.py``
through ``data/images.py``): a frame written and read back as JPEG, BMP,
TIFF and WebP, and an Adam7 16-bit PNG read.  Every module of the
port, ``data/jpeg.py``, ``data/bmp.py``, ``data/tiff.py``, ``data/webp.py``,
``data/host_codecs.py``, ``data/images.py``, ``utils/charts.py`` and
``utils/loggers.py`` among them, imports with those modules blocked, and
none of them is loaded after any of these runs.  The training CLI's run
writes its plots and says W&B is off."""

import json
import os
import subprocess
import sys
import textwrap

from test_torch_train_step import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import contextlib, importlib, io, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "multiyolov5_tpu", "cv2", "PIL",
                                      "torchvision", "yaml", "pandas", "matplotlib",
                                      "seaborn", "wandb"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    # absent also to importlib.util.find_spec, which torch's own probes call
    # (torch._dynamo, reached by FlopCounterMode and torch.export): None, as
    # on a machine without them, where the finder above would raise
    for name in ("jax", "jaxlib", "multiyolov5_tpu", "cv2", "PIL", "torchvision", "yaml",
                 "pandas", "matplotlib", "seaborn", "wandb"):
        sys.modules[name] = None
    import numpy as np
    import multiyolov5_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for script in ("chip_smoke", "prof_c3_torch", "prof_stem_torch", "prof_eval_torch",
                   "prof_serving_torch", "prof_train_torch", "prof_nms_torch",
                   "prof_conv3x3_torch", "prof_seg_ce_torch", "prof_mask_torch",
                   "prof_collectives_torch"):
        importlib.import_module(script)
    from multiyolov5_tpu_torch.engine import Engine
    eng = Engine(cfg="yolov5s_city_seg", device="cpu", half=False, seed=1)
    frame = (np.random.RandomState(0).rand(64, 128, 3) * 255).astype(np.uint8)
    dets, masks = eng(frame, (64, 128), conf=0.001)
    assert dets[0].ndim == 2 and dets[0].shape[1] == 6 and len(dets[0]) > 0
    assert masks[0].shape == (64, 128) and masks[0].dtype == np.uint8
    new = {"evaluation", "ops.kernels.nms_greedy", "utils.metrics", "utils.boxes",
           "train.trainer", "train.losses", "train.optim", "data.hyps", "ops.kernels.seg_ce",
           "serving", "data.letterbox", "ops.kernels.c3", "data.png", "data.sources",
           "data.cityscapes", "utils.general", "utils.plots", "cli.detect", "data.resize",
           "data.detection", "data.segmentation", "cli.test", "hub", "utils.profiling",
           "cli.profile", "cli.export", "tools.trace_report", "tools.convert_pt",
           "parallel.comm", "parallel.mesh", "parallel.sync_bn", "parallel.spatial",
           "ops.shard", "data.jpeg", "data.images", "utils.charts", "utils.loggers",
           "data.bmp", "data.tiff", "data.host_codecs", "data.webp"}
    assert {pkg.__name__ + "." + m for m in new} <= set(names)
    from multiyolov5_tpu_torch.models import zoo
    for name in ("yolov5s_city_seg_base", "yolov5s_city_seg_bise", "yolov5s_city_seg_lab",
                 "yolov5s", "yolov5s6"):
        cfg = zoo.get(name)
        cfg["width_multiple"] = 0.125
        fd, fm = Engine(cfg=cfg, device="cpu", half=False, seed=0)(
            np.random.RandomState(3).rand(64, 128, 3).astype(np.float32), (64, 128), conf=0.001)
        assert fd[0].shape[1] == 6 and (fm[0] is None) == ("n_segcls" not in cfg)
    from multiyolov5_tpu_torch.models.config import hub_configs
    from multiyolov5_tpu_torch.models.config import load_spec as hub_spec
    assert len(hub_configs()) == 6
    for name in hub_configs():          # JSON files: read without PyYAML
        cfg = dict(hub_spec(name).yaml, width_multiple=0.125)
        if name in ("yolov3-tiny", "yolov5s-transformer"):
            fd, fm = Engine(cfg=cfg, device="cpu", half=False, seed=0)(frame, (64, 128),
                                                                      conf=0.001)
            assert fd[0].shape[1] == 6 and fm[0] is None

    from multiyolov5_tpu_torch.evaluation import evaluate_detection, seg_validation
    import multiyolov5_tpu_torch.ops.nms as nms_mod
    counts = []
    real = nms_mod.nms_greedy
    nms_mod.nms_greedy = lambda *a: counts.extend((a[1] > 0).sum(1).tolist()) or real(*a)
    targets = np.array([[[1, 0.3, 0.4, 0.2, 0.3], [4, 0.7, 0.5, 0.3, 0.3]]], np.float32)
    loader = [(frame[None], targets, np.ones((1, 2), bool), ["a.png"], [None])]
    masks = np.random.RandomState(1).randint(-1, 19, (1, 64, 128)).astype(np.int32)
    with contextlib.redirect_stdout(io.StringIO()):
        res, maps, (_, _, seen) = evaluate_detection(eng, loader, conf_thres=0.0002)
        pix_acc, miou = seg_validation(eng, [(frame[None], masks)], nclass=19)
    assert seen == 1 and len(res) == 7 and maps.shape == (10,) and max(counts) > 1024
    assert 0 <= pix_acc <= 1 and 0 <= miou <= 1

    import json, os, torch
    from multiyolov5_tpu_torch.data.hyps import load_hyp
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.train.losses import pad_targets
    from multiyolov5_tpu_torch.train.trainer import (TrainConfig, create_train_state,
                                                     make_train_step)
    spec = load_spec(json.loads(os.environ["TINY_SPEC"]))
    cfg = TrainConfig(hyp=load_hyp("scratch"), batch_size=2,
                      compute_dtype=torch.float32)
    ts, groups = create_train_state(spec, cfg, seed=0, device="cpu")
    step = make_train_step(spec, cfg, groups)
    rng = np.random.RandomState(2)
    tgts, tmask = pad_targets([np.array([[1, 0.5, 0.5, 0.3, 0.3]], np.float32)] * 2, 4)
    ts, m = step(ts, (rng.rand(2, 64, 64, 3) * 255).astype(np.uint8), tgts, tmask,
                 rng.rand(2, 64, 64, 3).astype(np.float32), rng.randint(-1, 4, (2, 64, 64)),
                 0.01, 0.01, 0.9, True)
    assert ts.updates == 1 and np.isfinite(float(m["total"])) and float(m["seg_loss"]) > 0

    from multiyolov5_tpu_torch.models import blocks
    from multiyolov5_tpu_torch.serving import InferenceServer
    k7 = []
    real_c3 = blocks.c3
    blocks.c3 = lambda x, *a: k7.append(tuple(x.shape)) or real_c3(x, *a)
    server = InferenceServer(cfg=json.loads(os.environ["TINY_SPEC"]), device="cpu",
                             half=False, img_size=64, max_wait_ms=500, conf=0.001)
    futs = [server.submit((rng.rand(64, 128, 3) * 255).astype(np.uint8)) for _ in range(2)]
    outs = [f.result(timeout=120) for f in futs]
    server.close()
    assert all(d.shape[1] == 6 and mk.shape == (64, 128) for d, mk in outs)
    assert server.stats()["batches"] == 1 and k7 and all(s[0] == 2 for s in k7)

    import tempfile
    from multiyolov5_tpu_torch.cli.detect import main as detect_main
    from multiyolov5_tpu_torch.data import png
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.utils.checkpoint import save_npz, to_jax_params
    tmp = tempfile.mkdtemp()
    params, state = to_jax_params(seeded_state_dict(spec, 0))
    save_npz(tmp + "/w.npz", {"params": params, "state": state,
                              "spec_yaml": os.environ["TINY_SPEC"]})
    os.makedirs(tmp + "/src")
    frames = [(rng.rand(48, 96, 3) * 255).astype(np.uint8) for _ in range(2)]
    for i, f in enumerate(frames):
        png.imwrite(f"{tmp}/src/f{i}.png", f)
    with contextlib.redirect_stdout(io.StringIO()):
        out = detect_main(["--weights", tmp + "/w.npz", "--source", tmp + "/src",
                           "--img-size", "64", "--device", "cpu", "--no-half", "--save-txt",
                           "--save-conf", "--submit", "--conf-thres", "0.001",
                           "--project", tmp + "/runs"])
    for i, f in enumerate(frames):
        for art in (f"f{i}.png", f"f{i}_mask.png", f"f{i}_dst.png", f"results/f{i}_pred.png"):
            assert png.imread(f"{out}/{art}").shape == f.shape, art
        assert len(open(f"{out}/labels/f{i}.txt").read().splitlines()) > 0

    from multiyolov5_tpu_torch.cli.test import main as test_main
    for sub in ("det/images/val", "det/labels/val", "citys/leftImg8bit/val/x",
                "citys/gtFine/val/x"):
        os.makedirs(f"{tmp}/{sub}")
    for i, (h, w) in enumerate(((48, 96), (60, 120), (96, 48))):
        png.imwrite(f"{tmp}/det/images/val/d{i}.png", (rng.rand(h, w, 3) * 255).astype(np.uint8))
        with open(f"{tmp}/det/labels/val/d{i}.txt", "w") as fh:
            fh.write("1 0.5 0.5 0.3 0.4\\n0 0.3 0.3 0.2 0.2\\n")
        png.imwrite(f"{tmp}/citys/leftImg8bit/val/x/x_{i}_leftImg8bit.png",
                    (rng.rand(64, 128, 3) * 255).astype(np.uint8))
        png.imwrite(f"{tmp}/citys/gtFine/val/x/x_{i}_gtFine_labelIds.png",
                    rng.randint(0, 34, (64, 128)).astype(np.uint8))
    with open(tmp + "/data.json", "w") as fh:
        json.dump({"val": tmp + "/det/images/val", "segval": tmp + "/citys"}, fh)
    os.makedirs(tmp + "/plots")
    with contextlib.redirect_stdout(io.StringIO()):
        res = test_main(["--weights", tmp + "/w.npz", "--data", tmp + "/data.json",
                         "--img-size", "64", "--base-size", "64", "--batch-size", "8",
                         "--device", "cpu", "--workers", "2", "--plots", "--save-dir",
                         tmp + "/plots", "--conf-thres", "0.0001"])
    assert sorted(res) == ["P", "R", "mAP", "mAP50", "mIoU", "pixAcc"]
    assert os.listdir(tmp + "/plots") == ["confusion_matrix.png"]     # no true positive
    from multiyolov5_tpu_torch.utils.metrics import ap_per_class
    ap_per_class(np.repeat([[True], [False]], 10, 1), np.array([0.9, 0.5]), np.array([0., 1.]),
                 np.array([0., 1.]), plot=True, save_dir=tmp + "/plots", names=["a", "b"])
    assert sorted(os.listdir(tmp + "/plots")) == ["F1_curve.png", "PR_curve.png",
                                                  "P_curve.png", "R_curve.png",
                                                  "confusion_matrix.png"]
    assert all(0 <= float(v) <= 1 for v in res.values())

    from multiyolov5_tpu_torch.hub import AutoShape
    shape = AutoShape(Engine(tmp + "/w.npz", device="cpu", half=False))
    shape.conf = 0.001
    out = shape([f"{tmp}/det/images/val/d0.png", rng.randint(0, 256, (40, 80)).astype(np.uint8)],
                size=64)
    assert len(out) == 2 and out.files[0] == "d0.jpg" and out.masks[1].shape == (40, 80)
    with contextlib.redirect_stdout(io.StringIO()):
        out.save(tmp + "/hub")
    from multiyolov5_tpu_torch.data import images
    assert images.read_rgb(tmp + "/hub/d0.jpg").shape == (48, 96, 3)
    from multiyolov5_tpu_torch.cli.export import main as export_main
    from multiyolov5_tpu_torch.tools.convert_pt import convert
    from multiyolov5_tpu_torch.utils.profiling import estimate_gflops
    assert estimate_gflops(spec, img_size=64) > 0
    torch.save({"model": seeded_state_dict(spec, 0)}, tmp + "/w.pt")
    with contextlib.redirect_stdout(io.StringIO()):
        convert(tmp + "/w.pt", tmp + "/c.npz")
    assert Engine(tmp + "/c.npz", cfg=spec.yaml, device="cpu", half=False).spec.nc == spec.nc
    with contextlib.redirect_stdout(io.StringIO()):
        made = export_main(["--weights", tmp + "/w.npz", "--img-size", "64", "--include",
                            "torchscript", "--device", "cpu", "--output", tmp + "/export"])
    assert torch.jit.load(made[0])(torch.zeros(1, 3, 64, 64))[0].shape[-1] == spec.nc + 5
    assert not any(m.split(".")[0] in ("jax", "multiyolov5_tpu", "cv2", "PIL", "torchvision",
                                       "yaml", "pandas", "matplotlib", "seaborn", "wandb")
                   for m, mod in sys.modules.items() if mod is not None)
    print("OK", len(names))
""")


def test_port_imports_and_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         env={**os.environ, "TINY_SPEC": json.dumps(TINY),
                              "OMP_NUM_THREADS": "1"},  # tiny ops: one thread each
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("OK")


# the training CLI (cli/train.py, its augmenting loaders, autoanchor and
# tools/resume.py) with the same modules blocked: a TINY epoch with mosaic,
# the HSV jitter and the seg scale-crop-jitter, then the resume tool
_TRAIN_SCRIPT = _SCRIPT[:_SCRIPT.index("import numpy as np")] + textwrap.dedent("""
    import json, os, tempfile
    import numpy as np
    from multiyolov5_tpu_torch.cli import train
    from multiyolov5_tpu_torch.data import png
    from multiyolov5_tpu_torch.tools import resume
    import multiyolov5_tpu_torch.data.augment, multiyolov5_tpu_torch.data.pil_ops
    import multiyolov5_tpu_torch.utils.autoanchor, multiyolov5_tpu_torch.utils.loggers
    root = tempfile.mkdtemp()
    rng = np.random.RandomState(0)
    for d in ("images/train", "labels/train", "seg/segimages/train", "seg/seglabels/train",
              "seg/segimages/val", "seg/seglabels/val"):
        os.makedirs(os.path.join(root, d))
    for i in range(8):
        png.imwrite(f"{root}/images/train/im{i}.png", (rng.rand(64, 80, 3) * 255).astype(np.uint8))
        with open(f"{root}/labels/train/im{i}.txt", "w") as fh:
            fh.write("0 0.5 0.5 0.4 0.4\\n2 0.3 0.35 0.2 0.25\\n")
    for split in ("train", "val"):
        for i in range(4):
            png.imwrite(f"{root}/seg/segimages/{split}/s{i}.png",
                        (rng.rand(64, 96, 3) * 255).astype(np.uint8))
            png.imwrite(f"{root}/seg/seglabels/{split}/s{i}.png",
                        rng.randint(0, 4, (64, 96)).astype(np.uint8))
    with open(f"{root}/data.json", "w") as fh:
        json.dump({"train": f"{root}/images/train", "val": f"{root}/images/train", "nc": 3,
                   "segtrain": f"{root}/seg", "segval": f"{root}/seg"}, fh)
    with open(f"{root}/tiny.json", "w") as fh:
        fh.write(os.environ["TINY_SPEC"])
    import contextlib, io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run, _ = train.main(["--data", f"{root}/data.json", "--cfg", f"{root}/tiny.json",
                             "--epochs", "1", "--batch-size", "4", "--img-size", "64", "64",
                             "--base-size", "64", "--seg-data-kind", "custom", "--workers",
                             "2", "--device", "cpu", "--fp32", "--project", f"{root}/runs",
                             "--save-period", "1", "--bbox-interval", "1"])
    assert "W&B: off (wandb does not import)" in out.getvalue()
    rows = open(f"{run}/results.txt").read().split()
    assert len(rows) == 12 and np.isfinite([float(v) for v in rows]).all()
    for f in ("labels.jpg", "train_batch0.jpg", "train_batch1.jpg", "results.png"):
        assert os.path.isfile(f"{run}/{f}"), f
    assert resume.main(["--dir", f"{root}/runs", "--dry-run"]) == []
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "multiyolov5_tpu", "cv2", "PIL",
                                       "torchvision", "yaml", "pandas", "matplotlib",
                                       "seaborn", "wandb")
                   for m, mod in sys.modules.items() if mod is not None)
    print("OK")
""")


def test_training_cli_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", _TRAIN_SCRIPT], cwd=ROOT,
                         env={**os.environ, "TINY_SPEC": json.dumps(TINY),
                              "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")


# the host tools and helpers (tools/cityscapes2yolo.py, tools/labelme_convert.py,
# data/draw.py, the extra augmentations, utils/general.py's pruning,
# utils/metrics.seg_confusion_device) with the same modules blocked
_TOOLS_SCRIPT = _SCRIPT[:_SCRIPT.index("import numpy as np")] + textwrap.dedent("""
    import base64, contextlib, io, json, os, random, tempfile
    import numpy as np
    import torch
    from multiyolov5_tpu_torch.data import png
    from multiyolov5_tpu_torch.data.detection import cutout, hist_equalize, replicate
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.tools import cityscapes2yolo, labelme_convert
    from multiyolov5_tpu_torch.utils.boxes import wh_iou
    from multiyolov5_tpu_torch.utils.general import prune_params, sparsity
    from multiyolov5_tpu_torch.utils.metrics import seg_confusion_device
    root = tempfile.mkdtemp()
    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        os.makedirs(f"{root}/c/leftImg8bit/{split}/x")
        os.makedirs(f"{root}/c/gtFine/{split}/x")
        png.imwrite(f"{root}/c/leftImg8bit/{split}/x/x_0_leftImg8bit.png",
                    rng.randint(0, 256, (16, 32, 3)).astype(np.uint8))
        with open(f"{root}/c/gtFine/{split}/x/x_0_gtFine_polygons.json", "w") as fh:
            json.dump({"imgWidth": 32, "imgHeight": 16, "objects": [
                {"label": "car", "polygon": [[1, 2], [20, 3], [9, 14]]}]}, fh)
    with contextlib.redirect_stdout(io.StringIO()):
        cityscapes2yolo.main(["--root", f"{root}/c"])
    assert open(f"{root}/c/labels/val/x_0_leftImg8bit.txt").read().startswith("0 ")
    os.makedirs(f"{root}/lm")
    img = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    with open(f"{root}/lm/a.json", "w") as fh:
        json.dump({"imageData": base64.b64encode(png.encode(img)).decode(), "shapes": [
            {"label": "car", "points": [[2, 2], [25, 4], [12, 18]]},
            {"label": "road", "points": [[28, 18], [3, 1]], "shape_type": "rectangle"},
            {"label": "car", "points": [[10, 10], [14, 13]], "shape_type": "circle"}]}, fh)
    with open(f"{root}/labels.txt", "w") as fh:
        fh.write("__ignore__\\n_background_\\ncar\\nroad\\n")
    with contextlib.redirect_stdout(io.StringIO()):
        labelme_convert.main(["labelme2seg", f"{root}/lm", f"{root}/seg", "--labels",
                              f"{root}/labels.txt"])
    from multiyolov5_tpu_torch.data import images, jpeg
    assert images.read_rgb(f"{root}/seg/JPEGImages/a.jpg").shape == img.shape
    # the JPEG codec (its g++-built host part and numpy) round-trips a frame
    ramp = np.repeat((np.add.outer(np.arange(24), np.arange(40)) * 3)[..., None], 3, 2)
    ramp = ramp.astype(np.uint8)
    jpeg.imwrite(f"{root}/f.jpg", ramp)
    got = images.imread(f"{root}/f.jpg")
    assert got.shape == ramp.shape and np.abs(got.astype(int) - ramp).max() <= 4
    # the BMP, TIFF and WebP codecs (LZW and VP8L in g++-built host parts)
    # round-trip it too, and a 16-bit Adam7 PNG reads as its high bytes
    for ext in ("bmp", "tif", "webp"):
        images.imwrite(f"{root}/f.{ext}", ramp)
        assert np.array_equal(images.imread(f"{root}/f.{ext}"), ramp)
        assert np.array_equal(images.read_rgb(f"{root}/f.{ext}"), ramp[..., ::-1])
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    import _torch_image_writers
    with open(f"{root}/deep.png", "wb") as fh:
        fh.write(_torch_image_writers.png(ramp.astype(np.uint16) * 257, 16, 2, interlace=True,
                                          filters=(1, 4)))
    assert np.array_equal(images.imread(f"{root}/deep.png"), ramp[..., ::-1])
    assert set(np.unique(png.read_samples(f"{root}/seg/SegmentationClassPNG/a.png"))) == {
        0, 1, 2}
    frame = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    assert hist_equalize(frame).shape == frame.shape
    labels = np.array([[0, 2, 3, 20, 30], [1, 10, 5, 40, 20]], np.float32)
    img2, lab2 = replicate(frame.copy(), labels.copy(), random.Random(0))
    assert len(lab2) == 3 and len(cutout(img2, lab2, random.Random(1))) <= 3
    spec = load_spec(json.loads(os.environ["TINY_SPEC"]))
    with contextlib.redirect_stdout(io.StringIO()):
        pruned = prune_params(seeded_state_dict(spec, 0), 0.3)
    assert 0.1 < sparsity(pruned) < 0.5
    assert wh_iou(np.ones((2, 2)), np.ones((3, 2))).shape == (2, 3)
    inter, union = seg_confusion_device(torch.randn(1, 4, 8, 8), torch.randint(-1, 4, (1, 8, 8)),
                                        4)
    assert inter.dtype == torch.int64 and (union >= inter).all()
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "multiyolov5_tpu", "cv2", "PIL",
                                       "torchvision", "yaml", "pandas")
                   for m, mod in sys.modules.items() if mod is not None)
    print("OK")
""")


def test_host_tools_run_without_jax_pil_or_cv2():
    res = subprocess.run([sys.executable, "-c", _TOOLS_SCRIPT], cwd=ROOT,
                         env={**os.environ, "TINY_SPEC": json.dumps(TINY),
                              "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")
