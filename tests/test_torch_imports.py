"""The port stands without JAX: in a fresh interpreter where importing
``jax`` or ``multiyolov5_tpu`` raises, every module of the port imports (and
so do chip_smoke.py and the ``prof_*_torch.py`` scripts), a
tiny seeded Engine serves one frame on the CPU, so does each other model
family (the Base, BiSe and Lab seg heads, detection-only, P6; narrowed) on
a float frame, the eval path (multi-label
NMS over more than K3's 1024 rows, mAP, mIoU) runs on one batch, and the
dual-task train step of the TINY spec (tests/test_torch_train_step.py)
takes one update on the CPU, and an ``InferenceServer`` on the TINY spec
serves two frames in one batch (through the K7 route of its backbone C3s)
and closes."""

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
            if name.split(".")[0] in ("jax", "jaxlib", "multiyolov5_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import multiyolov5_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for script in ("chip_smoke", "prof_c3_torch", "prof_stem_torch", "prof_eval_torch",
                   "prof_serving_torch", "prof_train_torch", "prof_nms_torch",
                   "prof_conv3x3_torch", "prof_seg_ce_torch", "prof_mask_torch"):
        importlib.import_module(script)
    from multiyolov5_tpu_torch.engine import Engine
    eng = Engine(cfg="yolov5s_city_seg", device="cpu", half=False, seed=1)
    frame = (np.random.RandomState(0).rand(64, 128, 3) * 255).astype(np.uint8)
    dets, masks = eng(frame, (64, 128), conf=0.001)
    assert dets[0].ndim == 2 and dets[0].shape[1] == 6 and len(dets[0]) > 0
    assert masks[0].shape == (64, 128) and masks[0].dtype == np.uint8
    new = {"evaluation", "ops.kernels.nms_greedy", "utils.metrics", "utils.boxes",
           "train.trainer", "train.losses", "train.optim", "data.hyps", "ops.kernels.seg_ce",
           "serving", "data.letterbox", "ops.kernels.c3"}
    assert {pkg.__name__ + "." + m for m in new} <= set(names)
    from multiyolov5_tpu_torch.models import zoo
    for name in ("yolov5s_city_seg_base", "yolov5s_city_seg_bise", "yolov5s_city_seg_lab",
                 "yolov5s", "yolov5s6"):
        cfg = zoo.get(name)
        cfg["width_multiple"] = 0.125
        fd, fm = Engine(cfg=cfg, device="cpu", half=False, seed=0)(
            np.random.RandomState(3).rand(64, 128, 3).astype(np.float32), (64, 128), conf=0.001)
        assert fd[0].shape[1] == 6 and (fm[0] is None) == ("n_segcls" not in cfg)

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
    assert not any(m.split(".")[0] in ("jax", "multiyolov5_tpu") for m in sys.modules)
    print("OK", len(names))
""")


def test_port_imports_and_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         env={**os.environ, "TINY_SPEC": json.dumps(TINY)},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("OK")
