"""The six v5.0 hub models in the port against the JAX package, on the CPU in
float32 (and bfloat16 where named).

Each hub config (``multiyolov5_tpu_torch/models/hub``) narrowed to
``width_multiple`` 0.125 (yolov3-tiny and the transformer 0.25), nc 3, on
the port's seeded weights (``seeded_state_dict`` seed 0: BN statistics
measured on a seeded batch), handed to the JAX package by
``to_jax_params``.  One seeded 64x128 frame.
  * ``Model`` against the JAX ``forward`` (``sever=False``), unfused and
    folded (each side's ``fuse_conv_bn``): decoded candidates, boxes within
    5e-4 of their largest |value| and obj/cls within 1e-4, and the raw
    per-level maps within 1e-4 of max(1, their largest |value|): float32
    reassociation through up to 75 convs (read: at most 2e-5 of the box
    scale and 1e-5 on obj/cls, yolov5-fpn aside).  yolov5-fpn, the deepest
    (39 BottleneckCSP repeats), amplifies float32 rounding itself: against
    the same port network in float64 the JAX side's obj/cls are off by up
    to 2e-4, the port's by 1.2e-4.  So each bound is at least 4 times the
    JAX side's own distance from float64.
  * ``Engine`` against the JAX ``Engine`` on detections (conf 3e-4) for
    yolov3-tiny (no folded stem: rows from 0 on the frame / 255, MaxPool
    and ZeroPad rows) and tests/test_experimental_blocks.py's
    BottleneckCSP + MixConv2d config (BNs no conv absorbs, in the folded
    engine), float32 and bfloat16.  float32: equal counts, and each port
    detection has a JAX detection of its class within 1 px (both round to
    whole pixels) and a score within 1e-4 (read: 0 px, 1.3e-9).  bfloat16
    quantises the scores, so near-ties reorder the NMS on either side:
    counts within 5%, and at least 90% of the port's detections have such
    a partner within 1 px and 5e-4 (read: 92-98% over three frames).
  * yolov3-tiny's TTA, a two-checkpoint ensemble and an InferenceServer
    (float32) against the JAX package's, under the float32 bounds above.
  * one train step of yolov5-panet (BottleneckCSP throughout, no seg head)
    against the JAX ``make_train_step``, under the bounds of
    tests/test_torch_train_step.py.
  * the FLOP count: the port's ``estimate_gflops`` equals the JAX count
    plus the Focus conv's and, for yolov5s-transformer, plus the linears'
    and attention's products, which the JAX counter leaves out
    (multiyolov5_tpu/models/blocks.py:288-294, :310-333 call no
    ``_add_macs``), exactly; for yolov3 it equals the JAX count.  yolov3's
    parameters at full width: 61,949,149, the published summary's 61.9M.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import forward as jax_forward
from multiyolov5_tpu.ops.nn import fuse_conv_bn as jax_fuse
from multiyolov5_tpu.train.trainer import TrainConfig as JaxTrainConfig
from multiyolov5_tpu.train.trainer import create_train_state as jax_create
from multiyolov5_tpu.train.trainer import make_train_step as jax_make_step
from multiyolov5_tpu.utils import profiling as jax_profiling
from multiyolov5_tpu.models.model import init_model
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models.config import HUB_DIR, hub_configs, load_spec
from multiyolov5_tpu_torch.models.model import Model, seeded_state_dict
from multiyolov5_tpu_torch.ops.nn import fuse_conv_bn
from multiyolov5_tpu_torch.train.trainer import TrainConfig, create_train_state, make_train_step
from multiyolov5_tpu_torch.utils import profiling
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params, to_jax_params

from test_torch_profiling import _focus_flops, one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_step import HYP, LOSS_REL, LR, LR_BIAS, MOM, _batch, _close_update

IN_HW, ORIG_HW = (64, 128), (128, 256)
CONF = 3e-4
NC = 3
WIDTHS = {"yolov3": 0.125, "yolov3-spp": 0.125, "yolov3-tiny": 0.25, "yolov5-fpn": 0.125,
          "yolov5-panet": 0.125, "yolov5s-transformer": 0.25}
BOX_REL, OBJCLS_ABS, RAW_REL = 5e-4, 1e-4, 1e-4
F64_FACTOR = 4
# detections: (box px, score, share of the port's matched, count's relative difference)
DET_BOUNDS = {False: (1.0, 1e-4, 1.0, 0.0), True: (1.0, 5e-4, 0.9, 0.05)}
# tests/test_experimental_blocks.py:121-134
CSP_MIX = {"nc": 2, "depth_multiple": 1.0, "width_multiple": 1.0,
           "anchors": [[10, 13, 16, 30, 33, 23]],
           "backbone": [[-1, 1, "Focus", [16, 3]],
                        [-1, 1, "Conv", [32, 3, 2]],
                        [-1, 1, "BottleneckCSP", [32]],
                        [-1, 1, "MixConv2d", [32, [1, 3], 1]]],
           "head": [[[3], 1, "Detect", ["nc", "anchors"]]]}


def hub_cfg(name: str, width: float = None, nc: int = NC) -> dict:
    with open(os.path.join(HUB_DIR, f"{name}.yaml")) as fh:
        cfg = json.load(fh)
    cfg["width_multiple"] = WIDTHS[name] if width is None else width
    cfg["nc"] = nc
    return cfg


def test_hub_configs_are_the_six():
    assert hub_configs() == sorted(WIDTHS)


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def hub_model(request):
    cfg = hub_cfg(request.param)
    sd = seeded_state_dict(load_spec(cfg), seed=0)
    x = np.random.RandomState(5).rand(1, *IN_HW, 3).astype(np.float32)
    return request.param, cfg, sd, x


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_model_forward_matches_jax(hub_model, fused):
    name, cfg, sd, x = hub_model
    spec, jspec = load_spec(cfg), jax_load_spec(cfg)
    params, state = to_jax_params(sd)
    if fused:
        params = jax_fuse(params, state)
        state = {k: v for k, v in state.items()
                 if "running_" not in k or k.rsplit(".running_", 1)[0] + ".weight" in params}
        sd = fuse_conv_bn(sd)
    (zj, rawj), _, _ = jax_forward(jspec, params, state, jnp.asarray(x), train=False,
                                   fused=fused, sever=False)
    model = Model(spec, fused=fused).eval()
    model.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        (z, raw), seg = model(xt, decode="both")
        (z64, raw64), _ = copy.deepcopy(model).double()(xt.double(), decode="both")
    assert seg is None
    z, z64, zj = z.transpose(1, 2).numpy(), z64.transpose(1, 2).numpy(), np.asarray(zj)
    assert z.shape == zj.shape == (1, zj.shape[1], NC + 5)

    def close(got, want, ref64, bound):
        own = F64_FACTOR * np.abs(want - ref64).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=max(bound, own))

    box_scale = np.abs(zj[..., :4]).max()
    close(z[..., :4], zj[..., :4], z64[..., :4], BOX_REL * box_scale)
    close(z[..., 4:], zj[..., 4:], z64[..., 4:], OBJCLS_ABS)
    assert np.ptp(zj[..., 4]) > 1e-3                      # scores that vary
    assert len(raw) == len(rawj) == len(spec.strides)
    for r, rj, r64 in zip(raw, rawj, raw64):
        rj = np.asarray(rj)
        close(r.numpy(), rj, r64.numpy(), RAW_REL * max(1.0, np.abs(rj).max()))


ENGINE_CASES = {"yolov3-tiny": lambda: hub_cfg("yolov3-tiny"), "csp_mixconv": lambda: CSP_MIX}


@pytest.mark.parametrize("half", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax(case, half):
    cfg = ENGINE_CASES[case]()
    sd = seeded_state_dict(load_spec(cfg), seed=0)
    params, state = to_jax_params(sd)
    jeng = JaxEngine(spec=jax_load_spec(cfg), params=params, state=state, half=half)
    peng = Engine(spec=load_spec(cfg), state_dict=from_jax_params(params, state),
                  device="cpu", half=half)
    assert peng.fold_stem == (case == "csp_mixconv")
    if case == "csp_mixconv":     # the post-concat BNs keep their statistics
        assert "model.2.bn.running_var" in peng.model.state_dict()
        assert "model.3.bn.running_mean" in peng.model.state_dict()
    img = (np.random.RandomState(5).rand(1, *IN_HW, 3) * 255).astype(np.uint8)
    dj, _ = jeng(img, ORIG_HW, conf=CONF)
    dp, mp = peng(img, ORIG_HW, conf=CONF)
    assert mp == [None]
    box_px, score, share, count_rel = DET_BOUNDS[half]
    assert len(dp[0]) >= 20 and abs(len(dp[0]) - len(dj[0])) <= count_rel * len(dj[0])
    matched = 0
    for det in dp[0]:
        same = dj[0][dj[0][:, 5] == det[5]]
        matched += ((np.abs(same[:, :4] - det[:4]).max(1) <= box_px)
                    & (np.abs(same[:, 4] - det[4]) <= score)).any()
    assert matched >= share * len(dp[0]), (matched, len(dp[0]))


def _matched(dp, dj, box_px, score):
    """Each port detection has a JAX one of its class within ``box_px`` and ``score``."""
    assert len(dp) >= 5 and len(dp) == len(dj)
    for det in dp:
        same = dj[dj[:, 5] == det[5]]
        assert ((np.abs(same[:, :4] - det[:4]).max(1) <= box_px)
                & (np.abs(same[:, 4] - det[4]) <= score)).any(), det


def test_tta_ensemble_and_server_on_a_stem_from_row_0(tmp_path):
    """yolov3-tiny in float32: TTA (three passes, the scaled ones on float
    frames from row 0), a two-checkpoint ensemble and an InferenceServer
    against the JAX package's, under the float32 detection bounds above."""
    from multiyolov5_tpu.serving import InferenceServer as JaxServer
    from multiyolov5_tpu.utils.checkpoint import save_npz as jax_save_npz
    from multiyolov5_tpu_torch.serving import InferenceServer

    cfg = hub_cfg("yolov3-tiny")
    paths = []
    for seed in (0, 1):
        params, state = to_jax_params(seeded_state_dict(load_spec(cfg), seed=seed))
        paths.append(str(tmp_path / f"w{seed}.npz"))
        jax_save_npz(paths[-1], {"params": params, "state": state,
                                 "spec_yaml": json.dumps(cfg)})
    jeng, peng = JaxEngine(paths[0], half=False), Engine(paths[0], device="cpu", half=False)
    img = (np.random.RandomState(5).rand(1, *IN_HW, 3) * 255).astype(np.uint8)
    box_px, score = DET_BOUNDS[False][:2]
    _matched(peng(img, ORIG_HW, conf=CONF, augment=True)[0][0],
             jeng(img, ORIG_HW, conf=CONF, augment=True)[0][0], box_px, score)
    jens, pens = JaxEngine(paths, half=False), Engine(paths, device="cpu", half=False)
    _matched(pens(img, ORIG_HW, conf=CONF)[0][0], jens(img, ORIG_HW, conf=CONF)[0][0],
             box_px, score)
    frames = [(np.random.RandomState(11 + i).rand(*ORIG_HW, 3) * 255).astype(np.uint8)
              for i in range(2)]
    outs = []
    for server in (InferenceServer(engine=peng, img_size=128, max_batch=4, max_wait_ms=500,
                                   conf=CONF),
                   JaxServer(engine=jeng, img_size=128, max_batch=4, max_wait_ms=500,
                             conf=CONF)):
        try:
            futs = [server.submit(f) for f in frames]
            outs.append([f.result(timeout=600) for f in futs])
        finally:
            server.close()
    for (dp, mp), (dj, mj) in zip(*outs):
        assert mp is None and mj is None
        _matched(dp, dj, box_px, score)


def test_panet_train_step_matches_jax():
    cfg = hub_cfg("yolov5-panet", 0.125)
    cfg["depth_multiple"] = 0.33
    jspec = jax_load_spec(cfg)
    jcfg = JaxTrainConfig(hyp=HYP, batch_size=2, seg_batch_size=2, compute_dtype=jnp.float32)
    ts0, groups = jax_create(jspec, jcfg, seed=0)
    jstep = jax_make_step(jspec, jcfg, groups, donate=False)
    spec = load_spec(cfg)
    pcfg = TrainConfig(hyp=HYP, batch_size=2, compute_dtype=torch.float32)
    pts, pgroups = create_train_state(
        spec, pcfg, state_dict=from_jax_params(ts0["params"], ts0["state"]), device="cpu")
    pstep = make_train_step(spec, pcfg, pgroups)
    batch = _batch(100)
    jts, jm = jstep(ts0, *[jnp.asarray(a) for a in batch], jax.random.PRNGKey(0),
                    jnp.float32(LR), jnp.float32(LR_BIAS), jnp.float32(MOM), jnp.asarray(True))
    pts, pm = pstep(pts, *batch, LR, LR_BIAS, MOM, True)
    for k in ("total", "det_items"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), rtol=LOSS_REL, atol=0,
                                   err_msg=k)
    assert float(pm["total"]) > 0
    params, state = to_jax_params(pts.state_dict())
    ema_params, ema_state = to_jax_params(pts.ema)
    mom = to_jax_params(pts.opt["momentum"])[0]
    assert set(params) == set(jts["params"]) and set(state) == set(jts["state"])
    assert any(k.endswith(".bn.running_var") and ".m." not in k and ".cv" not in k
               for k in state)                        # BottleneckCSP's own BN
    for what, got, init in (("params", params, "params"), ("state", state, "state"),
                            ("ema_params", ema_params, "params"),
                            ("ema_state", ema_state, "state"), ("opt", mom, "opt")):
        for k, want in jts[what].items():
            _close_update(got[k], want, np.asarray(ts0[init][k]), f"{what}[{k}]")


def _attention_flops(spec, hw) -> int:
    """2 x the MACs of every C3TR's linears and attention products, which
    the JAX counter leaves out: a TransformerBlock's ``linear`` (L c^2), and
    a layer's q, k, v, the in-projection (3), out-projection, fc1 and fc2
    (9 L c^2) and its two attention products (2 L^2 c), at L tokens."""
    macs = 0
    for row in spec.rows:
        if row.module == "C3TR":
            c, n = row.args[1] // 2, row.args[2]
            tokens = (hw[0] // row.stride) * (hw[1] // row.stride)
            macs += tokens * c * c + n * (9 * tokens * c * c + 2 * tokens * tokens * c)
    return 2 * macs


@pytest.mark.parametrize("name", ["yolov5s-transformer", "yolov3"])
def test_flops_are_the_jax_count_plus_what_it_leaves_out(name):
    hw = (256, 320)
    cfg = hub_cfg(name, 0.25, nc=80)
    spec = load_spec(cfg)
    jspec = jax_load_spec(cfg)
    want = jax_profiling.estimate_gflops(jspec, init_model(jspec, 0)[0], hw) * 1e9
    got = profiling.estimate_gflops(spec, None, hw) * 1e9
    extra = 0
    if name == "yolov5s-transformer":
        extra = _focus_flops(spec, hw) + _attention_flops(spec, hw)
        assert _attention_flops(spec, hw) > 0
    assert abs(got - (want + extra)) <= 1e-12 * got


def test_yolov3_full_width_parameters():
    with torch.device("meta"):
        model = Model(load_spec("yolov3"))
    assert sum(p.numel() for p in model.parameters()) == 61_949_149
