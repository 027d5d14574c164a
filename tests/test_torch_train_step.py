"""The port's dual-task train step against the JAX package's, on the CPU in
float32.

The TINY spec of tests/test_train_step.py at 64x64, bs2: JAX's
``create_train_state`` gives the weights, ``from_jax_params`` hands them to
the port, and both run the same seeded batches.  Off the TPU the JAX step
takes its XLA seg loss (``segmentation_loss`` of the upsampled logits); the
port's CPU step takes K6's plain version, the same function.  The two
differ by float32 reassociation only (BN moments as E[x^2] - mean^2 there,
torch's own kernels here), which the backward amplifies where a gradient is
a small difference of large terms (the BN gains deep in the neck), and each
update feeds back into the next step's forward; a small learning rate keeps
that feedback small.  Bounds:
  * total loss, det items, seg loss: 1e-4 relative (read: 3.2e-6 after one
    step, 2.6e-5 on the third);
  * every parameter, BN statistic, EMA entry and momentum buffer is held
    by its change over the run, u = value - initial value:
    max |u_port - u_jax| <= 2e-2 * max |u_jax| + 4 ulp(max |value|), the
    last term four float32 ulps of the tensor's largest value: at this
    learning rate a BN gain of order 1 moves by a few ulps and a weight's
    EMA by a few of its own, so one rounding either way is a large share
    of the change, and the EMA of a constant (the anchors) rounds to within
    one (read: every tensor near the bound is off by exactly one ulp, the
    worst of the 1100 at 0.25 of it, after one step and after three, with
    1, 3 or 8 CPU threads).
A ``do_update=False`` step leaves every parameter, optimizer buffer, EMA
entry and the update count exactly as they were.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import forward as jax_forward
from multiyolov5_tpu.train.trainer import TrainConfig as JaxTrainConfig
from multiyolov5_tpu.train.trainer import create_train_state as jax_create
from multiyolov5_tpu.train.trainer import make_train_step as jax_make_step
from multiyolov5_tpu.utils.checkpoint import load_npz as jax_load_npz
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.train.losses import pad_targets
from multiyolov5_tpu_torch.train.trainer import (TrainConfig, checkpoint_tree,
                                                 create_train_state, make_train_step)
from multiyolov5_tpu_torch.utils.checkpoint import (from_jax_params, load_checkpoint,
                                                    save_npz, strip_optimizer,
                                                    to_jax_params)

from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

HYP = {"box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0, "obj_pw": 1.0,
       "anchor_t": 4.0, "fl_gamma": 0.0, "label_smoothing": 0.0,
       "weight_decay": 0.0005}

TINY = {
    "nc": 3, "n_segcls": 4, "depth_multiple": 0.33, "width_multiple": 0.125,
    "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                [116, 90, 156, 198, 373, 326]],
    "backbone": [
        [-1, 1, "Focus", [64, 3]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 1, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 1, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 1, "C3", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],
        [-1, 1, "SPP", [1024, [5, 9, 13]]],
        [-1, 1, "C3", [1024, False]],
    ],
    "head": [
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 1, "C3", [512, False]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 1, "C3", [256, False]],
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 1, "C3", [512, False]],
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 1, "C3", [1024, False]],
        [[16, 19, 22], 1, "SegMaskPSP", ["n_segcls", 3, 256, False]],
        [[17, 20, 23], 1, "Detect", ["nc", "anchors"]],
    ],
}
LR, LR_BIAS, MOM = 0.001, 0.002, 0.9
LOSS_REL, UPDATE_REL = 1e-4, 2e-2


def _batch(seed, B=2, sz=64, nseg=4, max_t=8):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(B, sz, sz, 3) * 255).astype(np.uint8)
    labels = []
    for _ in range(B):
        n = rng.randint(1, 4)
        lab = np.zeros((n, 5), np.float32)
        lab[:, 0] = rng.randint(0, 3, n)
        lab[:, 1:3] = rng.rand(n, 2) * 0.6 + 0.2
        lab[:, 3:5] = rng.rand(n, 2) * 0.3 + 0.1
        labels.append(lab)
    tgts, mask = pad_targets(labels, max_t)
    seg_imgs = rng.rand(B, sz, sz, 3).astype(np.float32)
    seg_lbls = rng.randint(-1, nseg, (B, sz, sz))
    return imgs, tgts, mask, seg_imgs, seg_lbls


@pytest.fixture(scope="module")
def pair():
    """JAX's step (one compile) and its initial state, the port's spec."""
    spec = jax_load_spec(TINY)
    cfg = JaxTrainConfig(hyp=HYP, batch_size=2, seg_batch_size=2,
                         compute_dtype=jnp.float32)
    ts0, groups = jax_create(spec, cfg, seed=0)
    step = jax_make_step(spec, cfg, groups, donate=False)
    return spec, ts0, step, load_spec(TINY)


def _run_jax(pair, updates):
    _, ts, step, _ = pair
    out = []
    for i, up in enumerate(updates):
        args = [jnp.asarray(a) for a in _batch(100 + i)]
        ts, m = step(ts, *args, jax.random.PRNGKey(i), jnp.float32(LR),
                     jnp.float32(LR_BIAS), jnp.float32(MOM), jnp.asarray(up))
        out.append({k: np.asarray(v) for k, v in m.items()})
    return ts, out


def _port_state(pair):
    _, ts0, _, spec = pair
    cfg = TrainConfig(hyp=HYP, batch_size=2, compute_dtype=torch.float32)
    ts, groups = create_train_state(
        spec, cfg, state_dict=from_jax_params(ts0["params"], ts0["state"]), device="cpu")
    return ts, make_train_step(spec, cfg, groups), cfg


def _run_port(pair, updates):
    ts, step, _ = _port_state(pair)
    out = []
    for i, up in enumerate(updates):
        ts, m = step(ts, *_batch(100 + i), LR, LR_BIAS, MOM, up)
        out.append({k: v.numpy() for k, v in m.items()})
    return ts, out


def _close_update(got, want, init, what):
    u_got = np.asarray(got, np.float32) - init
    u_want = np.asarray(want, np.float32) - init
    err = np.abs(u_got - u_want).max()
    bound = (UPDATE_REL * np.abs(u_want).max()
             + 4 * np.finfo(np.float32).eps * np.abs(np.asarray(want)).max())
    assert err <= bound, f"{what}: change differs by {err:.3e} > {bound:.3e}"


def _compare(pair, updates):
    ts0 = pair[1]
    jts, jm = _run_jax(pair, updates)
    pts, pm = _run_port(pair, updates)
    for a, b in zip(pm, jm):
        for k in ("total", "seg_loss", "det_items"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_REL, atol=0, err_msg=k)
    assert pts.updates == int(jts["updates"]) == sum(updates)
    params, state = to_jax_params(pts.state_dict())
    ema_params, ema_state = to_jax_params(pts.ema)
    mom = to_jax_params(pts.opt["momentum"])[0]
    assert set(params) == set(jts["params"]) and set(state) == set(jts["state"])
    for name, got, init in (("params", params, "params"), ("state", state, "state"),
                            ("ema_params", ema_params, "params"),
                            ("ema_state", ema_state, "state"), ("opt", mom, "opt")):
        for k, want in jts[name].items():
            _close_update(got[k], want, np.asarray(ts0[init][k]), f"{name}[{k}]")


def test_one_step_matches_jax(pair):
    _compare(pair, [True])


def test_accumulated_steps_match_jax(pair):
    _compare(pair, [False, True, True])


def test_no_update_leaves_state(pair):
    ts, step, _ = _port_state(pair)
    before = {k: v.clone() for k, v in ts.state_dict().items()}
    ema = {k: v.clone() for k, v in ts.ema.items()}
    ts, _ = step(ts, *_batch(7), LR, LR_BIAS, MOM, False)
    for k, p in ts.model.named_parameters():
        assert torch.equal(p, before[k]), k
        assert torch.equal(ts.opt["momentum"][k], torch.zeros_like(p)), k
    assert all(torch.equal(v, ema[k]) for k, v in ts.ema.items())
    assert ts.updates == 0
    assert sum(p.grad.abs().sum().item() for p in ts.model.parameters()) > 0
    # BN statistics advance on every step, update or not (as in the JAX step)
    assert not torch.equal(ts.state_dict()["model.0.conv.bn.running_mean"],
                           before["model.0.conv.bn.running_mean"])


def test_npz_round_trip(pair, tmp_path):
    """A port training checkpoint loads in the JAX package (HWIO weights,
    its skeleton format) and its EMA weights give the same forward there;
    ``strip_optimizer`` keeps the EMA and the port's loader reads it."""
    pts, _ = _run_port(pair, [True])
    jspec = pair[0]
    path = str(tmp_path / "last.npz")
    save_npz(path, checkpoint_tree(pts, pair[3], epoch=0, best_fitness=0.5))
    tree = jax_load_npz(path)
    assert int(tree["updates"]) == 1 and tree["epoch"] == 0
    assert json.loads(tree["spec_yaml"]) == pair[3].yaml
    x = np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32)
    (_, raw), seg, _ = jax_forward(jspec, tree["ema_params"], tree["ema_state"],
                                   jnp.asarray(x), train=False)
    model = pts.model
    model.load_state_dict(from_jax_params(tree["ema_params"], tree["ema_state"]),
                          strict=False)
    model.eval()
    with torch.no_grad():
        _, seg_p = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    seg_p = torch.nn.functional.interpolate(seg_p, size=(64, 64), mode="bilinear",
                                            align_corners=True)
    # float32 reassociation through the network (as tests/test_torch_engine.py)
    np.testing.assert_allclose(seg_p.permute(0, 2, 3, 1).numpy(), np.asarray(seg),
                               rtol=0, atol=1e-4)
    stripped = str(tmp_path / "best.npz")
    strip_optimizer(path, stripped)
    _, sd = load_checkpoint(stripped)
    ema = {**pts.ema}
    for k, v in sd.items():
        assert torch.equal(v, ema[k].float()), k


# ---------------------------------------------------------------------------
# The step's other settings, each against the JAX step (one compile a case)
# ---------------------------------------------------------------------------

HEAD_ROWS = {
    "SegMaskPSP": [[16, 19, 22], 1, "SegMaskPSP", ["n_segcls", 3, 256, False]],
    "SegMaskBase": [[16], 1, "SegMaskBase", ["n_segcls", 3, 512, False]],
    "SegMaskBiSe": [[16, 19, 22], 1, "SegMaskBiSe", ["n_segcls", 3, 256, False]],
    "SegMaskLab": [[4, 19], 1, "SegMaskLab", ["n_segcls", 3, 256, False]],
}
# Adam's first update is lr * m_hat / (sqrt(v_hat) + eps) = lr * g / (|g| +
# eps): where |g| is within a few eps of 0, float32 reassociation of g moves
# it anywhere in (-lr, lr), a sign flip included.  So an Adam case holds
# each tensor's change under the bound above except for at most ADAM_SHARE
# of its entries, and those within 2 * lr_max of each other.
ADAM_SHARE = 1e-3
CW = np.array([0.5, 1.0, 2.0, 1.5], np.float32)
# case: (head, JAX/port TrainConfig settings, hyp over HYP)
STEP_CASES = {
    "base": ("SegMaskBase", {}, {}),
    "lab_cw_flgamma_ls": ("SegMaskLab", {"class_weight": CW},
                          {"fl_gamma": 1.5, "label_smoothing": 0.1}),
    "bise_aux_ce": ("SegMaskBiSe", {"seg_aux": True}, {}),
    "bise_aux_ohem": ("SegMaskBiSe", {"seg_aux": True, "seg_loss": "ohem"}, {}),
    "adam_quad_det_only": ("SegMaskPSP", {"adam": True, "quad": True,
                                          "seg_enabled": False}, {}),
    "ohem": ("SegMaskPSP", {"seg_loss": "ohem"}, {}),
    "focal": ("SegMaskPSP", {"seg_loss": "focal"}, {}),
}


def _tiny(head):
    sp = json.loads(json.dumps(TINY))
    sp["head"][-2] = HEAD_ROWS[head]
    return sp


def _close_adam(got, want, init, what):
    u_got = np.asarray(got, np.float32) - init
    u_want = np.asarray(want, np.float32) - init
    bound = (UPDATE_REL * np.abs(u_want).max()
             + 4 * np.finfo(np.float32).eps * np.abs(np.asarray(want)).max())
    bad = np.abs(u_got - u_want) > bound
    assert bad.mean() <= ADAM_SHARE, f"{what}: {bad.sum()} of {bad.size} entries off"
    assert np.abs(u_got - u_want).max() <= 2 * max(LR, LR_BIAS) + bound, what


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_setting_matches_jax(case):
    """One update (rng None on both sides) under the bounds above; Adam's
    case under ADAM_SHARE too."""
    head, kw, hyp_over = STEP_CASES[case]
    hyp = {**HYP, **hyp_over}
    sp = _tiny(head)
    jspec = jax_load_spec(sp)
    jcfg = JaxTrainConfig(hyp=hyp, batch_size=2, seg_batch_size=2,
                          compute_dtype=jnp.float32, **kw)
    ts0, jgroups = jax_create(jspec, jcfg, seed=0)
    jstep = jax_make_step(jspec, jcfg, jgroups, donate=False)
    args = _batch(100)
    jts, jm = jstep(ts0, *[jnp.asarray(a) for a in args], None, jnp.float32(LR),
                    jnp.float32(LR_BIAS), jnp.float32(MOM), jnp.asarray(True))
    cfg = TrainConfig(hyp=hyp, batch_size=2, compute_dtype=torch.float32, **kw)
    pts, groups = create_train_state(
        load_spec(sp), cfg, state_dict=from_jax_params(ts0["params"], ts0["state"]),
        device="cpu")
    pts, pm = make_train_step(load_spec(sp), cfg, groups)(pts, *args, LR, LR_BIAS, MOM,
                                                          True, rng=None)
    for k in ("total", "seg_loss", "det_items"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), rtol=LOSS_REL,
                                   atol=0, err_msg=k)
    assert pts.updates == int(jts["updates"]) == 1
    params, state = to_jax_params(pts.state_dict())
    ema_params, ema_state = to_jax_params(pts.ema)
    adam = kw.get("adam", False)
    opt = ({"m": to_jax_params(pts.opt["m"])[0], "v": to_jax_params(pts.opt["v"])[0]}
           if adam else {"momentum": to_jax_params(pts.opt["momentum"])[0]})
    jopt = ({"m": jts["opt"][0], "v": jts["opt"][1]} if adam
            else {"momentum": jts["opt"]})
    if adam:
        assert pts.opt["t"] == int(jts["opt"][2]) == 1
    close = _close_adam if adam else _close_update
    for name, got, want, init in (
            ("params", params, jts["params"], ts0["params"]),
            ("state", state, jts["state"], ts0["state"]),
            ("ema_params", ema_params, jts["ema_params"], ts0["params"]),
            ("ema_state", ema_state, jts["ema_state"], ts0["state"]),
            *((f"opt.{k}", opt[k], jopt[k], {n: np.zeros_like(v) for n, v in jopt[k].items()})
              for k in jopt)):
        assert set(got) == set(want), name
        for k, w in want.items():
            close(got[k], w, np.asarray(init[k]), f"{name}[{k}]")


# ---------------------------------------------------------------------------
# Dropout follows the step's rng; remat; autobalance
# ---------------------------------------------------------------------------


def _port_run(head, rng_seed, remat=False, steps=1, updates=True):
    sp = _tiny(head)
    spec = load_spec(sp)
    cfg = TrainConfig(hyp=HYP, batch_size=2, compute_dtype=torch.float32, remat=remat)
    torch.manual_seed(123)               # the global generator must not matter
    ts, groups = create_train_state(spec, cfg, seed=0, device="cpu")
    step = make_train_step(spec, cfg, groups)
    g = None if rng_seed is None else torch.Generator().manual_seed(rng_seed)
    grads = []
    for i in range(steps):
        ts, m = step(ts, *_batch(100 + i), LR, LR_BIAS, MOM, updates, rng=g)
        grads.append({k: p.grad.clone() for k, p in ts.model.named_parameters()})
    return ts, m, grads


@pytest.mark.parametrize("head", ["SegMaskBase", "SegMaskBiSe", "SegMaskPSP"])
def test_dropout_follows_step_rng(head):
    """Two steps given generators of one seed are bitwise equal; a step
    given none differs from them only where there is dropout (Base, BiSe)."""
    ts_a, ma, _ = _port_run(head, 5)
    ts_b, mb, _ = _port_run(head, 5)
    ts_n, mn, _ = _port_run(head, None)
    for k, v in ts_a.state_dict().items():
        assert torch.equal(v, ts_b.state_dict()[k]), k
    assert torch.equal(ma["total"], mb["total"])
    dropout = head != "SegMaskPSP"
    assert (not torch.equal(ma["seg_loss"], mn["seg_loss"])) == dropout
    assert torch.equal(ma["det_items"], mn["det_items"])
    same = all(torch.equal(v, ts_n.state_dict()[k]) for k, v in ts_a.state_dict().items())
    assert same != dropout


def test_dropout_rng_none_and_eval_drop_nothing():
    """With no generator (the JAX ``Ctx.dropout`` with rng None) or in eval
    mode the head's dropout is the identity; a generator drops ~10% and
    scales the rest by 1/0.9."""
    from multiyolov5_tpu_torch.ops.nn import Dropout
    d = Dropout(0.1).train()
    x = torch.rand(4, 8, 16, 16) + 0.5
    assert torch.equal(d(x), x)
    d.generator = torch.Generator().manual_seed(0)
    y = d(x)
    share = (y == 0).float().mean().item()
    assert 0.07 < share < 0.13
    np.testing.assert_allclose(y[y != 0].numpy(), (x[y != 0] / 0.9).numpy(), rtol=1e-6)
    assert torch.equal(d.eval()(x), x)


@pytest.mark.parametrize("head", ["SegMaskBiSe", "SegMaskPSP"])
def test_remat_equals_the_plain_step(head):
    """remat (a non-reentrant checkpoint around each forward) gives the
    gradients and BN running statistics of the step without it, to 1e-6
    relative, with a live dropout mask redrawn in the recomputation, over
    two accumulated steps (the statistics advance once a forward)."""
    ts_r, mr, gr = _port_run(head, 7, remat=True, steps=2, updates=False)
    ts_p, mp, gp = _port_run(head, 7, remat=False, steps=2, updates=False)
    np.testing.assert_allclose(mr["total"].numpy(), mp["total"].numpy(), rtol=1e-6)
    for a, b in zip(gr, gp):
        for k in a:
            scale = max(b[k].abs().max().item(), 1e-30)
            assert (a[k] - b[k]).abs().max().item() <= 1e-6 * scale, k
    for k, v in ts_p.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(ts_r.state_dict()[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=0, err_msg=k)
    n_r, n_p = (t.model.state_dict()["model.0.conv.bn.num_batches_tracked"]
                for t in (ts_r, ts_p))
    assert int(n_r) == int(n_p) == 1 + 4  # init's statistics pass, 2 x (det + seg)


def test_autobalance_matches_jax():
    """DetectionLoss(autobalance=True): the per-level objectness weights in
    and out, renormalised by the stride-16 level, equal the JAX loss's."""
    from multiyolov5_tpu.train.losses import DetectionLoss as JaxLoss
    from multiyolov5_tpu_torch.train.losses import DetectionLoss as PortLoss
    rng = np.random.RandomState(3)
    anchors = np.asarray(TINY["anchors"], np.float32).reshape(3, 3, 2) \
        / np.array([8, 16, 32], np.float32)[:, None, None]
    preds = [rng.randn(2, 3, s, s, 8).astype(np.float32) for s in (8, 4, 2)]
    _, tgts, tmask, _, _ = _batch(9)
    bal = np.array([4.0, 1.0, 0.4], np.float32)
    kw = dict(nc=3, na=3, anchors=anchors, strides=[8, 16, 32], hyp=HYP, autobalance=True)
    jl, ji, jb = JaxLoss(**kw)([jnp.asarray(p) for p in preds], jnp.asarray(tgts),
                               jnp.asarray(tmask), balance=jnp.asarray(bal))
    pl, pi, pb = PortLoss(**kw)([torch.from_numpy(p) for p in preds], torch.from_numpy(tgts),
                                torch.from_numpy(tmask), balance=torch.from_numpy(bal))
    assert PortLoss(**kw).ssi == 1
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-5)
    assert pb[1].item() == 1.0
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=1e-5)
