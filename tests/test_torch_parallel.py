"""The port's parallelism (multiyolov5_tpu_torch/parallel) against the JAX
package's, on the CPU in float32: the port's ranks are spawned processes
over gloo (a ``file://`` store under the test's temporary directory), the
JAX package runs its mesh on the virtual CPU devices of tests/conftest.py.
The ranks' functions are in tests/_torch_parallel_worker.py (no JAX there:
a spawned rank imports it); each rank takes its slice of the same global
inputs, rank 0's first.

Bounds:
  * mesh entry points: as tests/test_mesh.py;
  * global-batch BN over 2 ranks (batch rows, or H rows) against one
    ``nn.BatchNorm2d`` over the whole batch: outputs, input gradients,
    summed parameter gradients and running statistics within 1e-5
    relative + 1e-6 (float32 summation order);
  * ``halo_exchange`` (a halo deeper than a shard): equal to the padded
    map's rows, gradients exactly the padded map's;
  * losses over 2 ranks with unequal target counts against the JAX loss
    of the global batch: as tests/test_torch_losses.py (detection values
    1e-5, seg values 5e-5 relative, gradients 1e-4 relative + 1e-6);
  * the 2-rank data-parallel step against the JAX step on
    ``make_mesh(2)``: losses within 1e-5 relative, parameters, EMA and BN
    statistics within 2e-4 relative + 5e-6 (tests/test_spatial.py:76-83);
    the ranks' states bitwise equal;
  * dropout (the Base head, a seeded generator) drawn for the global
    batch: the 2-rank step equals the port's one-process step under the
    same bounds;
  * ``save_sharded`` / ``load_sharded``: bitwise, written by 2 ranks and
    read by 2 and by 1.
The spatial forward and the dp x sp step are in
tests/test_torch_parallel_spatial.py.
"""

import json

import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import seeded_state_dict
from multiyolov5_tpu_torch.ops.nn import BN_EPS, BN_MOMENTUM
from multiyolov5_tpu_torch.parallel import mesh as pmesh
from multiyolov5_tpu_torch.train.trainer import TrainConfig, create_train_state, make_train_step
from multiyolov5_tpu_torch.utils.checkpoint import (from_jax_params, load_sharded,
                                                    save_sharded, to_jax_params)

from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_step import HEAD_ROWS, HYP, TINY, _batch

LR = (0.001, 0.002, 0.9)
B, SZ = 4, 64                  # the steps' global batch
UPDATES = [False, True]        # an accumulated step, then an update
ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]]
STRIDES = [8, 16, 32]
LOSS_HYP = {"box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0, "obj_pw": 1.0,
            "anchor_t": 4.0, "fl_gamma": 0.0, "label_smoothing": 0.1}
SEG_KINDS = ("ohem", "focal", "ce", "prob_ohem", "seg_ce_plain")


def _tiny(head):
    sp = json.loads(json.dumps(TINY))
    sp["head"][-2] = HEAD_ROWS[head]
    return sp


def _close(got, want, what, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _bn_inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 8, 5) * 3 + 2).astype(np.float32)
    return (x, rng.randn(*x.shape).astype(np.float32),
            (rng.rand(6) + 0.5).astype(np.float32), rng.randn(6).astype(np.float32))


def _det_inputs():
    """4 images, rank 0's two with 9 and 7 targets, rank 1's with 2 and 0."""
    rng = np.random.RandomState(3)
    preds = [rng.randn(4, 3, SZ // s, SZ // s, 8).astype(np.float32) for s in STRIDES]
    tgts = np.zeros((4, 10, 5), np.float32)
    tgts[:, :, 0] = rng.randint(0, 3, (4, 10))
    tgts[:, :, 1:3] = rng.rand(4, 10, 2) * 0.8 + 0.1
    tgts[:, :, 3:5] = rng.rand(4, 10, 2) * 0.4 + 0.05
    mask = np.arange(10)[None] < np.array([9, 7, 2, 0])[:, None]
    return preds, tgts, mask


def _seg_inputs(kind):
    rng = np.random.RandomState(11)
    h, w = (4, 6) if kind == "seg_ce_plain" else (16, 24)
    k = 8 if kind == "seg_ce_plain" else 1
    z = (rng.randn(4, h, w, 5) * 2).astype(np.float32)                 # NHWC
    y = rng.randint(0, 5, (4, h * k, w * k))
    y = np.where(rng.rand(*y.shape) < 0.2, -1, y).astype(np.int32)
    y[2:, : h * k // 2] = -1                                           # rank 1: fewer labels
    return z, y, (rng.rand(5) + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def jax_state():
    """The JAX train state of the TINY PSP spec, its weights for the port."""
    import jax.numpy as jnp
    from multiyolov5_tpu.models.config import load_spec as jax_load_spec
    from multiyolov5_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from multiyolov5_tpu.train.trainer import create_train_state as jax_create

    jspec = jax_load_spec(_tiny("SegMaskPSP"))
    jcfg = JaxTrainConfig(hyp=HYP, batch_size=B, seg_batch_size=B, compute_dtype=jnp.float32)
    ts0, groups = jax_create(jspec, jcfg, seed=0)
    return jspec, jcfg, ts0, groups, from_jax_params(ts0["params"], ts0["state"])


def _batches():
    return [_batch(100 + i, B=B, sz=SZ) for i in range(len(UPDATES))]


@pytest.fixture(scope="module")
def ranks2(jax_state, tmp_path_factory):
    """Every 2-rank job, in one launch; {job: [rank 0's, rank 1's]}."""
    sd = jax_state[4]
    x, grad, w, b = _bn_inputs()
    preds, tgts, mask = _det_inputs()
    base_sd = seeded_state_dict(load_spec(_tiny("SegMaskBase")), 0)
    ckpt = str(tmp_path_factory.mktemp("sharded") / "ck")
    jobs = [("bn_dp", dict(job="bn", x=x, grad=grad, weight=w, bias=b)),
            ("bn_sp", dict(job="bn", x=x, grad=grad, weight=w, bias=b, n_data=1, n_model=2)),
            ("halo_zero", dict(job="halo", x=x[:1], top=6, bottom=5, fill=0.0)),
            ("halo_inf", dict(job="halo", x=x[:1], top=2, bottom=2, fill=float("-inf"))),
            ("det_loss", dict(preds=preds, tgts=tgts, tmask=mask, nc=3, na=3,
                              anchors=np.asarray(ANCHORS, np.float32).reshape(3, 3, 2)
                              / np.asarray(STRIDES, np.float32)[:, None, None],
                              strides=STRIDES, hyp=LOSS_HYP))]
    for kind in SEG_KINDS:
        z, y, wv = _seg_inputs(kind)
        jobs.append((f"seg_{kind}", dict(job="seg_loss", logits=z.transpose(0, 3, 1, 2).copy(),
                                         labels=y, kind=kind, weight=wv)))
    step = dict(job="step", cfg_kw=dict(hyp=HYP, batch_size=B), batches=_batches(),
                updates=UPDATES, lr=LR)
    jobs += [("dp_step", dict(step, spec_dict=_tiny("SegMaskPSP"), sd=sd, n_data=2, n_model=1)),
             ("dropout_step", dict(step, spec_dict=_tiny("SegMaskBase"), sd=base_sd,
                                   n_data=2, n_model=1, seed=5)),
             ("ckpt_save", dict(job="sharded_ckpt", path=ckpt, tree=_tree())),
             ("ckpt_load", dict(job="sharded_ckpt", path=ckpt))]
    res = W.launch(2, jobs, tmp_path_factory.mktemp("ranks2"))
    return {name: [r[name] for r in res] for name, _ in jobs} | {"ckpt": ckpt}


def _spatial_sd(head):
    return seeded_state_dict(load_spec(_tiny(head)), 0)


def _frames(n):
    return (np.random.RandomState(4).rand(n, 128, 64, 3) * 255).astype(np.uint8)


def _tree():
    rng = np.random.RandomState(8)
    return {"params": {"a.weight": torch.from_numpy(rng.randn(4, 3, 3, 3).astype(np.float32)),
                       "b.running_var": torch.from_numpy(rng.rand(7))},
            "opt": {"t": torch.tensor(3)}, "updates": 12, "epoch": None, "spec_yaml": "{}"}


# ---------------------------------------------------------------------------
# The mesh's entry points, in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (0, 1), (1, 2), (1, 0)])
def test_make_mesh_raises_past_the_world(shape):
    with pytest.raises(ValueError, match="make_mesh"):
        pmesh.make_mesh(*shape)


def test_make_mesh_of_one_process():
    m = pmesh.make_mesh()
    assert (m.n_data, m.n_model, m.rank, m.data_index, m.model_index) == (1, 1, 0, 0, 0)
    assert m.world.size == m.data.size == m.model.size == 1


def test_backend_and_rank_device_on_the_cpu():
    """Without a card: gloo, and every rank on the CPU."""
    assert pmesh.choose_backend("cpu", 2) == "gloo"
    assert pmesh.rank_device("cpu", 1, 2) == torch.device("cpu")
    assert pmesh.initialize_distributed(None, 1, 0) is None      # one process: no group


@pytest.mark.parametrize("bs,n", [(8, 1), (7, 8), (8, 8), (9, 8), (1, 8), (6, 4)])
def test_round_batch_for_devices_matches_jax(bs, n):
    from multiyolov5_tpu.parallel.mesh import round_batch_for_devices

    assert pmesh.round_batch_for_devices(bs, n) == round_batch_for_devices(bs, n)


def test_shard_train_batch_slices_rows_then_h():
    batch = _batch(1, B=4, sz=64)
    mesh = pmesh.Mesh(2, 2, 3, *[pmesh.Group([3], 3)] * 3)   # rank 3: data 1, model 1
    det, tg, tm, seg, lb = pmesh.shard_train_batch(mesh, batch, 32)
    np.testing.assert_array_equal(det, batch[0][2:, 32:])
    np.testing.assert_array_equal(tg, batch[1][2:])
    np.testing.assert_array_equal(lb, batch[4][2:, 32:])
    np.testing.assert_array_equal(seg, batch[3][2:, 32:])


# ---------------------------------------------------------------------------
# Global-batch BN, the halo, the losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("job,axis", [("bn_dp", 0), ("bn_sp", 2)])
def test_global_bn_matches_one_bn(ranks2, job, axis):
    x, grad, w, b = _bn_inputs()
    bn = torch.nn.BatchNorm2d(6, eps=BN_EPS, momentum=BN_MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(grad)).sum().backward()
    r = ranks2[job]
    _close(torch.cat([q["y"] for q in r], axis), y.detach(), "y", 1e-5, 1e-6)
    _close(torch.cat([q["dx"] for q in r], axis), xt.grad, "dx", 1e-5, 1e-6)
    _close(r[0]["dw"] + r[1]["dw"], bn.weight.grad, "dweight", 1e-5, 1e-6)
    _close(r[0]["db"] + r[1]["db"], bn.bias.grad, "dbias", 1e-5, 1e-6)
    for q in r:
        _close(q["mean"], bn.running_mean, "running_mean", 1e-5, 1e-6)
        _close(q["var"], bn.running_var, "running_var (unbiased)", 1e-5, 1e-6)


@pytest.mark.parametrize("job,top,bottom,fill", [("halo_zero", 6, 5, 0.0),
                                                 ("halo_inf", 2, 2, float("-inf"))])
def test_halo_exchange_matches_the_padded_map(ranks2, job, top, bottom, fill):
    """Shards of 4 rows: the zero case's halos span two ranks and the map's edge."""
    full = torch.from_numpy(_bn_inputs()[0][:1]).requires_grad_(True)
    b, c, _, w = full.shape
    padded = torch.cat([torch.full((b, c, top, w), fill), full,
                        torch.full((b, c, bottom, w), fill)], 2)
    loss = 0
    for m, q in enumerate(ranks2[job]):
        want = padded[:, :, m * 4:m * 4 + 4 + top + bottom]
        assert torch.equal(q["y"], want.detach()), f"rank {m}"
        loss = loss + (want * torch.where(torch.isfinite(want), q["g"], 0.0)).sum()
    loss.backward()
    assert torch.equal(torch.cat([q["dx"] for q in ranks2[job]], 2), full.grad)


def test_detection_loss_global_batch_matches_jax(ranks2):
    """Unequal target counts a rank (16 and 2): n_pos, the objectness mean
    and B are the global batch's."""
    import jax
    import jax.numpy as jnp
    from multiyolov5_tpu.train import losses as JL

    preds, tgts, mask = _det_inputs()
    anchors = np.asarray(ANCHORS, np.float32).reshape(3, 3, 2) / np.asarray(
        STRIDES, np.float32)[:, None, None]
    jl = JL.DetectionLoss(nc=3, na=3, anchors=anchors, strides=STRIDES, hyp=LOSS_HYP)
    (jv, jitems), jgrads = jax.value_and_grad(
        lambda ps: jl(ps, jnp.asarray(tgts), jnp.asarray(mask)), has_aux=True)(
        [jnp.asarray(p) for p in preds])
    r = ranks2["det_loss"]
    np.testing.assert_allclose(float(r[0]["loss"] + r[1]["loss"]), float(jv), rtol=1e-5)
    for q in r:
        np.testing.assert_allclose(q["items"].numpy(), np.asarray(jitems), rtol=1e-5)
    for i, g in enumerate(jgrads):
        _close(torch.cat([q["grads"][i] for q in r]), g, f"dpred level {i}")


@pytest.mark.parametrize("kind", SEG_KINDS)
def test_seg_losses_global_batch_match_jax(ranks2, kind):
    """Rank 1 holds half rank 0's labels; OHEM's threshold and k come from
    the global pixel losses, K6's plain version divides by the global D."""
    import jax
    import jax.numpy as jnp
    from multiyolov5_tpu.ops.resize import resize_bilinear
    from multiyolov5_tpu.train import losses as JL

    z, y, wv = _seg_inputs(kind)
    yj, wj = jnp.asarray(y), jnp.asarray(wv)
    fn = {"ohem": lambda zz: JL.ohem_ce_loss(zz, yj),
          "focal": lambda zz: JL.seg_focal_loss(zz, yj),
          "ce": lambda zz: JL.cross_entropy_seg(zz, yj, wj),
          "prob_ohem": lambda zz: JL.prob_ohem_ce_loss(zz, yj, min_kept=64),
          "seg_ce_plain": lambda zz: JL.cross_entropy_seg(
              resize_bilinear(zz, y.shape[1:]), yj, wj)}[kind]
    jv, jg = jax.value_and_grad(fn)(jnp.asarray(z))
    r = ranks2[f"seg_{kind}"]
    np.testing.assert_allclose(float(r[0]["loss"] + r[1]["loss"]), float(jv), rtol=5e-5)
    _close(torch.cat([q["dz"] for q in r]).numpy().transpose(0, 2, 3, 1), jg, f"d{kind}")


# ---------------------------------------------------------------------------
# The steps and the spatial forward
# ---------------------------------------------------------------------------

def _jax_mesh_run(jax_state, n_data, n_model, batches=None):
    import jax
    import jax.numpy as jnp
    from multiyolov5_tpu.parallel.mesh import make_mesh, replicate, shard_train_batch
    from multiyolov5_tpu.train.trainer import make_train_step as jax_make_step

    jspec, jcfg, ts, groups, _ = jax_state
    mesh = make_mesh(n_data, n_model)
    step = jax_make_step(jspec, jcfg, groups, mesh=mesh, donate=False)
    ts = replicate(mesh, ts)
    out = []
    for i, (batch, up) in enumerate(zip(batches or _batches(), UPDATES)):
        args = shard_train_batch(mesh, tuple(jnp.asarray(a) for a in batch))
        ts, m = step(ts, *args, replicate(mesh, jax.random.PRNGKey(i)), *map(jnp.float32, LR),
                     jnp.asarray(up))
        out.append(m)
    return ts, out


def _held_states(got, want):
    """Port rank state (torch layout) against a JAX train state."""
    params, state = to_jax_params(got["state"])
    ema_params, ema_state = to_jax_params(got["ema"])
    for part, mine in (("params", params), ("state", state), ("ema_params", ema_params),
                       ("ema_state", ema_state)):
        assert set(mine) == set(want[part]), part
        for k, v in want[part].items():
            np.testing.assert_allclose(mine[k], np.asarray(v), rtol=2e-4, atol=5e-6,
                                       err_msg=f"{part}[{k}]")


def _ranks_equal(r):
    a, b = r[0], r[1]
    assert a["updates"] == b["updates"] == sum(UPDATES)
    for part in ("state", "ema"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part


def held_step(r, jax_state, n_data, n_model, batches=None):
    """A port step's ranks against the JAX step jitted over the same mesh
    shape (on ``batches``, default ``_batches()``)."""
    jts, jm = _jax_mesh_run(jax_state, n_data, n_model, batches)
    _ranks_equal(r)
    for got, want in zip(r[0]["metrics"], jm):
        for k in ("total", "seg_loss", "det_items"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       err_msg=k)
    assert r[0]["updates"] == int(jts["updates"])
    _held_states(r[0], jts)


def test_dp_step_matches_jax_mesh_step(ranks2, jax_state):
    """The (2, 1) step: global-batch BN, the global loss normalisers and
    K6's plain version with the global D."""
    held_step(ranks2["dp_step"], jax_state, 2, 1)


def test_dropout_is_drawn_for_the_global_batch(ranks2):
    """The Base head's dropout under a seeded generator: 2 ranks give the
    one-process step."""
    spec = load_spec(_tiny("SegMaskBase"))
    cfg = TrainConfig(hyp=HYP, batch_size=B, compute_dtype=torch.float32)
    ts, groups = create_train_state(spec, cfg, state_dict=_spatial_sd("SegMaskBase"),
                                    device="cpu")
    step = make_train_step(spec, cfg, groups)
    gen = torch.Generator().manual_seed(5)
    ms = []
    for batch, up in zip(_batches(), UPDATES):
        ts, m = step(ts, *batch, *LR, up, rng=gen)
        ms.append(m)
    r = ranks2["dropout_step"]
    _ranks_equal(r)
    for got, want in zip(r[0]["metrics"], ms):
        np.testing.assert_allclose(got["total"].numpy(), want["total"].numpy(), rtol=1e-5)
    for part, want in (("state", ts.state_dict()), ("ema", ts.ema)):
        for k, v in want.items():
            np.testing.assert_allclose(r[0][part][k].numpy(), v.numpy(), rtol=2e-4, atol=5e-6,
                                       err_msg=f"{part}[{k}]")


# ---------------------------------------------------------------------------
# Sharded checkpoints
# ---------------------------------------------------------------------------

def _tree_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _tree_equal(got[k], v)
        elif isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_sharded_checkpoint_two_ranks_to_any(ranks2):
    """Written by 2 ranks, read back by 2 and by this one process."""
    for q in ranks2["ckpt_load"]:
        _tree_equal(q, _tree())
    _tree_equal(load_sharded(ranks2["ckpt"]), _tree())


def test_sharded_checkpoint_one_process(tmp_path):
    save_sharded(str(tmp_path / "ck"), _tree())
    _tree_equal(load_sharded(str(tmp_path / "ck")), _tree())
