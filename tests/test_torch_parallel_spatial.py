"""The port's spatial (H-axis) parallelism against the JAX package's, on the
CPU in float32: ``spatial_forward`` and the dp x sp train step, the port's
ranks spawned over gloo as in tests/test_torch_parallel.py (whose helpers
and inputs this file shares), the JAX package on its virtual CPU mesh.

Bounds:
  * ``spatial_forward`` at n_model 2 for every seg head (PSP, Lab, Base,
    BiSe) and the detection-only network, and at (2, 2) for PSP and Lab (at
    (2, 2) the 1/16 map's shards are 4 rows, so ASPP's dilation-9 halo
    reaches past the next rank; SPP's k13 pool reaches 6 rows past the 1/32
    map's 2-row shards), replicated on every rank, against the JAX
    ``spatial_forward`` on the same mesh shape: rtol 1e-4 (as
    tests/test_spatial.py:110-111) with an absolute term of 1e-4 of the
    output's scale (the largest |logit|, the largest box coordinate).
    tests/test_spatial.py's 1e-5 absolute holds the JAX package against
    itself at its init's small outputs; across the two frameworks, at
    weights with measured BN statistics (logits up to ~10), float32
    summation order alone moves the logits by up to 6e-5 (read: JAX's own
    sharded forward is 3.7e-5 off its unsharded one here);
  * the dp1 x sp2 step (sharded forwards, gathered outputs, the plain seg
    loss at 1/2 a rank) against the JAX step on ``make_mesh(1, 2)``:
    tests/test_torch_parallel.py's step bounds.

Every row type at any H (``ANY_H``), at n_model 2 against the JAX
``spatial_forward`` under the same bounds: the hub's yolov3-tiny (a zero
pad and a stride-1 max pool across rows) and yolov5s-transformer (C3TR
on the gathered map), narrowed to width 0.25, and pspv5s
(``yolov5s_city_seg``) at width 0.125, each at H = 96 (3 units of the
largest stride: 64 + 32 rows, where GSPMD splits 48 + 48); the TINY PSP
spec at H = 32 (1 unit: the second rank holds no rows and computes a
copy of the first's); and the dp1 x sp2 step on 96 x 64 batches (64 + 32
rows) against the JAX step under the step bounds, for the TINY PSP spec
and, through the rows that reach across shards (``STEP_ROWS``: C3TR's
gathered map, whose gradient sums back into each rank's rows, the zero
pad's rows on the last rank and the max pool's ``-inf`` halo), for the
narrowed yolov3-tiny and yolov5s-transformer from their JAX inits
(yolov3-tiny against the JAX step on one device: see ``STEP_ROWS``).
"""

import json
import os

import numpy as np
import pytest

import _torch_parallel_worker as W
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import seeded_state_dict
from test_torch_parallel import (B, HYP, LR, UPDATES, _batches, _frames, _tiny, held_step,
                                 jax_state)  # noqa: F401 (fixture)
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params
from test_torch_train_step import _batch
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

# every head at (1, 2), the detection-only network too; PSP and Lab at (2, 2)
HEADS = ("SegMaskPSP", "SegMaskLab", "SegMaskBase", "SegMaskBiSe", "det")
WIDE = ("SegMaskPSP", "SegMaskLab")
SPATIAL = [(h, 1, 2) for h in HEADS] + [(h, 2, 2) for h in WIDE]


HUB = "multiyolov5_tpu_torch/models/hub/{}.yaml"
# name: (spec, H) at n_model 2 and W 64
ANY_H = {"yolov3-tiny": ("yolov3-tiny", 96), "yolov5s-transformer": ("yolov5s-transformer", 96),
         "pspv5s": ("yolov5s_city_seg", 96), "k_below_ranks": ("SegMaskPSP", 32)}
# the dp1 x sp2 step at H 96 through the rows that reach across shards:
# name -> the JAX mesh (n_data, n_model) whose step it is held against.
# The JAX package's own (1, 2) step of yolov3-tiny is off its one-device
# step by about one update (4e-4 in the first conv's weights at H 96 and
# 128, where its (2, 1) step is 1.5e-8 off; ROADMAP.md §3), so yolov3-tiny
# is held against the JAX step on one device, the function GSPMD defines
STEP_ROWS = {"yolov3-tiny": (1, 1), "yolov5s-transformer": (1, 2)}


def _any_h_spec(name):
    cfg, _ = ANY_H[name]
    if cfg in HEADS:
        return _spec(cfg)
    path = HUB.format(cfg)
    return dict(load_spec(path if os.path.exists(path) else cfg).yaml,
                width_multiple=0.125 if cfg == "yolov5s_city_seg" else 0.25)


def _frames_h(h, n=1):
    return (np.random.RandomState(5).rand(n, h, 64, 3) * 255).astype(np.uint8)


def _rect_batches(h=96, w=64):
    """``_batches()``'s draws at B x h x h, cut to width ``w``."""
    out = []
    for i in range(len(UPDATES)):
        imgs, tgts, mask, seg_imgs, seg_lbls = _batch(100 + i, B=B, sz=h)
        out.append((imgs[:, :, :w], tgts, mask, seg_imgs[:, :, :w], seg_lbls[:, :, :w]))
    return out


def _spec(head):
    """TINY with ``head``'s seg row, or without one ("det")."""
    if head != "det":
        return _tiny(head)
    sp = json.loads(json.dumps(_tiny("SegMaskPSP")))
    del sp["head"][-2], sp["n_segcls"]
    return sp


def _sd(head):
    return seeded_state_dict(load_spec(_spec(head)), 0)


def _spatial_jobs(heads, n_data, n_model):
    return [(f"spatial_{h}", dict(job="spatial", spec_dict=_spec(h), sd=_sd(h),
                                  x=_frames(n_data), n_data=n_data, n_model=n_model))
            for h in heads]


def _any_h_jobs():
    return [(f"any_h_{k}", dict(job="spatial", spec_dict=_any_h_spec(k),
                                sd=seeded_state_dict(load_spec(_any_h_spec(k)), 0),
                                x=_frames_h(h), n_data=1, n_model=2))
            for k, (_, h) in ANY_H.items()]


@pytest.fixture(scope="module")
def jax_row_states():
    """``jax_state`` for each of STEP_ROWS' narrowed specs."""
    import jax.numpy as jnp
    from multiyolov5_tpu.models.config import load_spec as jax_load_spec
    from multiyolov5_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from multiyolov5_tpu.train.trainer import create_train_state as jax_create

    out = {}
    for name in STEP_ROWS:
        jspec = jax_load_spec(_any_h_spec(name))
        jcfg = JaxTrainConfig(hyp=HYP, batch_size=B, seg_batch_size=B,
                              compute_dtype=jnp.float32)
        ts0, groups = jax_create(jspec, jcfg, seed=0)
        out[name] = (jspec, jcfg, ts0, groups, from_jax_params(ts0["params"], ts0["state"]))
    return out


@pytest.fixture(scope="module")
def ranks2(jax_state, jax_row_states, tmp_path_factory):
    """The (1, 2) jobs in one launch; {job: [rank 0's, rank 1's]}."""
    step = dict(job="step", spec_dict=_tiny("SegMaskPSP"), sd=jax_state[4],
                cfg_kw=dict(hyp=HYP, batch_size=B), updates=UPDATES, lr=LR, n_data=1,
                n_model=2)
    jobs = _spatial_jobs(HEADS, 1, 2) + _any_h_jobs() + [
        ("sp_step", dict(step, batches=_batches())),
        ("sp_step_uneven", dict(step, batches=_rect_batches()))] + [
        (f"sp_step_{k}", dict(step, spec_dict=_any_h_spec(k), sd=jax_row_states[k][4],
                              batches=_rect_batches())) for k in STEP_ROWS]
    res = W.launch(2, jobs, tmp_path_factory.mktemp("ranks2"))
    return {name: [r[name] for r in res] for name, _ in jobs}


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    jobs = _spatial_jobs(WIDE, 2, 2)
    res = W.launch(4, jobs, tmp_path_factory.mktemp("ranks4"))
    return {name: [r[name] for r in res] for name, _ in jobs}


@pytest.mark.parametrize("head,n_data,n_model", SPATIAL)
def test_spatial_forward_matches_jax(request, head, n_data, n_model):
    import jax.numpy as jnp
    from multiyolov5_tpu.models.config import load_spec as jax_load_spec
    from multiyolov5_tpu.parallel.mesh import make_mesh
    from multiyolov5_tpu.parallel.spatial import spatial_forward, spatial_sharding_ok
    from multiyolov5_tpu_torch.utils.checkpoint import to_jax_params

    assert spatial_sharding_ok(_frames(1).shape[1], n_model)
    params, state = to_jax_params(_sd(head))
    # unfused weights: the port folds them itself (its fused=True)
    fn = spatial_forward(jax_load_spec(_spec(head)), params, state, make_mesh(n_data, n_model),
                         compute_dtype=jnp.float32, fused=False)
    z, seg = fn(jnp.asarray(_frames(n_data)))
    z = np.asarray(z).transpose(0, 2, 1)
    r = request.getfixturevalue("ranks4" if n_data > 1 else "ranks2")[f"spatial_{head}"]
    assert len(r) == n_data * n_model
    for q in r:                                  # replicated on every rank
        assert q["det"].shape == z.shape
        box = np.abs(z[:, :4]).max()
        np.testing.assert_allclose(q["det"][:, :4], z[:, :4], rtol=1e-4, atol=1e-4 * box,
                                   err_msg="boxes")
        np.testing.assert_allclose(q["det"][:, 4:], z[:, 4:], rtol=1e-4, atol=1e-4,
                                   err_msg="scores")
        if seg is None:
            assert q["seg"] is None
            continue
        seg_j = np.asarray(seg).transpose(0, 3, 1, 2)
        assert q["seg"].shape == seg_j.shape
        np.testing.assert_allclose(q["seg"], seg_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(seg_j).max(), err_msg="seg logits")


def _held_against_jax(r, spec_dict, x, n_data, n_model):
    """Each rank's replicated ``spatial_forward`` outputs against the JAX
    ``spatial_forward`` on the same mesh shape, under the file's bounds."""
    import jax.numpy as jnp
    from multiyolov5_tpu.models.config import load_spec as jax_load_spec
    from multiyolov5_tpu.parallel.mesh import make_mesh
    from multiyolov5_tpu.parallel.spatial import spatial_forward
    from multiyolov5_tpu_torch.utils.checkpoint import to_jax_params

    params, state = to_jax_params(seeded_state_dict(load_spec(spec_dict), 0))
    fn = spatial_forward(jax_load_spec(spec_dict), params, state, make_mesh(n_data, n_model),
                         compute_dtype=jnp.float32, fused=False)
    z, seg = fn(jnp.asarray(x))
    z = np.asarray(z).transpose(0, 2, 1)
    assert len(r) == n_data * n_model
    for q in r:
        assert q["det"].shape == z.shape
        box = np.abs(z[:, :4]).max()
        np.testing.assert_allclose(q["det"][:, :4], z[:, :4], rtol=1e-4, atol=1e-4 * box,
                                   err_msg="boxes")
        np.testing.assert_allclose(q["det"][:, 4:], z[:, 4:], rtol=1e-4, atol=1e-4,
                                   err_msg="scores")
        if seg is None:
            assert q["seg"] is None
            continue
        seg_j = np.asarray(seg).transpose(0, 3, 1, 2)
        assert q["seg"].shape == seg_j.shape
        np.testing.assert_allclose(q["seg"], seg_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(seg_j).max(), err_msg="seg logits")


@pytest.mark.parametrize("name", list(ANY_H))
def test_spatial_forward_any_row_type_any_h_matches_jax(ranks2, name):
    from multiyolov5_tpu_torch.parallel.mesh import split_rows
    from multiyolov5_tpu_torch.parallel.spatial import spatial_sharding_ok

    h = ANY_H[name][1]
    assert not spatial_sharding_ok(h, 2)                   # the shards are uneven
    assert split_rows(h, 2, 32) == ((64, 32) if h == 96 else (32, 0))
    _held_against_jax(ranks2[f"any_h_{name}"], _any_h_spec(name), _frames_h(h), 1, 2)


def test_sp_step_matches_jax_mesh_step(ranks2, jax_state):
    held_step(ranks2["sp_step"], jax_state, 1, 2)


def test_sp_step_at_uneven_h_matches_jax_mesh_step(ranks2, jax_state):
    """The dp1 x sp2 step on 96-row batches: the ranks hold 64 and 32 rows."""
    held_step(ranks2["sp_step_uneven"], jax_state, 1, 2, _rect_batches())


@pytest.mark.parametrize("name", STEP_ROWS)
def test_sp_step_through_rows_across_shards_matches_jax_mesh_step(ranks2, jax_row_states,
                                                                   name):
    """The dp1 x sp2 step of the narrowed yolov3-tiny (zero pad, stride-1
    max pool) and yolov5s-transformer (C3TR on the gathered map) on 96-row
    batches (64 + 32 rows): their weight gradients are counted once."""
    held_step(ranks2[f"sp_step_{name}"], jax_row_states[name], *STEP_ROWS[name],
              _rect_batches())
