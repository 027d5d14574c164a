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
"""

import json

import numpy as np
import pytest

import _torch_parallel_worker as W
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import seeded_state_dict
from test_torch_parallel import (B, HYP, LR, UPDATES, _batches, _frames, _tiny, held_step,
                                 jax_state)  # noqa: F401 (fixture)
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

# every head at (1, 2), the detection-only network too; PSP and Lab at (2, 2)
HEADS = ("SegMaskPSP", "SegMaskLab", "SegMaskBase", "SegMaskBiSe", "det")
WIDE = ("SegMaskPSP", "SegMaskLab")
SPATIAL = [(h, 1, 2) for h in HEADS] + [(h, 2, 2) for h in WIDE]


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


@pytest.fixture(scope="module")
def ranks2(jax_state, tmp_path_factory):
    """The (1, 2) jobs in one launch; {job: [rank 0's, rank 1's]}."""
    jobs = _spatial_jobs(HEADS, 1, 2) + [
        ("sp_step", dict(job="step", spec_dict=_tiny("SegMaskPSP"), sd=jax_state[4],
                         cfg_kw=dict(hyp=HYP, batch_size=B), batches=_batches(),
                         updates=UPDATES, lr=LR, n_data=1, n_model=2))]
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


def test_sp_step_matches_jax_mesh_step(ranks2, jax_state):
    held_step(ranks2["sp_step"], jax_state, 1, 2)
