"""The port's optimizer updates, EMA and schedules against the JAX
package's, on the CPU in float32.

Seeded params of the three groups (BN gains, weights with decay, biases)
go through two SGD (nesterov) and two Adam steps on both sides.  Bounds:
1e-6 relative + 1e-7 absolute on params and optimizer state (the same
float32 operations in the same order; a fused multiply-add may round once
where JAX rounds twice).  The EMA decay is float64 here and float32 there
(2e-4 relative at one update, where float32's 1 - exp(-u/2000) cancels).
The schedules are host float math and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.train import optim as JO
from multiyolov5_tpu_torch.train import optim as PO
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)


def _params(seed):
    rng = np.random.RandomState(seed)
    params = {"m.0.conv.weight": rng.randn(8, 4, 3, 3), "m.0.bn.weight": rng.rand(8) + 0.5,
              "m.0.bn.bias": rng.randn(8), "m.1.weight": rng.randn(6, 8, 1, 1),
              "m.1.bias": rng.randn(6)}
    state = {"m.0.bn.running_mean": rng.randn(8), "m.0.bn.running_var": rng.rand(8) + 0.5}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]
    return params, state, grads


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7,
                               err_msg=what)


def test_classify_params_matches_jax():
    params, state, _ = _params(0)
    groups = PO.classify_params(params, state)
    assert groups == JO.classify_params(params, state)
    assert sorted(groups.values()) == [0, 1, 1, 2, 2]


@pytest.mark.parametrize("adam", [False, True], ids=["sgd", "adam"])
def test_update_matches_jax(adam):
    params, state, grads = _params(1)
    groups = JO.classify_params(params, state)
    names = list(params)
    lr, lr_bias, mom, wd = 0.01, 0.05, 0.9, 5e-4
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = [torch.from_numpy(params[k].copy()) for k in names]
    if adam:
        jst = JO.init_adam_state(params)
        m = [torch.zeros_like(p) for p in pp]
        v = [torch.zeros_like(p) for p in pp]
    else:
        jst = JO.init_sgd_state(params)
        bufs = [torch.zeros_like(p) for p in pp]
    for t, g in enumerate(grads, start=1):
        jg = {k: jnp.asarray(x) for k, x in g.items()}
        pg = [torch.from_numpy(g[k]) for k in names]
        if adam:
            jp, jst = JO.adam_update(jp, jg, jst, groups, lr, lr_bias, mom, wd)
            PO.adam_update(names, pp, pg, m, v, t, groups, lr, lr_bias, mom, wd)
        else:
            jp, jst = JO.sgd_update(jp, jg, jst, groups, lr, lr_bias, mom, wd)
            PO.sgd_update(names, pp, pg, bufs, groups, lr, lr_bias, mom, wd)
        for k, p in zip(names, pp):
            _close(p.numpy(), jp[k], f"step {t} {k}")
    for k, i in zip(names, range(len(names))):
        if adam:
            _close(m[i].numpy(), jst[0][k], f"m {k}")
            _close(v[i].numpy(), jst[1][k], f"v {k}")
        else:
            _close(bufs[i].numpy(), jst[k], f"buf {k}")


@pytest.mark.parametrize("updates", [1, 37, 5000])
def test_ema_matches_jax(updates):
    params, state, grads = _params(2)
    ema = {**params, **state, "count": np.asarray(3, np.int32)}
    new = {k: v + g for k, v, g in zip(params, params.values(), grads[0].values())}
    new.update({k: v * 1.5 for k, v in state.items()}, count=np.asarray(4, np.int32))
    d = JO.ema_decay(jnp.asarray(updates))
    want = JO.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                         {k: jnp.asarray(v) for k, v in new.items()}, d)
    pd = PO.ema_decay(updates)
    # JAX's float32 1 - exp(-u/2000) cancels: one ulp of exp is 1.2e-4 of d at u = 1
    np.testing.assert_allclose(pd, float(d), rtol=2e-4)
    got = {k: torch.from_numpy(np.array(v)) for k, v in ema.items()}
    PO.ema_update(got, {k: torch.from_numpy(np.array(v)) for k, v in new.items()}, pd)
    for k in want:
        _close(got[k].numpy(), want[k], k)
    assert int(got["count"]) == 4


def test_schedules_match_jax():
    kw = dict(lr0=0.0015, lrf=0.2, epochs=30, warmup_iters=50)
    for linear in (False, True):
        js, ps = JO.WarmupCosine(**kw, linear=linear), PO.WarmupCosine(**kw, linear=linear)
        for ni, epoch in [(0, 0), (1, 0), (25, 0), (50, 1), (51, 1), (400, 17), (900, 29)]:
            assert ps.at(ni, epoch) == js.at(ni, epoch)
            for nbs, bs in ((64, 8), (64, 16), (64, 48), (64, 128)):
                assert ps.accumulate_at(ni, nbs, bs) == js.accumulate_at(ni, nbs, bs)
