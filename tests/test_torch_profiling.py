"""The port's profiling (multiyolov5_tpu_torch/utils/profiling.py) against the
JAX package's (multiyolov5_tpu/utils/profiling.py), on the CPU.

``estimate_gflops`` runs the port's plain network on the ``meta`` device
under ``FlopCounterMode``; the JAX one traces its forward under
``eval_shape`` with a MAC counter, which the Focus conv never reaches
(multiyolov5_tpu/models/blocks.py:415 does not call ``_add_macs``).  So the
port must read the JAX count plus the Focus conv's 2 x MACs, exactly
(ratio 1 +- 1e-12): tests/test_export.py's TINY at 64, det-only yolov5s at
640 and pspv5s at 512x1024, against the JAX count from raw weights and from
its ``Engine``'s folded ones alike (the port's count reads no weights).
Det-only yolov5s at 640 must lie in [16.9, 17.1] GF (the reference's thop
reads 17.0), pspv5s at 512x1024 is pinned at 29,699,817,472 FLOPs.
``model_info``'s layers and parameters equal the JAX ``model_info``'s on
the same weights, raw and folded.  ``profile_layers`` gives one row a spec
row with non-negative times, and ``profile_op`` a positive time.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import init_model
from multiyolov5_tpu.utils import profiling as jax_profiling
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import Model, seeded_state_dict
from multiyolov5_tpu_torch.utils import profiling
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params
from test_export import TINY


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module's tests run: the tiny networks'
    many small ops gain nothing from more, and with more every op waits on
    all its threads wherever other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {"tiny_64": (TINY, 64), "yolov5s_640": ("yolov5s", 640),
         "pspv5s_512x1024": ("yolov5s_city_seg", (512, 1024))}
PSPV5S_FLOPS = 28_793_847_808 + 905_969_664     # JAX's count + the Focus conv's


def _focus_flops(spec, img_size) -> int:
    """2 x MACs of row 0's conv (args c1, c2, k): k x k x 4 c1 -> c2 at H/2 x W/2."""
    h, w = (img_size, img_size) if isinstance(img_size, int) else img_size
    row = spec.rows[0]
    assert row.module == "Focus"
    c1, c2, k = row.args[:3]
    return 2 * k * k * 4 * c1 * c2 * (h // 2) * (w // 2)


@pytest.fixture(scope="module")
def jax_counts():
    """The JAX count a case, from raw params and from its Engine's folded ones."""
    out = {}
    for name, (cfg, size) in CASES.items():
        spec = jax_load_spec(cfg)
        params, state = init_model(spec)
        out[name, False] = jax_profiling.estimate_gflops(spec, params, size, state=state) * 1e9
        folded = JaxEngine(spec=spec, params=params, state=state, half=False).params
        assert not any(k.endswith(".bn.weight") for k in folded)
        out[name, True] = jax_profiling.estimate_gflops(spec, folded, size) * 1e9
    return out


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("case", list(CASES))
def test_flops_equal_jax_plus_focus(jax_counts, case, folded):
    cfg, size = CASES[case]
    spec = load_spec(cfg)
    got = profiling.estimate_gflops(spec, None, size) * 1e9
    want = jax_counts[case, folded] + _focus_flops(spec, size)
    assert abs(got / want - 1) <= 1e-12, (got, want)
    if case == "yolov5s_640":
        assert 16.9e9 <= got <= 17.1e9
    if case == "pspv5s_512x1024":
        assert abs(got / PSPV5S_FLOPS - 1) <= 1e-12


@pytest.mark.parametrize("folded", [False, True], ids=["raw", "folded"])
@pytest.mark.parametrize("cfg", [TINY, "yolov5s_city_seg"], ids=["tiny", "pspv5s"])
def test_model_info_matches_jax(cfg, folded):
    spec = jax_load_spec(cfg)
    params, state = init_model(spec, seed=0)
    if folded:
        jparams = JaxEngine(spec=spec, params=params, state=state, half=False).params
        sd = Engine(spec=load_spec(cfg), state_dict=from_jax_params(params, state),
                    device="cpu", half=False).model.state_dict()
    else:
        jparams, sd = params, from_jax_params(params, state)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        want = jax_profiling.model_info(spec, jparams, img_size=64)
        got = profiling.model_info(load_spec(cfg), sd, img_size=64)
    assert (got["layers"], got["parameters"]) == (want["layers"], want["parameters"])
    lines = out.getvalue().splitlines()
    assert lines[0].split("parameters")[0] == lines[1].split("parameters")[0]


def test_profile_layers_and_op_on_cpu():
    spec = load_spec(TINY)
    model = Model(spec, fused=False)
    model.load_state_dict(seeded_state_dict(spec, 0))
    model.eval()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = profiling.profile_layers(model, img_hw=(64, 96), batch=2, repeats=2)
        dt = profiling.profile_op(lambda x: model(x), torch.zeros(1, 3, 64, 64), n=2)
    assert [r[:2] for r in rows] == [(row.i, row.module) for row in spec.rows]
    assert all(r[3] >= 0 for r in rows) and dt > 0
    cums = [r[2] for r in rows]
    np.testing.assert_allclose(np.diff(cums), [r[3] for r in rows[1:]], rtol=1e-9, atol=1e-12)
