"""The model DSL's row types in the port against the JAX package, on the CPU
in float32.

``compile_spec``: the port's spec equals the JAX one row for row (``i, f,
n, module, args, c1, c2, stride``), with equal ``save``, ``strides``,
``anchors``, ``detect_index`` and ``seg_index``, on the six hub configs
(``multiyolov5_tpu_torch/models/hub``, read by both packages'
``load_spec``), tests/test_metrics_aux.py's MaxPool / stride-4 case, an
``anchors: 3`` config and tests/test_ops.py's BottleneckCSP config.

Each row type's module (``models/model._build_row``) against the JAX
row function (``multiyolov5_tpu/models/model._apply_row``, which calls the
block's function) on the JAX ``init_model`` weights, with every BN's gain,
shift and statistics and every zero bias redrawn from a seed, so that no
BN is an identity: the unfused module in eval mode, the folded one (each
side's ``fuse_conv_bn``; the JAX state keeps only the BNs no conv absorbs,
as its ``Engine`` keeps them), and, for every module with a BN, the
unfused module in training mode, whose updated running statistics are held
against the JAX ``ctx.new_state``.  ``Sum`` (no config of the reference's
DSL compiles it: a list ``from`` reaches ``ch[f]``), DAPPM, RFB1 and ASPPs
(no row builds them) are held against their JAX block functions the same
way.  Bounds: outputs within 1e-5 of max(1, max |JAX output|), running
statistics within 1e-5 of max(1, max |JAX statistic|): float32 rounding
through at most a dozen convs, the transformer's softmax and the BN
moments (E[x^2] - mean^2 there, torch's own here).  In a forward whose H
axis is split unevenly over two ranks (threads of this process), ZeroPad2d,
max pools reaching across rows and C3TR no longer raise: their gathered
outputs equal the unsharded row's (the pad and the pools exactly, C3TR
within 1e-5), and so do bilinear and bicubic ``nn.Upsample`` rows, which
read rows across the shards' edge (the gathered map, exactly); only a
window op whose stride the shards' rows do not align with raises.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.models import blocks as JB
from multiyolov5_tpu.models.config import compile_spec as jax_compile_spec
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.models.model import _apply_row, init_model
from multiyolov5_tpu.ops.nn import Ctx, Initializer
from multiyolov5_tpu.ops.nn import fuse_conv_bn as jax_fuse
from multiyolov5_tpu_torch.models import blocks as B
from multiyolov5_tpu_torch.models.config import HUB_DIR, compile_spec, hub_configs, load_spec
from multiyolov5_tpu_torch.models.model import _build_row
from multiyolov5_tpu_torch.ops.nn import fuse_conv_bn
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params

from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

OUT_REL = 1e-5
STAT_REL = 1e-5
ANCHORS = [[10, 13, 16, 30, 33, 23]]


def _det(backbone, head=(), nc=2, anchors=ANCHORS):
    return {"nc": nc, "depth_multiple": 1.0, "width_multiple": 1.0, "anchors": anchors,
            "backbone": [list(r) for r in backbone], "head": [list(r) for r in head]}


SPEC_CASES = {
    **{name: os.path.join(HUB_DIR, f"{name}.yaml") for name in hub_configs()},
    # tests/test_metrics_aux.py:190-203: MaxPool's default stride and a stride-4 conv
    "maxpool_stride4": _det([[-1, 1, "Conv", [32, 3, 4]], [-1, 1, "nn.MaxPool2d", [2]]],
                            [[[1], 1, "Detect", ["nc", "anchors"]]]),
    # 'anchors: 3': three placeholder anchors a level
    "anchors_3": {**_det([[-1, 1, "Focus", [16, 3]], [-1, 1, "Conv", [32, 3, 2]],
                          [-1, 1, "Conv", [64, 3, 2]]],
                         [[[1, 2], 1, "Detect", ["nc", "anchors"]]]), "anchors": 3},
    # tests/test_ops.py:129-141
    "bottleneck_csp": _det([[-1, 1, "Focus", [16, 3]], [-1, 1, "Conv", [32, 3, 2]],
                            [-1, 1, "BottleneckCSP", [32]]],
                           [[[2], 1, "Detect", ["nc", "anchors"]]]),
}


def _rows(spec):
    return [(r.i, r.f, r.n, r.module, r.args, r.c1, r.c2, r.stride) for r in spec.rows]


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_compile_spec_matches_jax(case):
    cfg = SPEC_CASES[case]
    want = jax_load_spec(cfg) if isinstance(cfg, str) else jax_compile_spec(cfg)
    got = load_spec(cfg) if isinstance(cfg, str) else compile_spec(cfg)
    assert _rows(got) == _rows(want)
    assert got.save == want.save and got.strides == want.strides
    assert got.anchors == want.anchors and got.yaml["anchors"] == want.yaml["anchors"]
    assert (got.detect_index, got.seg_index) == (want.detect_index, want.seg_index)
    assert got.nc == want.nc and got.na == want.na and got.names == want.names
    if isinstance(cfg, str):
        assert load_spec(os.path.basename(cfg)[:-5]).yaml == got.yaml   # by its name
    if case == "anchors_3":
        assert got.anchors == [list(range(6))] * 2 and got.strides == [4, 8]
    if case == "maxpool_stride4":
        assert got.strides == [8]


# row type -> (rows of a config whose last row is the one under test, input
# channels).  Depth 1.0, width 1.0: the counts and widths are the rows' own.
ROW_CASES = {
    "conv_k3_s2": ([[-1, 1, "Conv", [16, 3, 2]]], 8),
    "conv_repeated": ([[-1, 3, "Conv", [16, 3, 1]]], 16),
    "conv_list_kernel": ([[-1, 1, "Conv", [16, [1, 1]]]], 8),
    "conv_groups": ([[-1, 1, "Conv", [16, 3, 1, None, 4]]], 8),
    "dwconv": ([[-1, 1, "DWConv", [16, 3, 2]]], 8),
    "bottleneck_repeated": ([[-1, 2, "Bottleneck", [16]]], 16),
    "bottleneck_no_shortcut": ([[-1, 1, "Bottleneck", [16, False]]], 16),
    "bottleneck_csp": ([[-1, 2, "BottleneckCSP", [16]]], 8),
    "bottleneck_csp_no_shortcut": ([[-1, 1, "BottleneckCSP", [16, False]]], 16),
    "c3tr": ([[-1, 2, "C3TR", [32]]], 16),
    "aspp": ([[-1, 1, "ASPP", [16]]], 32),
    "ghost_conv": ([[-1, 1, "GhostConv", [16, 3, 2]]], 8),
    "ghost_bottleneck_s1": ([[-1, 1, "GhostBottleneck", [16, 3, 1]]], 16),
    "ghost_bottleneck_s2": ([[-1, 1, "GhostBottleneck", [32, 3, 2]]], 16),
    "cross_conv": ([[-1, 1, "CrossConv", [16, 3, 1, 1, 1.0, True]]], 16),
    "mixconv2d": ([[-1, 1, "MixConv2d", [16, [1, 3, 5], 1]]], 16),
    "classify": ([[-1, 1, "Classify", [16, 10, 3]]], 16),
    "batchnorm2d": ([[-1, 1, "nn.BatchNorm2d", [16]]], 16),
    "maxpool_k3_s2_p1": ([[-1, 1, "nn.MaxPool2d", [3, 2, 1]]], 8),
    "maxpool_default_stride": ([[-1, 1, "nn.MaxPool2d", [2]]], 8),
    "zeropad_ltrb": ([[-1, 1, "nn.ZeroPad2d", [[0, 1, 2, 3]]]], 8),
    "zeropad_int": ([[-1, 1, "nn.ZeroPad2d", [1]]], 8),
    "contract": ([[-1, 1, "Contract", [2]]], 8),
    "expand": ([[-1, 1, "Expand", [2]]], 16),
}


def _perturb(params, state, seed):
    """BN gains, shifts and statistics, and the biases the init leaves at 0
    (the attention's in-projection), redrawn from ``seed``."""
    rng = np.random.RandomState(seed)
    params, state = dict(params), dict(state)
    for k in state:
        if k.endswith(".running_mean"):
            bn = k[:-len(".running_mean")]
            c = state[k].shape[0]
            state[k] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
            state[bn + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            params[bn + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            params[bn + ".bias"] = rng.uniform(-0.3, 0.3, c).astype(np.float32)
    for k, v in params.items():
        if k.endswith("bias") and not np.any(v):
            params[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
    return params, state


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _close(got, want, rel, what):
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), f"{what}: {err:.3e}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _port_out(y):
    y = y.detach().numpy()
    return y if y.ndim == 2 else y.transpose(0, 2, 3, 1)


def _hold(module, run_jax, x, params, state, prefix, fused):
    """``module`` (its weights from ``params``/``state`` under ``prefix``)
    against ``run_jax(ctx, x)``: eval, and in training mode (unfused, with a
    BN) the output and the updated statistics."""
    sd = from_jax_params(params, state)
    jp, js = params, state
    if fused:
        jp = jax_fuse(params, state)
        js = {k: v for k, v in state.items()
              if "running_" not in k or k.rsplit(".running_", 1)[0] + ".weight" in jp}
        sd = fuse_conv_bn(sd)
    module.load_state_dict(_sub(sd, prefix), strict=True)
    xs = x if isinstance(x, list) else [x]
    xt = [_nchw(t) for t in xs]
    xj = [jnp.asarray(t) for t in xs]
    arg_t, arg_j = (xt, xj) if isinstance(x, list) else (xt[0], xj[0])
    module.eval()
    with torch.no_grad():
        got = module(arg_t)
    _close(_port_out(got), run_jax(Ctx(p=jp, s=js, train=False, fused=fused), arg_j),
           OUT_REL, "eval")
    bns = [k for k in state if k.startswith(prefix) and k.endswith(".running_mean")]
    if fused or not bns:
        return
    module.train()
    with torch.no_grad():
        got = module(arg_t)
    ctx = Ctx(p=jp, s=js, train=True)
    _close(_port_out(got), run_jax(ctx, arg_j), OUT_REL, "train")
    new = module.state_dict()
    assert set(ctx.new_state) == {k for k in state if k.startswith(prefix)
                                  and ".running_" in k}
    for k, v in ctx.new_state.items():
        _close(new[k[len(prefix):]].numpy(), v, STAT_REL, k)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", list(ROW_CASES))
def test_row_module_matches_jax(case, fused):
    rows, ch = ROW_CASES[case]
    cfg = _det(rows)
    jspec, spec = jax_compile_spec(cfg, ch_in=ch), compile_spec(cfg, ch_in=ch)
    assert _rows(spec) == _rows(jspec)
    params, state = _perturb(*init_model(jspec, seed=1), seed=2)
    row, jrow = spec.rows[-1], jspec.rows[-1]
    module = _build_row(spec, row, fused, kernel=False, c3_kernel=False)
    x = np.random.RandomState(3).randn(2, 16, 24, ch).astype(np.float32)
    _hold(module, lambda ctx, xj: _apply_row(ctx, jrow, xj), x, params, state,
          f"model.{row.i}.", fused)


# block -> (the port's module, fused or not; the JAX block function; its
# JAX init, or None; the number of inputs)
BLOCK_CASES = {
    "sum": (lambda f: B.Sum(3), lambda ctx, x: JB.sum_layer(ctx, "m", x), None, 3),
    "sum_weighted": (lambda f: B.Sum(3, True),
                     lambda ctx, x: JB.sum_layer(ctx, "m", x, True),
                     lambda ini: JB.init_sum(ini, "m", 3, True), 3),
    "dappm": (lambda f: B.DAPPM(16, 8, 24), lambda ctx, x: JB.dappm(ctx, "m", x),
              lambda ini: JB.init_dappm(ini, "m", 16, 8, 24), 1),
    "rfb1": (lambda f: B.RFB1(16, 16, fused=f), lambda ctx, x: JB.rfb1(ctx, "m", x),
             lambda ini: JB.init_rfb1(ini, "m", 16, 16), 1),
    "rfb1_global": (lambda f: B.RFB1(16, 16, has_globel=True, fused=f),
                    lambda ctx, x: JB.rfb1(ctx, "m", x, has_globel=True),
                    lambda ini: JB.init_rfb1(ini, "m", 16, 16, has_globel=True), 1),
    "aspps": (lambda f: B.ASPPs(16, 16, fused=f), lambda ctx, x: JB.aspps(ctx, "m", x),
              lambda ini: JB.init_aspps(ini, "m", 16, 16), 1),
}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_matches_jax(case, fused):
    make, run_jax, init, n_in = BLOCK_CASES[case]
    ini = Initializer(4)
    if init is not None:
        init(ini)
    params, state = _perturb(ini.params, ini.state, seed=5)
    rng = np.random.RandomState(6)
    xs = [rng.randn(2, 32, 32, 16).astype(np.float32) * 0.5 for _ in range(n_in)]
    _hold(make(fused), run_jax, xs if n_in > 1 else xs[0], params, state, "m.", fused)


SHARD_ROWS = pytest.mark.parametrize(
    "make", [lambda: B.ZeroPad2d([0, 1, 0, 1]), lambda: B.MaxPool2d(3, 2, 1),
             lambda: B.MaxPool2d(2, 1), lambda: B.C3TR(16, 16),
             lambda: B.Upsample(2, "bilinear"), lambda: B.Upsample(2, "bicubic")],
    ids=["zeropad", "maxpool_k3_s2_p1", "maxpool_k2_s1", "c3tr", "upsample_bilinear",
         "upsample_bicubic"])


def _drawn(make):
    torch.manual_seed(0)
    row = make().eval()
    with torch.no_grad():               # C3TR's in-projection is allocated, not drawn
        for p in row.parameters():
            p.normal_(0.0, 0.2)
    return row


def _sharded_ranks(row, x, plan):
    """Each of two thread ranks' gathered output of ``row`` on its rows of
    ``x`` as ``plan`` splits them."""
    from _torch_parallel_worker import run_threads
    from multiyolov5_tpu_torch.ops import shard
    from multiyolov5_tpu_torch.parallel.comm import Group

    def one(g, i):
        a = sum(plan.rows[:i])
        with torch.no_grad(), shard.sharded(g, Group([0], 0), plan):
            return shard.gather_rows(row(x[:, :, a:a + plan.rows[i]]))
    return run_threads(2, one)


@SHARD_ROWS
def test_rows_reaching_across_shards_match_unsharded(make):
    """In a forward whose H axis is split over ranks (parallel/spatial.py),
    the rows that read across the shards' rows take halos or the gathered
    map: sharded over 6 + 2 rows, each gathered output equals the
    unsharded row's."""
    from multiyolov5_tpu_torch.ops import shard

    row = _drawn(make)
    x = torch.randn(1, 16, 8, 8)
    with torch.no_grad():
        want = row(x)
    for got in _sharded_ranks(row, x, shard.Plan((6, 2), 8)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@SHARD_ROWS
def test_rows_reaching_across_shards_raise(make):
    """What a sharded forward still refuses: each of these rows given a
    shard whose row count is not the plan's (5 rows where the plan gives
    6 + 2), and a stride-2 window over shards whose first rows are odd
    (7 + 1)."""
    from multiyolov5_tpu_torch.ops import shard
    from multiyolov5_tpu_torch.parallel.comm import Group

    x = torch.randn(1, 16, 8, 8)
    with shard.sharded(Group([0, 1], 0, pg=object()), Group([0], 0), shard.Plan((6, 2), 8)):
        with pytest.raises(ValueError, match="rows where the plan gives"):
            _drawn(make)(x[:, :, :5])
    with pytest.raises(NotImplementedError, match="stride-2 window op"):
        _sharded_ranks(B.MaxPool2d(2), x, shard.Plan((7, 1), 8))
    torch.testing.assert_close(B.MaxPool2d(2)(x), torch.nn.functional.max_pool2d(x, 2))
