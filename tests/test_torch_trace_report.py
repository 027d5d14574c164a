"""The port's trace report (multiyolov5_tpu_torch/tools/trace_report.py) and the
profile CLI (multiyolov5_tpu_torch/cli/profile.py), on the CPU.

A synthetic Chrome trace written here, in the format ``torch.profiler``
exports (device lanes: ``kernel``, ``gpu_memcpy``, ``gpu_memset``; host
lanes: ``cpu_op``, ``cuda_runtime``, which must be left out), gives exact
rows, classes and totals, read as ``.json`` and as ``.json.gz``, from the
file or its directory.  Each class of ``classify`` is held on names of the
kind the card's traces hold, the port's kernel symbols as ``custom(cuda)``
under templates and namespaces.  On the CPU a real ``torch.profiler``
trace, from ``trace_and_report`` and from the profile CLI's ``--trace``,
has no device rows.  The profile CLI (``--device cpu``) prints the JAX
CLI's ``model_info`` layers and parameters for the same weights.
"""

import contextlib
import gzip
import io
import json

import pytest
import torch

from multiyolov5_tpu.engine import Engine as JaxEngine
from multiyolov5_tpu.models.config import load_spec as jax_load_spec
from multiyolov5_tpu.utils import profiling as jax_profiling
from multiyolov5_tpu_torch.cli.profile import main as profile_main
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import Model, seeded_state_dict
from multiyolov5_tpu_torch.tools import trace_report as tr
from multiyolov5_tpu_torch.utils.checkpoint import save_npz, to_jax_params
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_step import TINY

NAMES = {
    "void conv3x3_tma<__nv_bfloat16, 1>(CUtensorMap, CUtensorMap, float const*)": "custom(cuda)",
    "void bf::c3_bf16(CUtensorMap, bf::Args)": "custom(cuda)",
    "void (anonymous namespace)::nms_cluster_kernel<256>(float4 const*, float const*, int)":
        "custom(cuda)",
    "void stem_tf32<unsigned char, 2>(unsigned char const*, uint4 const*)": "custom(cuda)",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64":
        "conv",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float>(cudnn::kernel_params)": "conv",
    "void implicit_convolve_sgemm<float, float, 128, 5, 5>(int, int, int)": "conv",
    "ampere_sgemm_128x64_nn": "matmul",
    "nvjet_tst_64x64_64x13_2x1_v_bz_NNT": "matmul",
    "void convolve_common_engine_float_NHWC<__nv_bfloat16, __nv_bfloat16, 128, 5, 5>(int)":
        "conv",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_nn_align8>":
        "matmul",
    "Memcpy HtoD (Pageable -> Device)": "copy",
    "Memset (Device)": "copy",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int, float>(int*)": "topk/sort",
    "void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>(float*)": "topk/sort",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(float*)": "reduce",
    "void at::native::vectorized_elementwise_kernel<4, at::native::silu_kernel>(int, float*)":
        "elementwise",
    "void at::native::upsample_bilinear2d_out_frame<float, float>(int, float)": "other",
    "void my_stem_tc_copy(float*)": "other",
}


@pytest.mark.parametrize("name", list(NAMES))
def test_classify(name):
    assert tr.classify(name) == NAMES[name]


def _synthetic():
    """(trace, {name: (us, count)} of its device events)."""
    events = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}}]
    want = {}
    for j, name in enumerate(NAMES):
        cat = {"Memcpy": "gpu_memcpy", "Memset": "gpu_memset"}.get(name[:6], "kernel")
        for n in range(1 + j % 3):
            us = 1.25 * (j + 1) + n
            events.append({"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7,
                           "ts": 100.0 * j + n, "dur": us})
            w = want.setdefault(name, [0.0, 0])
            w[0] += us
            w[1] += 1
        # the host's side of the same op: never a device row
        events.append({"ph": "X", "cat": "cpu_op", "name": name, "pid": 0, "tid": 1,
                       "ts": 100.0 * j, "dur": 50.0})
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "pid": 0, "tid": 1, "ts": 100.0 * j, "dur": 3.0})
    events.append({"ph": "f", "cat": "ac2g", "name": "flow", "pid": 1, "tid": 7, "ts": 1.0})
    return {"traceEvents": events}, want


@pytest.mark.parametrize("form", ["json", "gz", "dir"])
def test_synthetic_trace_is_exact(tmp_path, form):
    trace, want = _synthetic()
    path = tmp_path / ("t.json.gz" if form == "gz" else "t.json")
    with (gzip.open(path, "wt") if form == "gz" else open(path, "w")) as fh:
        json.dump(trace, fh)
    loaded = tr.load_trace(str(tmp_path if form == "dir" else path))
    rows = tr.device_op_times(loaded)
    assert {n: [us, c] for n, us, c in rows} == want
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tr.report(loaded, top=5) == rows
    table = {}
    for line in out.getvalue().splitlines()[1:]:
        parts = line.split()
        if parts and parts[0] == "TOTAL":
            total = float(parts[1])
            break
        table[parts[0]] = float(parts[1])
    classes = {}
    for name, (us, _) in want.items():
        classes[NAMES[name]] = classes.get(NAMES[name], 0.0) + us
    assert table == {k: pytest.approx(round(v, 1), abs=0.051) for k, v in classes.items()}
    assert total == pytest.approx(sum(classes.values()), abs=0.051)
    assert sum(table.values()) == pytest.approx(total, abs=0.06 * len(table))


def test_cpu_trace_has_no_device_rows(tmp_path):
    spec = load_spec(TINY)
    model = Model(spec).eval()
    x = torch.rand(1, 3, 64, 64)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rows = tr.trace_and_report(lambda: model(x), log_dir=str(tmp_path))
    assert rows == [] and "TOTAL" in out.getvalue()
    # the trace was written and holds the host's ops
    events = tr.load_trace(str(tmp_path))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_profile_cli_on_cpu(tmp_path):
    spec = load_spec(TINY)
    params, state = to_jax_params(seeded_state_dict(spec, 0))
    w = str(tmp_path / "w.npz")
    save_npz(w, {"params": params, "state": state, "spec_yaml": json.dumps(TINY)})
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = profile_main(["--weights", w, "--img-size", "64", "--batch-size", "2",
                            "--layers", "--trace", str(tmp_path / "tr"), "--iters", "2",
                            "--device", "cpu"])
        # the JAX CLI's summary: its Engine's folded bf16 params
        want = jax_profiling.model_info(jax_load_spec(TINY), JaxEngine(w).params, img_size=64)
    assert (res["info"]["layers"], res["info"]["parameters"]) == \
        (want["layers"], want["parameters"])
    assert res["forward_s"] > 0 and len(res["layers"]) == len(spec.rows)
    assert all(r[3] >= 0 for r in res["layers"])
    assert tr.device_op_times(tr.load_trace(res["trace"])) == []
    assert "forward 64x64 bs2" in out.getvalue()
