"""Device-time report of a ``torch.profiler`` trace (counterpart of
``multiyolov5_tpu/tools/trace_report.py``).

Reads the Chrome trace that ``utils/profiling.trace`` (or
``torch.profiler``'s ``export_chrome_trace``) writes and sums the events of
the device lanes only: kernels, memcpy and memset.  Each op is put in a
class: the port's own kernels (``csrc/``) are ``custom(cuda)``.  A trace
taken on the CPU has no device rows.

    python -m multiyolov5_tpu_torch.tools.trace_report runs/trace [--top 30]

or from Python::

    from multiyolov5_tpu_torch.tools.trace_report import trace_and_report
    rows = trace_and_report(lambda: model(x), top=30)
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import shutil
import tempfile
from collections import defaultdict
from typing import Callable, List, Tuple

from ..utils.profiling import trace

# the Chrome trace's categories of device-lane events
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernel symbols of csrc/: K1 stem, K2 conv3x3, K7 c3, K3/K5 NMS, K4, K6
PORT_KERNELS = ("stem_tc", "stem_tf32", "conv3x3_tma", "conv3x3_tf32", "c3_bf16", "c3_tf32",
                "nms_cluster_kernel", "upsample_argmax_kernel", "seg_ce_fwd_kernel",
                "seg_ce_bwd_kernel", "seg_ce_reduce_kernel")
_PORT_RE = re.compile(r"(?<!\w)(" + "|".join(PORT_KERNELS) + r")(?!\w)")


def load_trace(path: str) -> dict:
    """The Chrome trace at ``path``, or the newest ``*.json`` / ``*.json.gz``
    under the directory ``path``."""
    if os.path.isdir(path):
        found = [p for ext in ("*.json", "*.json.gz")
                 for p in glob.glob(os.path.join(path, "**", ext), recursive=True)]
        if not found:
            raise FileNotFoundError(f"no trace .json under {path}")
        path = max(found, key=os.path.getmtime)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as fh:
        return json.load(fh)


def device_op_times(trace: dict) -> List[Tuple[str, float, int]]:
    """[(op name, total us, count)] of the device-lane events (kernels,
    memcpy, memset), the longest first."""
    agg = defaultdict(lambda: [0.0, 0])
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or str(e.get("cat", "")).lower() not in DEVICE_CATS:
            continue
        agg[e.get("name", "")][0] += float(e.get("dur", 0.0))
        agg[e.get("name", "")][1] += 1
    return sorted(((k, us, n) for k, (us, n) in agg.items()), key=lambda r: -r[1])


def classify(name: str) -> str:
    """The class of a device op: ``custom(cuda)`` for the port's kernels,
    then conv (cuDNN, implicit GEMM), matmul (GEMM, CUTLASS, cuBLAS(Lt)), copy
    (memcpy, memset), topk/sort, reduce, elementwise, other."""
    if _PORT_RE.search(name):
        return "custom(cuda)"
    n = name.lower()
    if any(k in n for k in ("cudnn", "implicit_gemm", "convolve", "fprop", "dgrad", "wgrad")):
        return "conv"
    if any(k in n for k in ("gemm", "cutlass", "cublas", "matmul", "nvjet")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if any(k in n for k in ("sort", "topk", "top-k", "radix")):
        return "topk/sort"
    if "reduce" in n:
        return "reduce"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def report(trace: dict, top: int = 30) -> List[Tuple[str, float, int]]:
    """Print the class table and the ``top`` device ops of ``trace``;
    return its :func:`device_op_times` rows."""
    rows = device_op_times(trace)
    by_class = defaultdict(float)
    for name, us, _ in rows:
        by_class[classify(name)] += us
    total = sum(by_class.values())
    print(f"{'class':>16} {'us':>12} {'%':>6}")
    for k, v in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"{k:>16} {v:>12.1f} {100 * v / max(total, 1e-9):>6.1f}")
    print(f"{'TOTAL':>16} {total:>12.1f}")
    print(f"\ntop {top} ops:")
    for name, us, cnt in rows[:top]:
        print(f"  {us:>10.1f} us x{cnt:<5} {name[:110]}")
    return rows


def trace_and_report(fn: Callable[[], None], top: int = 30,
                     log_dir: str = "") -> List[Tuple[str, float, int]]:
    """Run ``fn`` under ``utils/profiling.trace`` and :func:`report` its
    device ops; the trace stays in ``log_dir`` when one is given."""
    d = log_dir or tempfile.mkdtemp(prefix="torch_trace_")
    try:
        with trace(d) as path:
            fn()
        return report(load_trace(path), top)
    finally:
        if not log_dir:
            shutil.rmtree(d, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="a Chrome trace .json(.gz), or a directory holding one")
    ap.add_argument("--top", type=int, default=30)
    a = ap.parse_args(argv)
    return report(load_trace(a.trace), a.top)


if __name__ == "__main__":
    main()
