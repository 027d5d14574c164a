"""Device-time breakdown of the port's eval path on one GPU.

    python3 prof_eval_torch.py

Runs ``evaluate_detection`` (yolov5s_city_seg in float32, as cli/test.py
defaults, seeded random weights) on chip_smoke.py's two seeded bs4 batches
(512x1024 letterboxed from 1024x2048; conf 0.001, iou 0.6, multi-label,
max_nms 30000) under ``torch.profiler``.  Prints the card's name and power
limit, the wall time per image and its split into forward, NMS and host
bookkeeping, the device-busy share of that window, and the operations with
the most device time.  The Chrome trace goes to
``chiprun_out/eval_trace.json``.
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
REPS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("prof_eval_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.evaluation import evaluate_detection

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = Engine(cfg=cs.CFG, half=False, seed=cs.SEED)
    batches, _ = cs.eval_batches(eng, np.random.RandomState(cs.SEED + 5))
    n_img = REPS * cs.EVAL_BS * cs.EVAL_BATCHES

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            return evaluate_detection(eng, batches, conf_thres=cs.EVAL_CONF,
                                      iou_thres=cs.EVAL_IOU)[2]

    run()
    torch.cuda.synchronize()
    t_inf = t_nms = 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            ti, tn, _ = run()
            t_inf, t_nms = t_inf + ti, t_nms + tn
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels, copies and memsets: an operator's own row repeats the device
    # time of the kernels it launched, so CPU-side rows are left out
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    print(f"wall {wall / n_img * 1e3:.3f} ms/image under the profiler: forward "
          f"{t_inf / n_img * 1e3:.3f}, NMS {t_nms / n_img * 1e3:.3f}, host bookkeeping "
          f"{(wall - t_inf - t_nms) / n_img * 1e3:.3f}; device busy "
          f"{dev_us / n_img / 1e3:.3f} ms/image ({100 * dev_us / (wall * 1e6):.1f}% of wall, "
          f"kernels summed)")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(ROOT, "chiprun_out", "eval_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
