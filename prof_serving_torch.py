"""Device-time breakdown of the port's bs1 serving path on one GPU.

    python3 prof_serving_torch.py

Runs ``multiyolov5_tpu_torch.engine.Engine`` (yolov5s_city_seg, bf16,
seeded random weights) on
seeded 512x1024 frames, orig 1024x2048, under ``torch.profiler`` and prints
the card's name and power limit, the wall time per frame, the device-busy
share of that window, and the operations with the most device time.  The
Chrome trace goes to ``chiprun_out/serving_trace.json``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))


ITERS = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("prof_serving_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from multiyolov5_tpu_torch.engine import Engine

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    eng = Engine(cfg="yolov5s_city_seg", device="cuda", half=True, seed=0)
    rng = np.random.RandomState(0)
    frames = [(rng.rand(512, 1024, 3) * 255).astype(np.uint8) for _ in range(3)]
    for f in frames:
        eng(f, (1024, 2048))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(ITERS):
            eng(frames[i % 3], (1024, 2048))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # kernels, copies and memsets: an operator's own row repeats the device
    # time of the kernels it launched, so CPU-side rows are left out
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    print(f"wall {wall_us / ITERS / 1e3:.3f} ms/frame under the profiler; "
          f"device busy {dev_us / ITERS / 1e3:.3f} ms/frame "
          f"({100 * dev_us / wall_us:.1f}% of wall, kernels summed)")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(ROOT, "chiprun_out", "serving_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
