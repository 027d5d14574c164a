"""Device-time breakdown of the port's serving path on one GPU.

    python3 prof_serving_torch.py              # bs1, 512x1024 frames
    python3 prof_serving_torch.py --batch 8    # bs8, 1024x1024 frames

Runs ``multiyolov5_tpu_torch.engine.Engine`` (yolov5s_city_seg, bf16,
seeded random weights) on seeded letterboxed frames, orig 1024x2048: at bs1
512x1024 frames (bench.py's geometry), at a larger batch the square
1024x1024 frames that ``InferenceServer`` (img_size 1024) makes of
2048x1024 ones.  Prints the card's name and power limit, the wall time per
frame, the device-busy share of that window, and the operations with the
most device time, under ``torch.profiler``.  The Chrome trace goes to
``chiprun_out/serving_trace.json`` (bs1) or ``serving_bs<N>_trace.json``.
"""

from __future__ import annotations

import argparse
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    batch = ap.parse_args().batch
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
    in_hw = (512, 1024) if batch == 1 else (1024, 1024)
    frames = [(rng.rand(batch, *in_hw, 3) * 255).astype(np.uint8) for _ in range(3)]
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
    n = ITERS * batch
    print(f"bs{batch} {in_hw}: wall {wall_us / n / 1e3:.3f} ms/frame under the profiler; "
          f"device busy {dev_us / n / 1e3:.3f} ms/frame "
          f"({100 * dev_us / wall_us:.1f}% of wall, kernels summed)")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = "serving_trace.json" if batch == 1 else f"serving_bs{batch}_trace.json"
    prof.export_chrome_trace(os.path.join(ROOT, "chiprun_out", name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
