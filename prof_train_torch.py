"""Device-time breakdown of the port's dual-task train step on one GPU.

    python3 prof_train_torch.py

Runs the train step (yolov5s_city_seg, seeded random weights, bf16 autocast
as the step defaults; det bs8 832x832 uint8 with 20 targets an image, seg bs8
512x1024, chip_smoke.py's geometry and seeded batch) under
``torch.profiler`` for 3 steps after 3 warm-up steps.  Prints the card's
name and power limit, the wall time per step, the device-busy share of that
window (kernels, copies and memsets only) and the operations with the most
device time.  The Chrome trace goes to ``train_trace.json`` in
``chip_smoke.OUT_DIR``.
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
WARMUP, STEPS = 3, 3


def main() -> int:
    if not torch.cuda.is_available():
        print("prof_train_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    spec = load_spec(cs.CFG)
    ts, step = cs.train_state(spec, seeded_state_dict(spec, cs.SEED), torch.bfloat16,
                              "cuda", cs.TRAIN_BS)
    host = cs.train_batch(np.random.RandomState(cs.SEED + 9), cs.TRAIN_BS, spec.nc,
                          spec.n_segcls)
    batch = tuple(torch.as_tensor(a).to("cuda") for a in host)
    args = (*cs.TRAIN_STEP_ARGS, True)
    for _ in range(WARMUP):
        step(ts, *batch, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(ts, *batch, *args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels, copies and memsets: an operator's own row repeats the device
    # time of the kernels it launched, so CPU-side rows are left out
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    print(f"wall {wall / STEPS * 1e3:.2f} ms/step under the profiler "
          f"({cs.TRAIN_BS * STEPS / wall:.1f} det img/s); device busy "
          f"{dev_us / STEPS / 1e3:.2f} ms/step ({100 * dev_us / (wall * 1e6):.1f}% of wall, "
          f"kernels summed)")
    print(events.table(sort_by="self_device_time_total", row_limit=30))
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(cs.OUT_DIR, "train_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
