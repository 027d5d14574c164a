"""Time the port's PNG reader (``multiyolov5_tpu_torch/data/png.py``) on
seeded frames whose rows use the Average and Paeth filters, on the host,
optionally against another checkout.

    python3 prof_png_torch.py                   # this checkout
    python3 prof_png_torch.py --against DIR     # DIR, this, this, DIR

Cases (``CASES``, written by this checkout's
``tests/_torch_image_writers.py`` from a seed, the same files for every
tree): 8-bit RGB frames of 2048x1024 with every row Paeth, every row
Average, and the five filters in turn, and a tall, narrow 256x16384 Paeth
frame.  Each run prints one JSON line a case: ``png.imread``'s host ms
(the least and the median of ``REPS`` calls), the peak of the memory numpy
allocates in one call (``tracemalloc``), and the SHA-256 of the decoded
array.  With ``--against``, the two trees run in turns in separate
processes, so both are timed on the same host within one call; the run
fails if any two decodes differ.  Prints the card's name and power limit
first (the host is the card's machine); writes
``chiprun_out/prof_png.json``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
import tracemalloc

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "prof_png")
# (name, (h, w), row filters in turn)
CASES = [("paeth_2048x1024", (1024, 2048), (4,)),
         ("average_2048x1024", (1024, 2048), (3,)),
         ("all_five_2048x1024", (1024, 2048), (0, 1, 2, 3, 4)),
         ("paeth_256x16384", (16384, 256), (4,))]
REPS = 3


def write_cases() -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_image_writers as W
    os.makedirs(WORK, exist_ok=True)
    for i, (name, (h, w), filters) in enumerate(CASES):
        rng = np.random.RandomState(i)
        yy, xx = np.mgrid[0:h, 0:w]
        rgb = np.stack([xx // 8 + yy // 4, (xx + yy) // 16, yy // 6], -1)
        rgb = (rgb + rng.randint(0, 12, (h, w, 3))) % 256
        with open(os.path.join(WORK, name + ".png"), "wb") as fh:
            fh.write(W.png(rgb.astype(np.uint8), 8, 2, filters=filters))


def run(tree: str, label: str) -> None:
    sys.path.insert(0, tree)
    from multiyolov5_tpu_torch.data import png
    for name, (h, w), filters in CASES:
        path = os.path.join(WORK, name + ".png")
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            png.imread(path)
            times.append((time.perf_counter() - t0) * 1e3)
        tracemalloc.start()
        out = png.imread(path)
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        print(json.dumps({"tree": label, "case": name, "hw": [h, w], "filters": filters,
                          "ms_min": min(times), "ms_median": float(np.median(times)),
                          "peak_mib": peak / 2 ** 20,
                          "sha256": hashlib.sha256(out.tobytes()).hexdigest()}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="another checkout's root, timed in turns with this one")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        run(args.tree, args.label)
        return 0
    order = ([(args.against, "other"), (ROOT, "this"), (ROOT, "this"), (args.against, "other")]
             if args.against else [(ROOT, "this")])
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        smi = "no nvidia-smi on this host"
    print(smi, flush=True)
    write_cases()
    rows = []
    for tree, label in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                              os.path.abspath(tree), "--label", label],
                             capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr, flush=True)
            return res.returncode
        rows += [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "prof_png.json"), "w") as fh:
        json.dump({"card": smi, "rows": rows}, fh, indent=1)
    differ = sorted({r["case"] for r in rows
                     if len({q["sha256"] for q in rows if q["case"] == r["case"]}) > 1})
    if differ:
        print(f"decodes differ between the trees at {differ}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
