"""Auto-resume interrupted trainings (counterpart of
``multiyolov5_tpu/tools/resume.py``; reference utils/aws/resume.py).

Finds the ``last.npz`` checkpoints under a runs directory that still hold
optimizer state (a finished run's were stripped by ``strip_optimizer``)
and whose run directory has its ``opt.yaml``, and spawns
``python -m multiyolov5_tpu_torch.cli.train --resume --weights <last.npz>``
with the run's ``--cfg``, ``--data``, ``--project`` and ``--name``, as the
JAX tool does.  ``--dry-run`` prints the commands only.

Run: ``python -m multiyolov5_tpu_torch.tools.resume --dir runs/train``
"""

from __future__ import annotations

import argparse
import glob
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from ..data.hyps import read_yaml


def unfinished(last: str) -> bool:
    """True when the checkpoint still holds its optimizer state."""
    try:
        with np.load(last, allow_pickle=False) as z:
            skel = json.loads(bytes(z["__skeleton__"]).decode())
    except (OSError, KeyError, ValueError):
        return True
    return "opt" in skel and not skel["opt"].get("__none__")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/train")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    cmds = []
    for last in sorted(glob.glob(f"{args.dir}/**/last.npz", recursive=True)):
        run_dir = Path(last).parent.parent
        opt_file = run_dir / "opt.yaml"
        if not opt_file.exists():
            continue
        if not unfinished(last):
            print(f"skip finished run {run_dir}")
            continue
        opt = read_yaml(str(opt_file))
        cmd = [sys.executable, "-m", "multiyolov5_tpu_torch.cli.train",
               "--resume", "--weights", last,
               "--cfg", str(opt.get("cfg", "yolov5s_city_seg")),
               "--data", str(opt.get("data")),
               "--project", str(run_dir.parent), "--name", run_dir.name,
               "--exist-ok"]
        print(" ".join(cmd))
        if not args.dry_run:
            subprocess.Popen(cmd)
        cmds.append(cmd)
    if not cmds:
        print("no interruptible runs found")
    return cmds


if __name__ == "__main__":
    main()
