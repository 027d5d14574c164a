"""The dp1 x sp2 train step's host ms on the card, for one or more trees.

    python3 prof_sp_step_torch.py [--reps N] [--roots DIR ...]

Two ranks share the one card over gloo, as ``chip_smoke.py`` [15] (c)
runs them: yolov5s_city_seg on seeded weights at [7]'s geometry (det bs8
832x832 uint8 with 20 targets an image, seg bs8 512x1024), float32, hyp
scratch, H over the two ranks, the state updated every step.  Each root
(a checkout of this repo; default the one this script is in) runs in a
fresh pair of processes, in the order given, so ``--roots parent . .
parent`` compares two trees on one card within one call.  One warm-up
step, then ``--reps`` synchronised steps a root, then one step with its
collectives metered (count, bytes sent, host ms, synchronised around
each).  With ``--profile``, one more step under ``torch.profiler`` on
rank 0: its ops by self CPU time and by device time go to
``chiprun_out/prof_sp_step_<i>.txt`` for root ``i``.  Prints each root's
median and every rep beside the card's name and power limit, and writes
``chiprun_out/prof_sp_step.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
CFG, SEED, BS = "yolov5s_city_seg", 0, 8
DET_HW, SEG_HW, TARGETS, MAX_T = (832, 832), (512, 1024), 20, 64
STEP_ARGS = (0.01, 0.01, 0.9, True)


def metered(comm, rec: dict):
    """Wrap ``comm.Group``'s raw collectives to add (count, bytes, host ms)
    into ``rec``; returns the originals."""
    real = {k: getattr(comm.Group, k) for k in ("all_reduce_", "all_gather_raw")}

    def wrap(kind, fn):
        def run(self, t, *a):
            if self.size == 1:
                return fn(self, t, *a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(self, t, *a)
            torch.cuda.synchronize()
            r = rec.setdefault(kind, [0, 0, 0.0])
            r[0] += 1
            r[1] += t.numel() * t.element_size()
            r[2] += (time.perf_counter() - t0) * 1e3
            return y
        return run

    for k, fn in real.items():
        setattr(comm.Group, k, wrap(k, fn))
    return real


def rank_main(rank: int, world: int, root: str, store: str, reps: int, out: str,
              profile: str) -> None:
    sys.path.insert(0, root)
    from multiyolov5_tpu_torch.parallel import comm
    from multiyolov5_tpu_torch.data.hyps import load_hyp
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.parallel.mesh import (initialize_distributed, make_mesh,
                                                     shard_train_batch)
    from multiyolov5_tpu_torch.train import trainer as T
    from multiyolov5_tpu_torch.train.losses import pad_targets

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    initialize_distributed(f"file://{store}", world, rank, device="cuda")
    spec = load_spec(CFG)
    rng = np.random.RandomState(SEED + 9)
    imgs = (rng.rand(BS, *DET_HW, 3) * 255).astype(np.uint8)
    labels = []
    for _ in range(BS):
        lab = np.zeros((TARGETS, 5), np.float32)
        lab[:, 0] = rng.randint(0, spec.nc, TARGETS)
        lab[:, 1:3] = rng.rand(TARGETS, 2) * 0.6 + 0.2
        lab[:, 3:5] = rng.rand(TARGETS, 2) * 0.2 + 0.05
        labels.append(lab)
    tgts, mask = pad_targets(labels, MAX_T)
    host = (imgs, tgts, mask, rng.rand(BS, *SEG_HW, 3).astype(np.float32),
            rng.randint(-1, spec.n_segcls, (BS, *SEG_HW)))
    mesh = make_mesh(1, world)
    cfg = T.TrainConfig(hyp=load_hyp("scratch"), batch_size=BS, compute_dtype=torch.float32)
    ts, groups = T.create_train_state(spec, cfg, state_dict=seeded_state_dict(spec, SEED),
                                      device="cuda")
    step = T.make_train_step(spec, cfg, groups, mesh=mesh)
    # a tree whose H split takes the stride and whose step takes the whole heights
    unit = (max(spec.strides),) if "unit" in inspect.signature(shard_train_batch).parameters \
        else ()
    kw = {"heights": (DET_HW[0], SEG_HW[0])} if "heights" in inspect.signature(step).parameters \
        else {}
    batch = tuple(torch.as_tensor(a).to("cuda") for a in shard_train_batch(mesh, host, *unit))
    ms = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = step(ts, *batch, *STEP_ARGS, **kw)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    total = float(m["total"])
    rec = {}
    real = metered(comm, rec)
    step(ts, *batch, *STEP_ARGS, **kw)
    for k, fn in real.items():
        setattr(comm.Group, k, fn)
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as prof
        ctx = (prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if rank == 0
               else contextlib.nullcontext())
        with ctx as p:
            step(ts, *batch, *STEP_ARGS, **kw)
            torch.cuda.synchronize()
        if rank == 0:
            ka = p.key_averages()
            with open(profile, "w") as fh:
                fh.write(ka.table(sort_by="self_cpu_time_total", row_limit=30) + "\n")
                fh.write(ka.table(sort_by="self_device_time_total", row_limit=20) + "\n")
    torch.distributed.destroy_process_group()
    if rank == 0:
        with open(out, "w") as fh:
            json.dump({"ms": ms, "total": total, "collectives": rec}, fh)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--roots", nargs="+", default=[HERE])
    p.add_argument("--profile", action="store_true")
    opt = p.parse_args()
    if not torch.cuda.is_available():
        print("prof_sp_step_torch.py: no CUDA device", file=sys.stderr)
        return 1
    name = card()
    runs = []
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    for i, root in enumerate(opt.roots):
        root = os.path.abspath(root)
        table = os.path.join(HERE, "chiprun_out", f"prof_sp_step_{i}.txt") if opt.profile else ""
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "r.json")
            t0 = time.perf_counter()
            mp.start_processes(rank_main, args=(2, root, os.path.join(tmp, "store"), opt.reps,
                                                out, table), nprocs=2, start_method="spawn")
            with open(out) as fh:
                r = json.load(fh)
        r.update(root=os.path.relpath(root, HERE), wall_s=time.perf_counter() - t0,
                 median_ms=float(np.median(r["ms"])))
        runs.append(r)
        print(f"{r['root']}: dp1 x sp2 step median {r['median_ms']:.1f} ms over {opt.reps} "
              f"(reps {', '.join(f'{v:.1f}' for v in r['ms'])}; loss {r['total']:.6f}; "
              f"{r['wall_s']:.1f} s wall) [{name}]", flush=True)
        print("  collectives of one step (count, bytes, host ms): "
              + json.dumps(r["collectives"]), flush=True)
    with open(os.path.join(HERE, "chiprun_out", "prof_sp_step.json"), "w") as fh:
        json.dump({"card": name, "cfg": CFG, "bs": BS, "det_hw": DET_HW, "seg_hw": SEG_HW,
                   "runs": runs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
