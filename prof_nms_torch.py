"""Time K5 (greedy NMS, ``multiyolov5_tpu_torch/csrc/nms_greedy.cu``) and K3
(the <= 1024-row NMS of bs1 serving, ``multiyolov5_tpu_torch/csrc/nms.cu``)
at the paths' candidate-list shapes on one NVIDIA GPU, optionally against
another checkout.

    python3 prof_nms_torch.py                   # this checkout
    python3 prof_nms_torch.py --against DIR     # DIR, this, this, DIR
    python3 prof_nms_torch.py --sweep           # every plan the kernel could take

Cases (``CASES``, seeded with numpy, the same in every tree): eval's
(4, 30000) multi-label lists (10 class offsets, 30000, 29000, 24000 and
20257 valid rows, as the eval path's images give; max_det 300 is reached),
the short (4, 1024) lists, a bs8 ``InferenceServer`` batch's (8, 1024) and
the one-list serving case (1, 1024); the sweep adds eval's lists at bs8
(more 16-CTA clusters than the card places at once) and one list of
262144 rows (past shared memory at 16 CTAs: boxes in device memory).
iou 0.6 (eval) and 0.45 (serving).  Each run prints one JSON line a case:
K5's device ms (CUDA graph replay), its plan, its picks and the SHA-256
of its (idx, valid) output; for this checkout also the picks differing
from ``nms_greedy_plain`` (must be 0), the IoU tests the inputs need and
``chip_smoke.py``'s bound from them.  With ``--against``, the two trees
run in turns in separate processes (each builds its own kernels into its
own ``build/kernels``), so both are timed on the same card within one
call, and the picks must be bitwise equal.  ``--sweep`` times every
cluster size (1, 2, 4, 8, 16) and residence (boxes in shared or device
memory) at each case, and requires every
plan's picks to equal the default plan's.

K3 (``K3_CASES``, iou 0.45, max_det 300): the serving case's 1024-row list,
the deepest chain (unit boxes a quarter apart, each overlapping the next
only) and a list with every row invalid.  A JSON line a case: the keep
mask's device ms, the ms of the serving path's call with its pack (one
``nms_packed`` call where the tree has it, else ``pack_keep`` of the mask),
the SHA-256 of the mask and of the packed output, and the device
operations (kernels, copies, memsets) that one ``nms_fixed`` call on the
list issues, counted with torch.profiler; for this checkout also the plan,
the entries differing from the plain versions (must be 0) and the bound.
With ``--against`` the masks and packed outputs must be bitwise equal
across trees.  ``--sweep`` times K3 at every cluster size (1-16) at each
case and requires the default's outputs.  Writes
``chiprun_out/prof_nms.json`` (``prof_nms_sweep.json``).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# (name, batch, rows, valid rows per image (None: all), iou, max_det)
CASES = [("eval", 4, 30000, (30000, 29000, 24000, 20257), 0.6, 300),
         ("short", 4, 1024, None, 0.6, 300),
         ("serving_bs8", 8, 1024, None, 0.45, 300),
         ("serving_bs1", 1, 1024, None, 0.45, 300)]
SWEEP_CASES = CASES + [("eval_bs8", 8, 30000, None, 0.6, 300),
                       ("long", 1, 262144, None, 0.6, 300)]
CLUSTERS = (1, 2, 4, 8, 16)
K3_CASES = ("serving", "chain", "invalid")


def _smoke():
    """chip_smoke.py of this checkout (its timing helpers and bounds)."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lists(seed: int, bsz: int, n: int, n_valid, device="cuda"):
    """Seeded score-sorted candidate lists: boxes 30-90 px wide over a
    600 px square in 10 class-offset groups, scores from 200 levels (ties),
    rows past each image's ``n_valid`` invalid."""
    import torch
    rng = np.random.RandomState(seed)
    xy = rng.rand(bsz, n, 2) * 600
    wh = rng.rand(bsz, n, 2) * 60 + 30
    off = rng.randint(0, 10, (bsz, n, 1)) * 4096.0
    boxes = np.concatenate([xy - wh / 2 + off, xy + wh / 2 + off], 2).astype(np.float32)
    scores = np.sort(rng.randint(1, 200, (bsz, n)).astype(np.float32) / 200, 1)[:, ::-1].copy()
    for b, v in enumerate(n_valid or ()):
        scores[b, v:] = 0.0
    return (torch.from_numpy(boxes).to(device), torch.from_numpy(scores).to(device))


def k3_list(kind: str, device="cuda"):
    """K3's (1024,) list: the serving case's seeded list, the deepest chain
    or the serving list with every row invalid."""
    import torch
    if kind == "chain":
        x = np.arange(1024, dtype=np.float32) * 0.25
        boxes = torch.from_numpy(np.stack([x, 0 * x, x + 1, 0 * x + 1], 1)).to(device)
        return boxes, torch.linspace(1.0, 0.5, 1024, device=device)
    boxes, scores = lists(len(CASES) - 1, 1, 1024, None, device)
    return boxes[0], scores[0] if kind == "serving" else torch.zeros_like(scores[0])


def device_ops(torch, fn) -> int:
    """Device operations (kernels, copies, memsets) one call of ``fn`` issues."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def run_k3(torch, smoke, label: str, full: bool) -> None:
    """K3 of the checkout on sys.path at ``K3_CASES``; a JSON line a case."""
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops import nms as nms_mod
    packed = getattr(K, "nms_packed", None) or (
        lambda b, s, t, m: nms_mod.pack_keep(K.nms(b, s, t), m))
    for kind in K3_CASES:
        boxes, scores = k3_list(kind)
        keep = K.nms(boxes, scores, 0.45)
        idx, valid = packed(boxes, scores, 0.45, 300)
        torch.cuda.synchronize()
        row = {"tree": label, "case": f"k3_{kind}", "shape": [1024], "kept": int(keep.sum()),
               "sha256": _sha(keep, idx.long(), valid),
               "ms": smoke.graph_ms(lambda: K.nms(boxes, scores, 0.45), iters=10),
               "packed_ms": smoke.graph_ms(lambda: packed(boxes, scores, 0.45, 300), iters=10),
               "nms_fixed_device_ops": device_ops(torch, lambda: nms_mod.nms_fixed(
                   boxes[None], scores[None], 0.45, 300))}
        if full:
            from multiyolov5_tpu_torch.ops.kernels.nms import plan
            want_idx, want_valid = K.nms_packed_plain(boxes, scores, 0.45, 300)
            n = boxes.shape[0]
            row.update(plan=plan(n)._asdict(),
                       picks_differing_plain=int(
                           (keep != K.nms_plain(boxes, scores, 0.45)).sum()
                           + (idx != want_idx).sum() + (valid != want_valid).sum()),
                       bound_ms=smoke.bound_ms(21 * n + 9 * 300, smoke.K3_OPS_PER_TEST * n
                                               * (n - 1) / 2 + 3 * n, smoke.FP32_FLOP_S)[0])
        print(json.dumps(row), flush=True)


def sweep_k3(torch, smoke) -> None:
    """K3 at every cluster size at each of ``K3_CASES``."""
    import importlib
    k3 = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.nms")
    for kind in K3_CASES:
        boxes, scores = k3_list(kind)
        want = k3.launch(boxes, scores, 0.45, 300)
        for c in CLUSTERS:
            p = k3.plan(1024, ctas=c)
            got = k3.launch(boxes, scores, 0.45, 300, p=p)
            torch.cuda.synchronize()
            print(json.dumps({
                "case": f"k3_{kind}", "shape": [1024], "plan": p._asdict(),
                "default": p == k3.plan(1024),
                "picks_differing": sum(int((a != b).sum()) for a, b in zip(got, want)),
                "ms": smoke.graph_ms(lambda: k3.launch(boxes, scores, 0.45, 300,
                                                       keep=False, p=p), iters=10)}),
                flush=True)


def _setup(tree: str):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prof_nms_torch: no CUDA device")
    sys.path.insert(0, os.path.abspath(tree))
    return torch, _smoke()


def _sha(*ts) -> str:
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()


def run(tree: str, label: str, full: bool) -> None:
    """Time the K5 of the checkout at ``tree``; print a JSON line a case."""
    torch, smoke = _setup(tree)
    from multiyolov5_tpu_torch.ops import kernels as K
    for i, (name, bsz, n, n_valid, iou, max_det) in enumerate(CASES):
        boxes, scores = lists(smoke.SEED + i, bsz, n, n_valid)
        idx, valid = K.nms_greedy(boxes, scores, iou, max_det)
        torch.cuda.synchronize()
        row = {"tree": label, "case": name, "shape": [bsz, n], "picks": int(valid.sum()),
               "sha256": _sha(idx, valid),
               "ms": smoke.graph_ms(lambda: K.nms_greedy(boxes, scores, iou, max_det),
                                    iters=10)}
        if full:
            from multiyolov5_tpu_torch.ops.kernels.nms_greedy import plan
            want_idx, want_valid = K.nms_greedy_plain(boxes, scores, iou, max_det)
            tests = smoke.greedy_tests(boxes, scores, idx, valid, iou)
            row.update(plan=plan(bsz, n)._asdict(), tests=tests,
                       picks_differing_plain=int((idx != want_idx).sum()
                                                 + (valid != want_valid).sum()),
                       bound_ms=smoke.bound_ms(20 * scores.numel() + 5 * idx.numel(),
                                               smoke.K5_OPS_PER_TEST * tests,
                                               smoke.FP32_FLOP_S)[0])
            row["ms_per_pick"] = row["ms"] / max(row["picks"] / bsz, 1)
        print(json.dumps(row), flush=True)
    run_k3(torch, smoke, label, full)


def sweep(tree: str) -> None:
    """Every plan the kernel could take, at each case of ``SWEEP_CASES``."""
    torch, smoke = _setup(tree)
    import importlib

    from multiyolov5_tpu_torch.ops import kernels as K
    mod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.nms_greedy")
    for i, (name, bsz, n, n_valid, iou, max_det) in enumerate(SWEEP_CASES):
        boxes, scores = lists(smoke.SEED + i, bsz, n, n_valid)
        want = K.nms_greedy(boxes, scores, iou, max_det)
        torch.cuda.synchronize()
        seen = set()
        for c in CLUSTERS:
            for res in (True, False):
                try:
                    p = mod.plan(bsz, n, cluster=c, resident=res)
                except ValueError:
                    continue
                if p in seen:
                    continue
                seen.add(p)
                row = {"case": name, "shape": [bsz, n], "plan": p._asdict(),
                       "default": p == mod.plan(bsz, n)}
                try:
                    got = mod.launch(boxes, scores, iou, max_det, p)
                    torch.cuda.synchronize()
                except RuntimeError as e:           # a cluster the card cannot place
                    row["error"] = str(e)
                    print(json.dumps(row), flush=True)
                    continue
                row.update(picks_differing=int((got[0] != want[0]).sum()
                                               + (got[1] != want[1]).sum()),
                           ms=smoke.graph_ms(
                               lambda: mod.launch(boxes, scores, iou, max_det, p),
                               iters=10))
                print(json.dumps(row), flush=True)
    sweep_k3(torch, smoke)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="another checkout's root, timed in turns with this one")
    ap.add_argument("--sweep", action="store_true", help="time every plan the kernel takes")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        if args.sweep:
            sweep(args.tree)
        else:
            run(args.tree, args.label, full=args.label == "this")
        return 0
    if args.sweep:
        order, name = [(ROOT, "this")], "prof_nms_sweep.json"
    else:
        order = ([(args.against, "other"), (ROOT, "this"), (ROOT, "this"),
                  (args.against, "other")] if args.against else [(ROOT, "this")])
        name = "prof_nms.json"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    for tree, label in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                              os.path.abspath(tree), "--label", label]
                             + (["--sweep"] if args.sweep else []),
                             capture_output=True, text=True)
        out = res.stdout
        print(out, end="", flush=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr, flush=True)
            return res.returncode
        rows += [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as fh:
        json.dump({"card": smi, "rows": rows}, fh, indent=1)
    bad = [r["case"] for r in rows if r.get("picks_differing_plain", 0)
           or r.get("picks_differing", 0)]
    if args.against:
        sha = {}
        for r in rows:
            sha.setdefault(r["case"], set()).add(r["sha256"])
        bad += [c for c, v in sha.items() if len(v) != 1]
        print(f"picks bitwise equal across trees: {not any(len(v) != 1 for v in sha.values())}",
              flush=True)
    if bad:
        print(f"picks differ at {sorted(set(bad))}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
