"""Time K2's float32 form (the 3xTF32 3x3 conv of
``multiyolov5_tpu_torch/csrc/conv3x3.cu``) at eval's and pspv5x's sites on
one NVIDIA GPU, optionally against another checkout.

    python3 prof_conv3x3_torch.py                    # this checkout
    python3 prof_conv3x3_torch.py --against DIR      # DIR, this, this, DIR
    python3 prof_conv3x3_torch.py --sweep            # every float32 plan that fits
    python3 prof_conv3x3_torch.py --accuracy [--against DIR]   # against float64
    python3 prof_conv3x3_torch.py --tree DIR --label NAME      # an edited copy alone

Sites (``SETS``): the K2 launches of one seeded forward, recorded with
``chip_smoke.record_path_inputs`` on the seeded ``Engine``'s fused weights:
pspv5s (yolov5s_city_seg) at eval's bs4 1024x512 (10 sites) and pspv5x
(yolov5x_city_seg) at bs1 1024x512 (22 sites), each on a seeded unit-normal
input.  Each run prints one JSON line a site: K2's float32 device ms (CUDA
graph replay), its plan and its max |diff| / max(max |ref|, 1) against
``conv3x3_plain``; for this checkout also cuDNN float32 (TF32 off) and
``chip_smoke.conv_bound``'s bounds (3xTF32, and float32 on the CUDA cores).
A line a set gives the sums and the SHA-256 of its float32 outputs, and
one the SHA-256 of K2's bf16 outputs at pspv5s's 10 bs1 sites.  With
``--against``, the two trees run in turns in separate processes (each
builds its own kernels into its own ``build/kernels``), so both are timed
on the same card within one call, and the float32 and bf16 outputs must
be bitwise equal.  ``--sweep`` times every
float32 launch plan (tile, channels, split) at each distinct site and
holds each to ``chip_smoke.F32_REL`` (the failures raised together at
the end).  ``--accuracy`` holds each site's
float32 K2 against ``conv3x3_plain`` in float64 on the card, beside cuDNN
float32: max |error| and rms error over the output's max |value|, and the
gain error (the least-squares slope of the error on the reference).
Writes ``chiprun_out/prof_conv3x3.json`` (``prof_conv3x3_sweep.json``,
``prof_conv3x3_accuracy.json``).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# (set, configuration, batch)
SETS = (("eval", "yolov5s_city_seg", 4), ("pspv5x", "yolov5x_city_seg", 1))
# the float32 tiles csrc/conv3x3.cu has (8 x bm/8 px, bn channels), and splits
TILES = ((64, 64), (128, 64), (64, 128))
SPLITS = (1, 2, 3, 4, 6, 8)


def _smoke():
    """chip_smoke.py of this checkout (its timing helpers and bounds)."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(tree: str):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prof_conv3x3_torch: no CUDA device")
    sys.path.insert(0, os.path.abspath(tree))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch, _smoke()


def _frame(smoke):
    import numpy as np
    rng = np.random.RandomState(smoke.SEED)
    return (rng.rand(*smoke.IN_HW, 3) * 255).astype(np.uint8)


def _sites(torch, smoke, cfg: str, bsz: int, half: bool = False):
    """[(x, w, b, stride, dilation, act)] of K2's launches in one forward of
    ``cfg`` at ``bsz``: the engine's fused weights, seeded inputs."""
    from multiyolov5_tpu_torch.engine import Engine
    eng = Engine(cfg=cfg, device="cuda", half=half, seed=smoke.SEED)
    recorded, _ = smoke.record_path_inputs(eng, _frame(smoke))
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 3)
    dt = torch.bfloat16 if half else torch.float32
    return [(torch.randn((bsz, *shape[1:]), generator=g, device="cuda").to(dt), w, b, s, d, act)
            for shape, co, s, d, act, w, b in recorded]


def _plan(x, w, s, d):
    from multiyolov5_tpu_torch.ops.kernels.conv3x3 import plan
    bsz, h, wd, ci = x.shape
    return plan(bsz, (h - 1) // s + 1, (wd - 1) // s + 1, ci, w.shape[0], x.dtype, s, d)


def run(tree: str, label: str, full: bool) -> None:
    """Time the float32 K2 of the checkout at ``tree``; print a JSON line a
    site and one a set."""
    torch, smoke = _setup(tree)
    import torch.nn.functional as F

    from multiyolov5_tpu_torch.ops import kernels as K
    for name, cfg, bsz in SETS:
        total = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "cuda_core_bound_ms": 0.0}
        h32 = hashlib.sha256()
        sites = _sites(torch, smoke, cfg, bsz)
        for i, (x, w, b, s, d, act) in enumerate(sites):
            got = K.conv3x3(x, w, b, s, d, act)
            torch.cuda.synchronize()
            h32.update(got.cpu().numpy().tobytes())
            p = _plan(x, w, s, d)
            row = {"tree": label, "set": name, "site": i, "x": list(x.shape),
                   "c_out": w.shape[0], "stride": s, "dilation": d,
                   "plan": f"bm {p.bm} bn {p.bn} bk {p.bk} split {p.split}, {p.ctas} CTAs",
                   "rel_err": smoke.diffs(got, K.conv3x3_plain(x, w, b, s, d, act))[1],
                   "ms": smoke.graph_ms(lambda: K.conv3x3(x, w, b, s, d, act), iters=10)}
            if full:
                xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
                # few repetitions: cuDNN float32 takes ~75 ms at FFM's site
                row.update(library_ms=smoke.graph_ms(lambda: F.conv2d(xc, wc, b, s, d, d),
                                                     iters=3, replays=2),
                           bound_ms=smoke.conv_bound(x, w.shape[0], s)[0],
                           cuda_core_bound_ms=smoke.conv_bound(x, w.shape[0], s, True)[0])
            for k in total:
                total[k] += row.get(k, 0.0)
            print(json.dumps(row), flush=True)
        del sites
        print(json.dumps({"tree": label, "set": name, "sites": i + 1, "sum": total,
                          "f32_sha256": h32.hexdigest()}), flush=True)
    # the bf16 form is not redesigned: its outputs at pspv5s's bs1 sites
    h = hashlib.sha256()
    for x, w, b, s, d, act in _sites(torch, smoke, "yolov5s_city_seg", 1, half=True):
        h.update(K.conv3x3(x, w, b, s, d, act).view(torch.int16).cpu().numpy().tobytes())
    print(json.dumps({"tree": label, "set": "bf16", "bf16_sha256": h.hexdigest()}), flush=True)


def sweep(tree: str) -> None:
    """Every float32 plan (``TILES`` x ``SPLITS``) at each distinct site of
    ``SETS``."""
    torch, smoke = _setup(tree)
    import importlib

    from multiyolov5_tpu_torch.ops import kernels as K
    kmod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.conv3x3")
    seen, failed = set(), []
    for name, cfg, bsz in SETS:
        for x, w, b, s, d, act in _sites(torch, smoke, cfg, bsz):
            key = (tuple(x.shape), w.shape[0], s)
            if key in seen:              # the dilation does not change the plan
                continue
            seen.add(key)
            bsz_, h, wd, ci = x.shape
            co = w.shape[0]
            ho, wo = (h - 1) // s + 1, (wd - 1) // s + 1
            planned = _plan(x, w, s, d)
            want = K.conv3x3_plain(x, w, b, s, d, act)
            nk = 9 * ci // planned.bk
            res = []
            for bm, bn in TILES:
                if bn == 128 and co % 128:
                    continue
                tiles = bsz_ * -(-ho // 8) * -(-wo // (bm // 8)) * -(-co // bn)
                for split in SPLITS:
                    if split > max(1, nk // 2):
                        continue
                    p = kmod.Plan(bm, bn, planned.bk, split, tiles, tiles * split,
                                  -(-nk // split))
                    got = kmod._launch(x, w, b, s, d, act, p)
                    torch.cuda.synchronize()
                    rel = smoke.diffs(got, want)[1]
                    if rel > smoke.F32_REL:
                        failed.append((key, bm, bn, split, rel))
                    res.append({"bm": bm, "bn": bn, "split": split, "ctas": tiles * split,
                                "rel_err": rel, "ms": smoke.graph_ms(
                                    lambda: kmod._launch(x, w, b, s, d, act, p),
                                    iters=10, replays=3)})
            res.sort(key=lambda r: r["ms"])
            mine = next(r for r in res if (r["bm"], r["bn"], r["split"])
                        == (planned.bm, planned.bn, planned.split))
            print(json.dumps({"set": name, "x": list(x.shape), "c_out": co, "stride": s,
                              "bk": planned.bk, "planned": mine, "plans": res}), flush=True)
    # every plan is held to F32_REL; the failures are raised together
    if failed:
        raise AssertionError(f"{len(failed)} plan(s) past F32_REL {smoke.F32_REL}: {failed}")


def accuracy(tree: str, label: str) -> None:
    """Float32 K2 (and, for this checkout, cuDNN float32) against float64."""
    torch, smoke = _setup(tree)
    from multiyolov5_tpu_torch.ops import kernels as K
    for name, cfg, bsz in SETS:
        for i, (x, w, b, s, d, act) in enumerate(_sites(torch, smoke, cfg, bsz)):
            ref = K.conv3x3_plain(x.double(), w.double(), b.double(), s, d, act)
            outs = {"K2": K.conv3x3(x, w, b, s, d, act)}
            if label == "this":
                outs["cuDNN fp32"] = K.conv3x3_plain(x, w, b, s, d, act)
            scale = ref.abs().max().item()
            for version, y in outs.items():
                e = y.double() - ref
                print(json.dumps({
                    "tree": label, "set": name, "site": i, "x": list(x.shape),
                    "c_out": w.shape[0], "stride": s, "dilation": d, "version": version,
                    "max_rel": e.abs().max().item() / scale,
                    "rms_rel": e.pow(2).mean().sqrt().item() / scale,
                    "gain": (e * ref).sum().item() / ref.pow(2).sum().item()}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="another checkout's root, timed in turns with this one")
    ap.add_argument("--sweep", action="store_true", help="time every float32 plan")
    ap.add_argument("--accuracy", action="store_true",
                    help="K2's float32 error against float64")
    ap.add_argument("--tree", help="time (only) the checkout at this root, e.g. an edited copy")
    ap.add_argument("--label", default="this", help="the tree's name in the output")
    args = ap.parse_args()
    if args.tree:
        if args.accuracy:
            accuracy(args.tree, args.label)
        elif args.sweep:
            sweep(args.tree)
        else:
            run(args.tree, args.label, full=args.label == "this")
        return 0
    if args.sweep:
        order, name = [(ROOT, "this")], "prof_conv3x3_sweep.json"
    elif args.accuracy:
        order = ([(args.against, "other")] if args.against else []) + [(ROOT, "this")]
        name = "prof_conv3x3_accuracy.json"
    else:
        order = ([(args.against, "other"), (ROOT, "this"), (ROOT, "this"),
                  (args.against, "other")] if args.against else [(ROOT, "this")])
        name = "prof_conv3x3.json"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    for tree, label in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                              os.path.abspath(tree), "--label", label]
                             + (["--accuracy"] if args.accuracy else [])
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
    if args.against and not args.accuracy:
        # neither form is redesigned: their outputs must be the other tree's, bit for bit
        sha = {r["bf16_sha256"] for r in rows if "bf16_sha256" in r}
        sha32 = {}
        for r in rows:
            if "f32_sha256" in r:
                sha32.setdefault(r["set"], set()).add(r["f32_sha256"])
        same32 = all(len(v) == 1 for v in sha32.values())
        print(f"bf16 outputs bitwise equal across trees: {len(sha) == 1}; float32 outputs: "
              f"{same32}", flush=True)
        if len(sha) != 1 or not same32:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
