"""Time K4 (the fused upsample + argmax class map,
``multiyolov5_tpu_torch/csrc/upsample_argmax.cu``) at the paths' shapes on
one NVIDIA GPU, optionally against another checkout.

    python3 prof_mask_torch.py                   # this checkout
    python3 prof_mask_torch.py --against DIR     # DIR, this, this, DIR
    python3 prof_mask_torch.py --sweep           # every plan the kernel could take

Cases (``CASES``, seeded with numpy, the same in every tree): bs1 serving's
(1, 19, 64, 128) bf16 logits -> 1024x2048 through the seg head's x8
(512x1024), ``seg_validation``'s bs4 float32 batch of the same geometry,
and the bs8 server's (8, 19, 128, 128) bf16 logits of letterboxed
1024x1024 frames -> 1024x2048.  Each run prints one JSON line a case: the
kernel's device ms (CUDA graph replay) and the SHA-256 of its class map;
for this checkout also its plan, the mismatched pixel share against the
plain version (at most ``chip_smoke.py``'s MASK_SHARE), whether a second
launch gave the same map bit for bit, the plain version's ms and
``chip_smoke.py``'s bound.  With ``--against``, the two trees run in
turns in separate processes (each builds its own kernels into its own
``build/kernels``), so both are timed on the same card within one call.
``--sweep`` times every tile of ``TILES`` that takes each case and
requires its map to be bitwise the default plan's.  Prints the card's name
and power limit first; writes ``chiprun_out/prof_mask.json``
(``prof_mask_sweep.json``).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# (name, logits shape, dtype, out_hw, via_hw)
CASES = [("bs1_bf16", (1, 19, 64, 128), "bfloat16", (1024, 2048), (512, 1024)),
         ("bs4_fp32", (4, 19, 64, 128), "float32", (1024, 2048), (512, 1024)),
         ("bs8_bf16", (8, 19, 128, 128), "bfloat16", (1024, 2048), (1024, 1024))]


def _smoke():
    """chip_smoke.py of this checkout (its timing helpers and bounds)."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(tree: str):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prof_mask_torch: no CUDA device")
    sys.path.insert(0, os.path.abspath(tree))
    return torch, _smoke()


def logits(torch, i: int, shape, dtype: str):
    rng = np.random.RandomState(i)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to("cuda",
                                                                     getattr(torch, dtype))


def _sha(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def run(tree: str, label: str, full: bool) -> None:
    """Time the K4 of the checkout at ``tree``; print a JSON line a case."""
    torch, smoke = _setup(tree)
    from multiyolov5_tpu_torch.ops import kernels as K
    for i, (name, shape, dtype, out_hw, via_hw) in enumerate(CASES):
        x = logits(torch, i, shape, dtype)
        got = K.upsample_argmax(x, out_hw, via_hw=via_hw)
        torch.cuda.synchronize()
        row = {"tree": label, "case": name, "shape": list(shape), "dtype": dtype,
               "sha256": _sha(got),
               "ms": smoke.graph_ms(lambda: K.upsample_argmax(x, out_hw, via_hw=via_hw))}
        if full:
            k4 = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.upsample_argmax")
            want = K.upsample_argmax_plain(x, out_hw, via_hw)
            again = K.upsample_argmax(x, out_hw, via_hw=via_hw)
            bound, by = smoke.k4_bound(x, out_hw, via_hw)
            row.update(plan=k4.plan(shape[0], shape[1], *shape[2:], out_hw, via_hw)._asdict(),
                       share=(got != want).float().mean().item(),
                       repeat_equal=bool(torch.equal(got, again)),
                       plain_ms=smoke.graph_ms(
                           lambda: K.upsample_argmax_plain(x, out_hw, via_hw), iters=5),
                       bound_ms=bound, bound_by=by)
        print(json.dumps(row), flush=True)


def sweep(tree: str) -> None:
    """Every tile of ``TILES`` that takes each case."""
    torch, smoke = _setup(tree)
    from multiyolov5_tpu_torch.ops import kernels as K
    k4 = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.upsample_argmax")
    for i, (name, shape, dtype, out_hw, via_hw) in enumerate(CASES):
        x = logits(torch, i, shape, dtype)
        want = K.upsample_argmax(x, out_hw, via_hw=via_hw)
        default = k4.plan(shape[0], shape[1], *shape[2:], out_hw, via_hw)
        for tile in k4.TILES:
            try:
                p = k4.plan(shape[0], shape[1], *shape[2:], out_hw, via_hw, tile=tile)
            except ValueError:
                continue
            got = k4.launch(x, out_hw, via_hw, p)
            torch.cuda.synchronize()
            print(json.dumps({"case": name, "plan": p._asdict(), "default": p == default,
                              "pixels_differing": int((got != want).sum()),
                              "ms": smoke.graph_ms(lambda: k4.launch(x, out_hw, via_hw, p))}),
                  flush=True)


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
        order, name = [(ROOT, "this")], "prof_mask_sweep.json"
    else:
        order = ([(args.against, "other"), (ROOT, "this"), (ROOT, "this"),
                  (args.against, "other")] if args.against else [(ROOT, "this")])
        name = "prof_mask.json"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    for tree, label in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                              os.path.abspath(tree), "--label", label]
                             + (["--sweep"] if args.sweep else []),
                             capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr, flush=True)
            return res.returncode
        rows += [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as fh:
        json.dump({"card": smi, "rows": rows}, fh, indent=1)
    smoke = _smoke()
    bad = [r["case"] for r in rows
           if r.get("share", 0) > smoke.MASK_SHARE or r.get("repeat_equal") is False
           or r.get("pixels_differing", 0)]
    if bad:
        print(f"class maps off at {sorted(set(bad))}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
