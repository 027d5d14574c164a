"""Time K1 (the folded stem, ``multiyolov5_tpu_torch/csrc/stem.cu``) at the
eval path's shapes on one NVIDIA GPU, optionally against another checkout.

    python3 prof_stem_torch.py                    # this checkout
    python3 prof_stem_torch.py --against DIR      # DIR, this, this, DIR
    python3 prof_stem_torch.py --accuracy [--against DIR]   # against float64
    python3 prof_stem_torch.py --channels 1,3,4 [--against DIR]

Seeded random weights at s width (c_mid 128, c_out 64) and x width (320,
160), 512x1024 frames of 3 channels (or each of ``--channels``; DIR runs
3 only) at bs1 and bs4, float32 frames in [0, 1] (w1 unscaled) and uint8
frames (w1 / 255), float32 output.  Each run prints one JSON line a case:
K1's device ms (CUDA graph replay) and its max |diff| / max(max |ref|, 1)
against ``stem_plain``; for this checkout also the plain version, the
cuDNN conv2d pair in float32 (TF32 off), K1's bfloat16 form with its
error, the cuDNN pair in bfloat16 and its bound, and the bounds of
``chip_smoke.stem_bound`` (the 3xTF32 form's, and float32 on the CUDA
cores).  With ``--against``, the two trees run in turns
in separate processes (each builds its own kernels into its own
``build/kernels``), so both are timed on the same card within one call.
Writes ``chiprun_out/prof_stem.json`` (``prof_stem_accuracy.json`` with
``--accuracy``).

``--accuracy`` holds K1's float32 form against the same stem in float64 on
the CPU, on yolov5x_city_seg's and yolov5s_city_seg's seeded engines (seed
0) and chip_smoke.py's first 512x1024 uint8 frame, beside ``stem_plain``
in float32 on the card (cuDNN) and on the CPU: max |error| and rms error
over the output's max |value|, and the gain error (the least-squares
slope of the error on the reference, which a bias toward zero makes
negative).  Each stem, and the float64 stem rounded to float32, then
feeds the card's float32 network, and the obj/cls max |diff| against the
float64 network is printed beside the CPU float32 network's, as
chip_smoke.py [9] measures it.  With ``--against``, DIR's K1 is held the
same way first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CASES = [(width, c_mid, c_out, bsz, mode) for width, c_mid, c_out in (("s", 128, 64),
                                                                      ("x", 320, 160))
         for bsz in (1, 4) for mode in ("float", "uint8")]
BF16_REL = 2e-2     # chip_smoke.py's bound on a bf16 output


def _smoke():
    """chip_smoke.py of this checkout (its timing helpers and bounds)."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(tree: str, label: str, full: bool, channels=(3,)) -> None:
    """Time the K1 of the checkout at ``tree`` on frames of each of
    ``channels``; print a JSON line a case."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prof_stem_torch: no CUDA device")
    sys.path.insert(0, os.path.abspath(tree))
    from multiyolov5_tpu_torch.ops import kernels as K
    smoke = _smoke()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    weights = {}
    for ch in channels:
        g.manual_seed(0 if ch == 3 else ch)      # C = 3: the inputs of every tree
        for width, c_mid, c_out, bsz, mode in CASES:
            if (width, ch) not in weights:    # the C = 3 weights as they always were
                w1 = torch.randn(3, 3, 16 * ch, c_mid, generator=g, device="cuda") * (
                    0.2 * (3 / ch) ** 0.5)
                rest = (torch.randn(c_mid, generator=g, device="cuda") * 0.1,
                        torch.randn(2, 2, c_mid, c_out, generator=g, device="cuda")
                        / (4 * c_mid) ** 0.5,
                        torch.randn(c_out, generator=g, device="cuda") * 0.1)
                weights[width, ch] = {"float": (w1, *rest), "uint8": (w1 / 255, *rest)}
            case(K, smoke, g, label, full, weights[width, ch][mode], width, ch, bsz, mode)


def case(K, smoke, g, label, full, w, width, ch, bsz, mode) -> None:
    """One case of :func:`run`: K1 on a seeded frame of ``ch`` channels."""
    import torch
    frame = (torch.rand((bsz, 512, 1024, ch), generator=g, device="cuda")
             if mode == "float" else
             torch.randint(0, 256, (bsz, 512, 1024, ch), generator=g, device="cuda",
                           dtype=torch.uint8))
    got = K.stem(frame, *w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    _, rel = smoke.diffs(got, K.stem_plain(frame, *w, out_dtype=torch.float32))
    row = {"tree": label, "width": width, "channels": ch, "bs": bsz, "frame": mode,
           "rel_err": rel, "ok": rel <= smoke.F32_REL,
           "ms": smoke.graph_ms(lambda: K.stem(frame, *w, out_dtype=torch.float32), iters=10)}
    if full:
        got = K.stem(frame, *w, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        _, rel16 = smoke.diffs(got, K.stem_plain(frame, *w, out_dtype=torch.bfloat16))
        row.update(bf16_rel_err=rel16, ok=row["ok"] and rel16 <= BF16_REL,
                   bf16_library_ms=smoke.stem_library_ms(frame, w, torch.bfloat16),
                   bf16_bound_ms=smoke.stem_bound(frame, w, torch.bfloat16)[0])
        row.update(
            plain_ms=smoke.graph_ms(lambda: K.stem_plain(frame, *w), iters=10),
            cudnn_fp32_ms=smoke.stem_library_ms(frame, w, torch.float32),
            bf16_ms=smoke.graph_ms(lambda: K.stem(frame, *w, out_dtype=torch.bfloat16),
                                   iters=10),
            bound_ms=smoke.stem_bound(frame, w, torch.float32)[0],
            cuda_core_bound_ms=smoke.stem_bound(frame, w, torch.float32,
                                                cuda_cores=True)[0])
    print(json.dumps(row), flush=True)


def accuracy(tree: str, label: str, cfgs) -> None:
    """K1's float32 error against float64 in the checkout at ``tree``, and
    what it does downstream."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("prof_stem_torch: no CUDA device")
    sys.path.insert(0, os.path.abspath(tree))
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import seeded_state_dict
    from multiyolov5_tpu_torch.ops import kernels as K
    from multiyolov5_tpu_torch.ops.kernels.stem import space_to_depth4
    smoke = _smoke()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(smoke.SEED)
    x = torch.from_numpy((rng.rand(*smoke.IN_HW, 3) * 255).astype(np.uint8)[None])
    for cfg in cfgs:
        spec = load_spec(cfg)
        sd = seeded_state_dict(spec, smoke.SEED)
        card = Engine(spec=spec, state_dict=sd, device="cuda", half=False)
        cpu = Engine(spec=spec, state_dict=sd, device="cpu", half=False)
        w1, b1, w2, b2 = (t.double() for t in cpu.stem_weights)
        y1 = F.silu(F.conv2d(space_to_depth4(x).double(), w1.permute(3, 2, 0, 1), b1,
                             padding=1))
        ref = F.silu(F.conv2d(F.pad(y1, (1, 0, 1, 0)), w2.permute(3, 2, 0, 1), b2)
                     ).permute(0, 2, 3, 1)
        z64, _ = smoke.forward64(cpu, x)
        z_cpu, _ = cpu.forward(x)
        scale = ref.abs().max().item()
        stems = {"K1": K.stem(x.cuda(), *card.stem_weights).cpu(),
                 "stem_plain card": K.stem_plain(x.cuda(), *card.stem_weights).cpu(),
                 "stem_plain CPU": K.stem_plain(x, *cpu.stem_weights),
                 "float64, rounded": ref.float()}
        for name, y in stems.items():
            d = y.double() - ref
            with torch.inference_mode():
                z, _ = card.model(y.cuda().permute(0, 3, 1, 2), start_layer=2)
            row = {"tree": label, "cfg": cfg, "stem": name, "max_rel": d.abs().max().item() / scale,
                   "rms_rel": d.pow(2).mean().sqrt().item() / scale,
                   "gain": (d * ref).sum().item() / ref.pow(2).sum().item(),
                   "net_objcls_vs_f64": (z.cpu()[:, 4:] - z64[:, 4:]).abs().max().item(),
                   "cpu_net_objcls_vs_f64": (z_cpu[:, 4:] - z64[:, 4:]).abs().max().item()}
            print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="another checkout's root, timed in turns with this one")
    ap.add_argument("--accuracy", action="store_true",
                    help="K1's float32 error against float64 and its effect on the network")
    ap.add_argument("--channels", default="3",
                    help="frame channels of this checkout's cases, comma-separated")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree and args.accuracy:
        accuracy(args.tree, args.label, ("yolov5x_city_seg", "yolov5s_city_seg"))
        return 0
    if args.tree:
        run(args.tree, args.label, full=args.tree == ROOT,
            channels=[int(c) for c in args.channels.split(",")])
        return 0
    if args.accuracy:
        order = ([(args.against, "other")] if args.against else []) + [(ROOT, "this")]
    else:
        order = ([(args.against, "other"), (ROOT, "this"), (ROOT, "this"),
                  (args.against, "other")] if args.against else [(ROOT, "this")])
    rows = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for tree, label in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                              os.path.abspath(tree), "--label", label,
                              "--channels", args.channels if tree == ROOT else "3"]
                             + (["--accuracy"] if args.accuracy else []),
                             capture_output=True, text=True, check=True).stdout
        print(out, end="", flush=True)
        rows += [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = "prof_stem_accuracy.json" if args.accuracy else "prof_stem.json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as fh:
        json.dump({"card": smi, "rows": rows}, fh, indent=1)
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
