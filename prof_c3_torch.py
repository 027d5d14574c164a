"""Time K7 (the fused C3, ``multiyolov5_tpu_torch/csrc/c3.cu``) at the
batched paths' shapes on one NVIDIA GPU, optionally against another
checkout.

    python3 prof_c3_torch.py [--dtype bfloat16]              # this checkout
    python3 prof_c3_torch.py [--dtype bfloat16] --against DIR   # DIR, this, this, DIR
    python3 prof_c3_torch.py [--dtype bfloat16] --sweep      # every plan that fits
    python3 prof_c3_torch.py --accuracy [--against DIR]      # float32 against float64

Cases (``CASES``): eval's pspv5s row-2 C3 (4, 128, 256, 64), c_ 32, one
bottleneck; pspv5m's (2, 256, 256, 96), c_ 48, two bottlenecks (bs2
1024x1024); serving's pspv5s (8, 256, 256, 64) (bs8 1024x1024); with
``--dtype bfloat16`` also pspv5m's bs8 (8, 256, 256, 96).  Each case takes
``chip_smoke.c3_case``'s seeded float32 weights, and their bf16 casts.
Each run prints one JSON line a case: K7's device ms (CUDA graph replay)
in ``--dtype`` (float32 by default), the SHA-256 of its float32 output,
and the max |diff| / max(max |ref|, 1) of both forms against
``c3_plain`` in their own dtype; for this checkout also the plain
version, the module's unfused cuDNN sequence (TF32 off) and
``chip_smoke.c3_bound``'s bound in that dtype (in float32 also the CUDA
cores' float32 bound).  With ``--against``, the two trees run in turns in
separate processes (each builds its own kernels into its own
``build/kernels``), so both are timed on the same card within one call;
the float32 outputs must be bitwise equal across the trees, and the bf16
output of each tree within ``chip_smoke.BF16_REL`` of ``c3_plain``.
``--sweep`` times every launch plan of ``--dtype`` that fits in shared
memory at each case (float32: tile, weight buffers, weight rows a pass;
bfloat16: the tile, the grid as ``plan`` sets it).  Writes
``chiprun_out/prof_c3.json`` (``prof_c3_sweep.json``,
``prof_c3_accuracy.json``).

``--accuracy`` holds K7's float32 form against ``c3_plain`` in float64 on
the card, on yolov5s_city_seg's and yolov5m_city_seg's seeded row-2 C3s
(seed 0) with their real row-2 input (K1 on chip_smoke.py's first four
512x1024 uint8 frames), beside ``c3_plain`` in float32 on the card (cuDNN,
TF32 off) and on the CPU: max |error| and rms error over the output's max
|value|, and the gain error (the least-squares slope of the error on the
reference, which a bias toward zero makes negative).  With ``--against``,
DIR's K7 is held the same way first.
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
# (name, x shape, c_, bottlenecks)
CASES = [("eval", (4, 128, 256, 64), 32, 1), ("pspv5m", (2, 256, 256, 96), 48, 2),
         ("serving", (8, 256, 256, 64), 32, 1)]
BF16_CASES = CASES + [("pspv5m bs8", (8, 256, 256, 96), 48, 2)]
SWEEP = {"float32": [(th, tw, nbuf, rows) for th in (4, 8, 16) for tw in (8, 16, 32)
                     for nbuf in (2, 1) for rows in (0, 32, 16)],
         "bfloat16": [(th, tw, 1, 0) for th in (4, 8, 16) for tw in (8, 16, 32)]}


def _smoke():
    """chip_smoke.py of this checkout (its timing helpers and bounds)."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(tree: str):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prof_c3_torch: no CUDA device")
    sys.path.insert(0, os.path.abspath(tree))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch, _smoke()


def _cases(torch, smoke, dtype: str):
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    for name, shape, ch, n in (BF16_CASES if dtype == "bfloat16" else CASES):
        yield (name, *smoke.c3_case(g, shape, ch, n, torch.float32))


def _bf16(torch, args):
    cast = lambda t: t.to(torch.bfloat16) if t.dim() == 4 else t   # noqa: E731
    return (*[cast(t) for t in args[:6]], [tuple(cast(t) for t in m) for m in args[6]], args[7])


def run(tree: str, label: str, full: bool, dtype: str) -> None:
    """Time the K7 of the checkout at ``tree`` in ``dtype``; print a JSON
    line a case."""
    torch, smoke = _setup(tree)
    from multiyolov5_tpu_torch.ops import kernels as K
    for name, x32, args32 in _cases(torch, smoke, dtype):
        y32 = K.c3(x32, *args32)
        torch.cuda.synchronize()
        _, rel32 = smoke.diffs(y32, K.c3_plain(x32, *args32))
        x16, a16 = x32.to(torch.bfloat16), _bf16(torch, args32)
        y16 = K.c3(x16, *a16)
        torch.cuda.synchronize()
        _, rel16 = smoke.diffs(y16, K.c3_plain(x16, *a16))
        x, args = (x16, a16) if dtype == "bfloat16" else (x32, args32)
        row = {"tree": label, "case": name, "dtype": dtype, "x": list(x.shape),
               "c_": args[0].shape[0], "n": len(args[6]), "rel_err": rel32,
               "bf16_rel_err": rel16,
               "f32_sha256": hashlib.sha256(y32.cpu().numpy()).hexdigest(),
               "ms": smoke.graph_ms(lambda: K.c3(x, *args), iters=10)}
        if full:
            row.update(
                plain_ms=smoke.graph_ms(lambda: K.c3_plain(x, *args), iters=10),
                library_ms=smoke.c3_sequence_ms(smoke.c3_module(args), x),
                bound_ms=smoke.c3_bound(x, args)[0])
            if dtype == "float32":
                row["cuda_core_bound_ms"] = smoke.c3_bound(x, args, cuda_cores=True)[0]
        print(json.dumps(row), flush=True)


def sweep(tree: str, dtype: str) -> None:
    """Every plan of ``SWEEP[dtype]`` that fits, at each case."""
    torch, smoke = _setup(tree)
    import importlib

    from multiyolov5_tpu_torch.ops import kernels as K
    c3mod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.c3")
    dt = getattr(torch, dtype)
    planned = c3mod.PLANS[dt]
    for name, x, args in _cases(torch, smoke, dtype):
        if dt == torch.bfloat16:
            x, args = x.to(dt), _bf16(torch, args)
        want = K.c3_plain(x, *args)
        widths = (x.shape[-1], args[0].shape[0], args[4].shape[0], len(args[6]))
        for p in SWEEP[dtype]:
            if not c3mod.fits(c3mod.smem_bytes(*widths, *p, dt), dt):
                continue
            c3mod.PLANS[dt] = (p,)
            try:
                got = K.c3(x, *args)
                torch.cuda.synchronize()
                pl = c3mod.plan(*x.shape, *widths[1:], dt,
                                torch.cuda.get_device_properties(0).multi_processor_count)
                row = {"case": name, "dtype": dtype, "plan": list(p), "smem": pl.smem,
                       "ctas": pl.ctas, "rel_err": smoke.diffs(got, want)[1],
                       "ms": smoke.graph_ms(lambda: K.c3(x, *args), iters=10)}
            finally:
                c3mod.PLANS[dt] = planned
            print(json.dumps(row), flush=True)


def accuracy(tree: str, label: str, cfgs) -> None:
    """K7's float32 error against float64 in the checkout at ``tree``."""
    import numpy as np
    torch, smoke = _setup(tree)
    from multiyolov5_tpu_torch.engine import Engine
    from multiyolov5_tpu_torch.ops import kernels as K
    rng = np.random.RandomState(smoke.SEED)
    frames = torch.from_numpy(np.stack([(rng.rand(*smoke.IN_HW, 3) * 255).astype(np.uint8)
                                        for _ in range(4)]))
    for cfg in cfgs:
        eng = Engine(cfg=cfg, device="cuda", half=False, seed=smoke.SEED)
        args = smoke.c3_row(eng).kernel_args()
        x = K.stem(frames.cuda(), *eng.stem_weights)        # the row-2 input
        a64 = tuple(t.double() if torch.is_tensor(t) else t for t in args[:6])
        m64 = [tuple(t.double() for t in m) for m in args[6]]
        ref = K.c3_plain(x.double(), *a64, m64, args[7])
        cpu = (*[t.cpu() for t in args[:6]], [tuple(t.cpu() for t in m) for m in args[6]],
               args[7])
        outs = {"K7": K.c3(x, *args)}
        if label == "this":
            outs["c3_plain card"] = K.c3_plain(x, *args)
            outs["c3_plain CPU"] = K.c3_plain(x.cpu(), *cpu).cuda()
        scale = ref.abs().max().item()
        for name, y in outs.items():
            d = y.double() - ref
            print(json.dumps({
                "tree": label, "cfg": cfg, "x": list(x.shape), "c_": args[0].shape[0],
                "n": len(args[6]), "version": name, "max_rel": d.abs().max().item() / scale,
                "rms_rel": d.pow(2).mean().sqrt().item() / scale,
                "gain": (d * ref).sum().item() / ref.pow(2).sum().item()}), flush=True)
        del eng


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="another checkout's root, timed in turns with this one")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the form to time (default float32)")
    ap.add_argument("--sweep", action="store_true", help="time every plan that fits")
    ap.add_argument("--accuracy", action="store_true",
                    help="K7's float32 error against float64")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        if args.accuracy:
            accuracy(args.tree, args.label, ("yolov5s_city_seg", "yolov5m_city_seg"))
        elif args.sweep:
            sweep(args.tree, args.dtype)
        else:
            run(args.tree, args.label, args.label == "this", args.dtype)
        return 0
    if args.sweep:
        order, name = [(ROOT, "this")], "prof_c3_sweep.json"
    elif args.accuracy:
        order = ([(args.against, "other")] if args.against else []) + [(ROOT, "this")]
        name = "prof_c3_accuracy.json"
    else:
        order = ([(args.against, "other"), (ROOT, "this"), (ROOT, "this"),
                  (args.against, "other")] if args.against else [(ROOT, "this")])
        name = "prof_c3.json"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    for tree, label in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                              os.path.abspath(tree), "--label", label]
                             + (["--accuracy"] if args.accuracy else [])
                             + (["--sweep"] if args.sweep else []) + ["--dtype", args.dtype],
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
    if args.sweep or args.accuracy:
        return 0
    # the float32 form is not redesigned here: its output must be the other
    # tree's, bit for bit; the bf16 form's holds c3_plain at chip_smoke's bound
    bound = _smoke().BF16_REL
    sha = {}
    for r in rows:
        sha.setdefault(r["case"], set()).add(r["f32_sha256"])
    differ = [c for c, v in sha.items() if len(v) != 1]
    off = [(r["tree"], r["case"], r["bf16_rel_err"]) for r in rows if r["bf16_rel_err"] > bound]
    if args.against:
        print(f"float32 outputs bitwise equal across trees: {not differ}"
              + (f" (differ: {differ})" if differ else ""), flush=True)
    print(f"bf16 outputs within {bound} of c3_plain: {not off}" + (f" ({off})" if off else ""),
          flush=True)
    return 1 if differ or off else 0


if __name__ == "__main__":
    sys.exit(main())
