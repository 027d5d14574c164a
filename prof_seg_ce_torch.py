"""Time K6 (the fused x8-upsample cross-entropy, ``multiyolov5_tpu_torch/csrc/seg_ce.cu``)
at the train step's shapes on one NVIDIA GPU, optionally against another
checkout.

    python3 prof_seg_ce_torch.py                   # this checkout
    python3 prof_seg_ce_torch.py --against DIR     # DIR, this, this, DIR
    python3 prof_seg_ce_torch.py --sweep           # every forward and backward tile

Cases: the train step's seg loss, (8, 19, 64, 128) logits -> (8, 512, 1024)
labels, in bf16 and in float32 (the step's two compute types), the logits
seeded normal and channels last as the seg head gives them, the labels
seeded in [-1, 19) as ``chip_smoke.py``'s train batch, unit class weights
as the step passes them.  Each run prints one JSON line a case: the
forward's and the backward's device ms (CUDA graph replay of the kernels'
entry points, in the layout the checkout's kernels read), the SHA-256 of
the loss and of dz from the autograd wrapper (dz made planar), and whether
a second call gave bitwise the same dz; for this checkout also the plan,
``chip_smoke.py``'s bound, the loss's and dz's error against the plain
version, and the plain version's and ``F.interpolate`` +
``F.cross_entropy``'s forward + backward ms.  With ``--against``, the two
trees run in turns in separate processes (each builds its own kernels
into its own ``build/kernels``), so both are timed on the same card within
one call.  ``--sweep`` times every tile of ``FWD_PLANS`` and ``BWD_PLANS``
at both cases and requires the logsumexps (forward) and dz (backward) to
be bitwise the default plan's.  Prints the card's name and power limit
first; writes ``chiprun_out/prof_seg_ce.json`` (``prof_seg_ce_sweep.json``).
Fails if a checkout's dz is not repeatable, or this checkout is off the
plain version by more than ``chip_smoke.py``'s bounds.
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
SHAPE, LABELS = (8, 19, 64, 128), (512, 1024)
UPSTREAM = 8 * 0.5      # the step's seg loss scale: batch x seggain (chip_smoke.py [7])


def _smoke():
    """chip_smoke.py of this checkout (its timing helpers and bounds)."""
    spec = importlib.util.spec_from_file_location("_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(tree: str):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prof_seg_ce_torch: no CUDA device")
    sys.path.insert(0, os.path.abspath(tree))
    return torch, _smoke()


def inputs(torch, dtype, seed: int):
    """(channels-last z, int64 labels, float32 unit weights) on the card."""
    rng = np.random.RandomState(seed)
    z = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)).to("cuda", dtype)
    y = torch.from_numpy(rng.randint(-1, SHAPE[1], (SHAPE[0], *LABELS))).to("cuda")
    w = torch.ones(SHAPE[1], dtype=torch.float32, device="cuda")
    return z.contiguous(memory_format=torch.channels_last), y, w


def _sha(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _wrapper(fn, torch, z, y, w):
    """(loss, planar dz) of ``fn`` forward and backward, the step's upstream."""
    zz = z.detach().clone().requires_grad_(True)
    loss = fn(zz, y, w)
    (loss * UPSTREAM).backward()
    torch.cuda.synchronize()
    return loss.detach(), zz.grad.contiguous()


def _entry_layout(K, torch, z, y32, w):
    """z in the layout this checkout's kernel entry points read."""
    try:
        K.seg_ce_forward(z, y32, w)
        return z
    except ValueError:                     # a checkout whose kernels read planar logits
        return z.contiguous()


def run(tree: str, label: str, full: bool) -> None:
    """Time the K6 of the checkout at ``tree``; print a JSON line a case."""
    torch, smoke = _setup(tree)
    from multiyolov5_tpu_torch.ops import kernels as K
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        z, y, w = inputs(torch, dtype, smoke.SEED + 9)
        y32 = y.to(torch.int32)
        ze = _entry_layout(K, torch, z, y32, w)
        stats, lse = K.seg_ce_forward(ze, y32, w)
        g = torch.full((1,), UPSTREAM, dtype=torch.float32, device="cuda")
        (l1, d1), (l2, d2) = (_wrapper(K.seg_ce, torch, z, y, w),
                              _wrapper(K.seg_ce, torch, z, y, w))
        row = {"tree": label, "case": name, "shape": list(SHAPE), "labels": list(LABELS),
               "layout": "channels_last" if ze is z else "planar",
               "fwd_ms": smoke.graph_ms(lambda: K.seg_ce_forward(ze, y32, w)),
               "bwd_ms": smoke.graph_ms(lambda: K.seg_ce_backward(ze, y32, w, lse, stats, g)),
               "loss_sha256": _sha(l1), "dz_sha256": _sha(d1),
               "repeatable": bool(torch.equal(l1, l2) and torch.equal(d1, d2))}
        row["ms"] = row["fwd_ms"] + row["bwd_ms"]
        if full:
            import torch.nn.functional as F
            mod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.seg_ce")
            lp, gp = _wrapper(K.seg_ce_plain, torch, z, y, w)
            d = (d1.float() - gp.float()).abs().max().item()

            def plain():
                zz = z.detach().requires_grad_(True)
                (K.seg_ce_plain(zz, y) * UPSTREAM).backward()

            def library():
                zz = z.detach().requires_grad_(True)
                up = F.interpolate(zz, size=LABELS, mode="bilinear", align_corners=True)
                (F.cross_entropy(up, y, ignore_index=-1) * UPSTREAM).backward()

            bound, by = smoke.k6_bound(z, y)
            row.update(plan=mod.plan(*SHAPE, *LABELS, dtype)._asdict(), bound_ms=bound,
                       bound_by=by, loss_rel=abs(l1.item() - lp.item()) / abs(lp.item()),
                       dz_max_abs=d, dz_rel=d / gp.float().abs().max().item(),
                       plain_ms=smoke.cuda_ms(plain, iters=10, warmup=2),
                       library_ms=smoke.cuda_ms(library, iters=10, warmup=2))
            row["ok"] = (row["loss_rel"] <= smoke.SEG_CE_LOSS_REL
                         and row["dz_rel"] <= smoke.SEG_CE_DZ_REL[dtype])
        print(json.dumps(row), flush=True)


def sweep(tree: str) -> None:
    """Every forward and backward tile of the plan tables, at both cases."""
    torch, smoke = _setup(tree)
    from multiyolov5_tpu_torch.ops import kernels as K
    mod = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.seg_ce")
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        z, y, w = inputs(torch, dtype, smoke.SEED + 9)
        y32 = y.to(torch.int32)
        g = torch.full((1,), UPSTREAM, dtype=torch.float32, device="cuda")
        base = mod.plan(*SHAPE, *LABELS, dtype)
        stats, lse = K.seg_ce_forward(z, y32, w, p=base)
        want = K.seg_ce_backward(z, y32, w, lse, stats, g, p=base)
        torch.cuda.synchronize()
        runs = [("fwd", t, mod.plan(*SHAPE, *LABELS, dtype, fwd=t)) for t in mod.FWD_PLANS]
        runs += [("bwd", t, mod.plan(*SHAPE, *LABELS, dtype, bwd=t)) for t in mod.BWD_PLANS]
        for kind, t, p in runs:
            q = p.fwd if kind == "fwd" else p.bwd
            row = {"case": name, "pass": kind, "tile": list(t), "plan": q._asdict(),
                   "default": q == (base.fwd if kind == "fwd" else base.bwd)}
            if kind == "fwd":
                got = K.seg_ce_forward(z, y32, w, p=p)[1]
                row["ms"] = smoke.graph_ms(lambda: K.seg_ce_forward(z, y32, w, p=p))
                row["bitwise_default"] = bool(torch.equal(got, lse))
            else:
                got = K.seg_ce_backward(z, y32, w, lse, stats, g, p=p)
                row["ms"] = smoke.graph_ms(
                    lambda: K.seg_ce_backward(z, y32, w, lse, stats, g, p=p))
                row["bitwise_default"] = bool(torch.equal(got, want))
            print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="another checkout's root, timed in turns with this one")
    ap.add_argument("--sweep", action="store_true", help="time every tile of the plan tables")
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
        order, name = [(ROOT, "this")], "prof_seg_ce_sweep.json"
    else:
        order = ([(args.against, "other"), (ROOT, "this"), (ROOT, "this"),
                  (args.against, "other")] if args.against else [(ROOT, "this")])
        name = "prof_seg_ce.json"
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
    if args.sweep:
        bad = [(r["case"], r["pass"], r["tile"]) for r in rows if not r["bitwise_default"]]
    else:
        bad = [(r["tree"], r["case"]) for r in rows
               if not r["repeatable"] or not r.get("ok", True)]
        for case in ("bf16", "fp32"):
            for tree in ("other", "this"):
                ms = [r for r in rows if r["tree"] == tree and r["case"] == case]
                if ms:
                    print(f"{case} {tree}: forward {[round(r['fwd_ms'], 4) for r in ms]} ms, "
                          f"backward {[round(r['bwd_ms'], 4) for r in ms]} ms", flush=True)
    if bad:
        print(f"failed: {bad}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
