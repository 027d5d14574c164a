"""Profiling CLI (counterpart of ``multiyolov5_tpu/cli/profile.py``): the
reference's tracing hooks (``Model.forward(profile=True)`` per-row timing,
``utils/torch_utils.profile``, ``model_info``; SURVEY.md §5).

Builds ``Engine(weights, cfg, half=True)``, prints ``model_info`` and times
the bfloat16 forward from row 0 on a zero frame (decode on, no NMS): K2 at
the neck's 3x3s, and K7 at the backbone's narrow C3 when ``--batch-size``
> 1.  ``--layers`` times each row; ``--trace DIR`` writes a
``torch.profiler`` Chrome trace of 10 forwards to
``DIR/profile.pt.trace.json``, which ``tools/trace_report.py`` reads.

``--device`` picks the card: "" (the default) is ``cuda``, a number
``cuda:N``, ``cpu`` runs every kernel's plain version on the CPU.

    python -m multiyolov5_tpu_torch.cli.profile --cfg yolov5s_city_seg \\
        --img-size 512 1024 [--layers] [--trace runs/trace]
"""

from __future__ import annotations

import argparse

import torch

from ..engine import Engine
from ..utils import profiling
from .detect import select_device

TRACE_FORWARDS = 10


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--cfg", type=str, default="yolov5s_city_seg")
    p.add_argument("--img-size", nargs="+", type=int, default=[512, 1024])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--layers", action="store_true", help="time each row of the network")
    p.add_argument("--trace", type=str, default="",
                   help="write a torch.profiler trace to this directory")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", default="", help="cuda device, i.e. 0 or cpu")
    opt = p.parse_args(argv)
    h, w = (opt.img_size * 2)[:2]

    eng = Engine(opt.weights or None, cfg=opt.cfg, device=select_device(opt.device),
                 half=True)
    model = eng.model
    out = {"info": profiling.model_info(eng.spec, model.state_dict(), img_size=max(h, w))}
    x = torch.zeros(opt.batch_size, h, w, eng.spec.ch_in, dtype=eng.dtype,
                    device=eng.device).permute(0, 3, 1, 2)

    def fwd(t):
        with torch.inference_mode():
            return model(t)

    out["forward_s"] = profiling.profile_op(fwd, x, n=opt.iters,
                                            name=f"forward {h}x{w} bs{opt.batch_size}")
    if opt.layers:
        out["layers"] = profiling.profile_layers(model, img_hw=(h, w), batch=opt.batch_size)
    if opt.trace:
        with profiling.trace(opt.trace) as path:
            for _ in range(TRACE_FORWARDS):
                fwd(x)
        out["trace"] = path
    return out


if __name__ == "__main__":
    main()
