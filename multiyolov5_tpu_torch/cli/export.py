"""Model export (counterpart of ``multiyolov5_tpu/cli/export.py``; reference
models/export.py:58-101).

Two formats, both loaded back by PyTorch alone:

  * ``torchscript`` — ``torch.jit.trace`` -> ``<stem>.torchscript.pt``
    (``torch.jit.load``);
  * ``export`` — ``torch.export.export`` -> ``torch.export.save`` ->
    ``<stem>.pt2`` (``torch.export.load(path).module()``).

The JAX package's ``stablehlo``, ``saved_model`` and ``tflite``, and the
reference's ``onnx``, raise ``NotImplementedError`` before anything runs.

The exported network is the plain build (``Model(kernels=False)``: every
conv a ``F.conv2d``, no hand-written kernel, as the JAX export runs with
``sever=False``) of the folded float32 weights.  Its input is an NCHW float
frame in [0, 1] of ``--batch-size`` x ``--img-size``; its outputs are the
decoded candidates (B, N, no) [x, y, w, h, obj, cls...] in input pixels
and, for a seg model, the seg logits (B, n_segcls, H, W) at the input's
size.  ``--raw`` (the reference's ``Detect.export``) gives the per-level
raw maps (B, na, ny, nx, no) in place of the decoded candidates.

An artifact is tied to the device it was traced on: Detect's grid
``arange`` records its device in the graph.  Export on the card (the
default ``--device``) to serve on the card, with ``--device cpu`` to serve
on the CPU.

    python -m multiyolov5_tpu_torch.cli.export --weights w.npz --img-size 512 1024
"""

from __future__ import annotations

import argparse
import warnings
from pathlib import Path

import torch
import torch.nn as nn

from ..engine import Engine
from ..models.model import Model
from ..ops.resize import resize_bilinear
from .detect import select_device

FORMATS = ("torchscript", "export")


def plain_model(eng: Engine) -> Model:
    """The plain build (every conv ``F.conv2d``) of ``eng``'s folded weights,
    in eval mode on ``eng``'s device."""
    model = Model(eng.spec, fused=True, kernels=False)
    model.load_state_dict(eng.model.state_dict(), strict=True)
    return model.eval().requires_grad_(False).to(eng.device)


class ExportModel(nn.Module):
    """``model``'s outputs as exported: the decoded candidates (B, N, no), or
    with ``raw`` the per-level raw maps, then the seg logits resized x8 to
    the input (align-corners bilinear, the reference head's upsample)."""

    def __init__(self, model: Model, raw: bool = False):
        super().__init__()
        self.model, self.raw = model, raw

    def forward(self, x: torch.Tensor):
        det, seg = self.model(x, decode=not self.raw)
        out = tuple(det) if self.raw else (det.transpose(1, 2),)
        if seg is not None:
            out = out + (resize_bilinear(seg, (seg.shape[2] * 8, seg.shape[3] * 8)),)
        return out


def export(opt):
    """Write the artifacts ``opt.include`` names; returns their paths."""
    bad = [f for f in opt.include if f not in FORMATS]
    if bad:
        raise NotImplementedError(f"--include {' '.join(bad)}: the port exports "
                                  f"{' and '.join(FORMATS)} only (torch.jit and torch.export)")
    w = opt.weights[0] if isinstance(opt.weights, list) else opt.weights
    eng = Engine(w or None, cfg=opt.cfg, device=select_device(opt.device), half=False)
    h, wd = (opt.img_size, opt.img_size) if isinstance(opt.img_size, int) else opt.img_size
    x = torch.zeros(opt.batch_size, eng.spec.ch_in, h, wd, device=eng.device)
    net = ExportModel(plain_model(eng), raw=opt.raw).eval()

    out_dir = Path(opt.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(w).stem if w else (opt.cfg if isinstance(opt.cfg, str) else "model")
    made = []
    with torch.no_grad():
        if "torchscript" in opt.include:
            p = out_dir / f"{stem}.torchscript.pt"
            with warnings.catch_warnings():   # the trace is of this input size, by design
                warnings.simplefilter("ignore", torch.jit.TracerWarning)
                torch.jit.trace(net, x, strict=False).save(str(p))
            made.append(str(p))
            print(f"torchscript export success: {p} ({p.stat().st_size / 1e6:.1f} MB)")
        if "export" in opt.include:
            p = out_dir / f"{stem}.pt2"
            torch.export.save(torch.export.export(net, (x,)), str(p))
            made.append(str(p))
            print(f"torch.export export success: {p} ({p.stat().st_size / 1e6:.1f} MB)")
    print(f"Export complete ({len(made)} artifacts) on {eng.device}.")
    return made


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--weights", nargs="+", type=str, default="",
                   help=".pt/.npz weights (empty = random init from --cfg)")
    p.add_argument("--cfg", type=str, default="yolov5s_city_seg")
    p.add_argument("--img-size", nargs="+", type=int, default=[512, 1024])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--include", nargs="+", default=list(FORMATS),
                   help=f"formats: {', '.join(FORMATS)}")
    p.add_argument("--raw", action="store_true",
                   help="export raw per-level maps (Detect.export analog)")
    p.add_argument("--output", default="runs/export")
    p.add_argument("--device", default="", help="cuda device, i.e. 0 or cpu")
    return p


def main(argv=None):
    opt = build_parser().parse_args(argv)
    if isinstance(opt.img_size, list) and len(opt.img_size) == 1:
        opt.img_size = opt.img_size[0]
    print(opt)
    return export(opt)


if __name__ == "__main__":
    main()
