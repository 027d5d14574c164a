"""Model assembly (counterpart of ``multiyolov5_tpu/models/model.py``).

:class:`Model` builds one module per spec row under ``model.<i>``, so its
``state_dict`` keys equal the JAX package's param/state keys, and walks the
rows with the spec's save set.  Every row type that the JAX package's
``init_model`` takes is built.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Union

import torch
import torch.nn as nn

from . import blocks as B
from ..ops.nn import BN_MOMENTUM, Dropout, fuse_conv_bn
from .config import ModelSpec, load_spec
from .heads import Detect, SegMaskBase, SegMaskBiSe, SegMaskLab, SegMaskPSP


def _build_row(spec: ModelSpec, row, fused: bool, kernel: bool,
               c3_kernel: bool) -> nn.Module:
    """The module of one spec row, with the JAX package's defaults
    (multiyolov5_tpu/models/model.py:24-86).  A repeated Conv or Bottleneck
    row is an ``nn.Sequential`` of its repeats (keys ``model.<i>.<rep>``);
    the C3 family takes its repeats as an argument, and every other module
    is built once whatever its count, as the JAX package does."""
    m, a = row.module, row.args
    arg = lambda j, default: a[j] if len(a) > j else default  # noqa: E731

    def repeated(make):
        return make() if row.n == 1 else nn.Sequential(*[make() for _ in range(row.n)])

    if m == "Conv":
        return repeated(lambda: B.Conv(a[0], a[1], arg(2, 1), arg(3, 1), g=arg(5, 1),
                                       fused=fused, kernel=kernel))
    if m == "Bottleneck":
        return repeated(lambda: B.Bottleneck(a[0], a[1], arg(2, True), fused=fused,
                                             kernel=kernel))
    if m == "DWConv":
        return B.DWConv(a[0], a[1], arg(2, 1), arg(3, 1), fused=fused)
    if m == "Focus":
        return B.Focus(a[0], a[1], arg(2, 1), fused=fused)
    if m == "BottleneckCSP":
        return B.BottleneckCSP(a[0], a[1], n=a[2], shortcut=arg(3, True), fused=fused,
                               kernel=kernel)
    if m == "C3":
        return B.C3(a[0], a[1], n=a[2], shortcut=arg(3, True),
                    fused=fused, kernel=kernel, c3_kernel=c3_kernel)
    if m == "C3TR":
        return B.C3TR(a[0], a[1], n=a[2], fused=fused)
    if m == "SPP":
        return B.SPP(a[0], a[1], tuple(arg(2, (5, 9, 13))), fused=fused)
    if m == "ASPP":
        return B.ASPP(a[0], a[1], fused=fused)
    if m == "GhostConv":
        return B.GhostConv(a[0], a[1], arg(2, 1), arg(3, 1), fused=fused)
    if m == "GhostBottleneck":
        return B.GhostBottleneck(a[0], a[1], arg(2, 3), arg(3, 1), fused=fused)
    if m == "CrossConv":
        return B.CrossConv(a[0], a[1], arg(2, 3), arg(3, 1), arg(4, 1), arg(5, 1.0),
                           arg(6, False), fused=fused)
    if m == "MixConv2d":
        return B.MixConv2d(a[0], a[1], tuple(arg(2, (1, 3))), arg(3, 1))
    if m == "Sum":
        return B.Sum(len(row.f), arg(1, False))
    if m == "Classify":
        return B.Classify(a[0], a[1], arg(2, 1))
    if m == "nn.BatchNorm2d":
        return B.BatchNorm2d(a[0])
    if m == "nn.MaxPool2d":
        return B.MaxPool2d(a[0], arg(1, None), arg(2, 0))
    if m == "nn.ZeroPad2d":
        return B.ZeroPad2d(a[0])
    if m == "Contract":
        return B.Contract(a[0])
    if m == "Expand":
        return B.Expand(a[0])
    if m == "nn.Upsample":
        return B.Upsample(a[1], a[2])
    if m == "Concat":
        return B.Concat()
    if m == "SegMaskPSP":
        return SegMaskPSP(a[0], a[2], a[4], fused=fused, kernel=kernel)
    if m == "SegMaskBase":
        return SegMaskBase(a[0], a[1], a[2], a[3], a[4], fused=fused, kernel=kernel)
    if m == "SegMaskBiSe":
        return SegMaskBiSe(a[0], a[4], fused=fused, kernel=kernel)
    if m == "SegMaskLab":
        return SegMaskLab(a[0], a[1], a[2], a[4], fused=fused, kernel=kernel)
    if m == "Detect":
        return Detect(a[0], a[1], a[2], spec.strides)
    raise NotImplementedError(f"module {m!r} (row {row.i})")


class Model(nn.Module):
    """The network of a :class:`ModelSpec` on NCHW tensors, and the reference
    ``Model`` surface (models/yolo.py:233-370; multiyolov5_tpu/models/model.py:387-451).

    ``cfg`` is a :class:`ModelSpec`, built as it is with torch's default
    init (``ch``, ``nc`` and ``anchors`` left at their defaults), or a
    config (a zoo or hub name, a yaml path or a dict) compiled by
    ``load_spec(cfg, ch, nc, anchors)`` and initialised from ``seed`` as
    :func:`seeded_state_dict` does.  ``nc``, ``stride`` (the spec's
    strides) and ``names`` read the spec; :meth:`fuse` folds BN in place,
    :meth:`info` prints the summary and :meth:`autoshape` serves the
    weights through ``hub.AutoShape``.  ``half()`` is ``nn.Module``'s
    (float16); the JAX facade's ``half()`` computes in bfloat16, which here
    is ``.to(torch.bfloat16)``, the dtype the kernels take.

    ``fused=True`` builds BN-folded convs (load a ``fuse_conv_bn``'d
    state_dict); then the SiLU 3x3 convs from the neck on (rows past the
    backbone, the seg head included) run through kernel K2, the
    sites where the JAX package routes its Pallas 3x3s at batch 1, and the
    narrow backbone C3s through K7 at batch > 1.  ``kernels=False`` builds
    every conv on ``F.conv2d`` (the JAX ``forward(..., sever=False)``): the
    network that ``torch.export``, TorchScript and the FLOP counter trace.
    ``forward`` returns (decoded candidates (B, no, N) float32 or None,
    1/8-res seg logits (B, n_segcls, h, w), or None for a detection-only
    model); in training mode, or with ``decode=False``, the
    first is the list of raw per-level maps (B, na, ny, nx, no)
    (heads.Detect), the input of train/losses.DetectionLoss, and with
    ``decode="both"`` the pair (decoded candidates, raw maps).  In
    training mode the BiSe head's seg output is ``[main, aux16, aux32]``.
    The JAX facade's call takes and returns NHWC maps and adds the BN
    state, ``(det, seg, state)``; this one stays NCHW, ``(det, seg)``."""

    def __init__(self, cfg: Union[ModelSpec, str, dict] = "yolov5s_city_seg", ch: int = 3,
                 nc: Optional[int] = None, anchors=None, seed: int = 0, *,
                 fused: bool = False, kernels: bool = True):
        super().__init__()
        spec = cfg
        if not isinstance(cfg, ModelSpec):
            spec = load_spec(cfg, ch, nc, anchors)
        elif (ch, nc, anchors) != (3, None, None):
            raise ValueError("ch, nc and anchors rebuild a config; a ModelSpec is "
                             "built as it is")
        self.spec, self.kernels, self.fused = spec, kernels, fused
        self.model = self._rows(fused)
        if isinstance(cfg, ModelSpec):
            return
        if fused:       # the folded weights of the unfused seeded model
            self.load_state_dict(fuse_conv_bn(seeded_state_dict(spec, seed)), strict=True)
        else:
            init_model(self, torch.Generator().manual_seed(seed)).train()

    def _rows(self, fused: bool) -> nn.ModuleList:
        spec = self.spec
        neck_start = len(spec.yaml.get("backbone", []))
        return nn.ModuleList(
            _build_row(spec, row, fused, kernel=self.kernels and row.i >= neck_start,
                       c3_kernel=self.kernels and row.i < neck_start)
            for row in spec.rows)

    @property
    def nc(self) -> int:
        return self.spec.nc

    @property
    def stride(self) -> List[int]:
        return list(self.spec.strides)

    @property
    def names(self) -> List[str]:
        return list(self.spec.names)

    def fuse(self) -> "Model":
        """Fold every conv-following BN in place (``fuse_conv_bn``): the rows
        become the folded modules, on the same device and in the same
        dtype, in the same mode.  From then on the neck's SiLU 3x3s and,
        at batch > 1, the backbone C3s run on their kernels, as in
        ``Model(spec, fused=True)``.  Returns ``self``."""
        if self.fused:
            return self
        p = next(self.parameters())
        dtypes = {k: v.dtype for k, v in self.state_dict().items()}
        rows = self._rows(fused=True)
        rows.load_state_dict({k[len("model."):]: v for k, v in
                              fuse_conv_bn(_host_float(self.state_dict())).items()},
                             strict=True)
        self.model = rows.to(p.device)
        for name, t in (*self.named_parameters(), *self.named_buffers()):
            if t.is_floating_point():      # a folded conv's new bias: the weights' dtype
                t.data = t.data.to(dtypes.get(name, p.dtype))
            if isinstance(t, nn.Parameter):
                t.requires_grad_(p.requires_grad)
        self.fused = True
        return self.train(self.training)

    def info(self, verbose: bool = False, img_size: int = 640) -> dict:
        """Layers, parameters and GFLOPs at ``img_size`` (reference
        ``Model.info``, utils/profiling.model_info)."""
        from ..utils.profiling import model_info
        return model_info(self.spec, self.state_dict(), img_size, verbose)

    def autoshape(self):
        """These weights behind ``hub.AutoShape``: an ``Engine`` in float32
        on this model's device (the JAX facade passes ``half=False`` too)."""
        from ..engine import Engine
        from ..hub import AutoShape
        return AutoShape(Engine(spec=self.spec, state_dict=_host_float(self.state_dict()),
                                device=next(self.parameters()).device, half=False))

    def forward(self, x: torch.Tensor, start_layer: int = 0, decode: bool = True):
        """x: (B, ch_in, H, W) image in [0, 1], or with ``start_layer=k`` the
        output of row k-1 (no skipped row may be in the save set)."""
        spec = self.spec
        cache = {}
        y = x
        det = seg = None
        for row in spec.rows[start_layer:]:
            if isinstance(row.f, int):
                inp = y if row.f == -1 else cache[row.f]
            else:
                inp = [y if j == -1 else cache[j] for j in row.f]
            if row.i == spec.detect_index:
                y = det = self.model[row.i](inp, decode)
            else:
                y = self.model[row.i](inp)
            if row.i == spec.seg_index:
                seg = y
            if row.i in spec.save:
                cache[row.i] = y
        return det, seg

    @contextlib.contextmanager
    def dropout_rng(self, generator: Optional[torch.Generator], mesh=None):
        """For the duration, every dropout of the model (the Base and BiSe
        heads' ``ops/nn.Dropout``) draws its training-mode mask from
        ``generator``; None drops nothing.  With a ``mesh``
        (parallel/mesh.py) the inputs are this rank's slices of the global
        batch, and each dropout keeps its slice of the global mask."""
        mods = [m for m in self.modules() if isinstance(m, Dropout)]
        for m in mods:
            m.generator, m.mesh = generator, mesh
        try:
            yield
        finally:
            for m in mods:
                m.generator = m.mesh = None


def _host_float(sd: dict) -> dict:
    """A ``state_dict`` on the CPU, its floating tensors in float32."""
    return {k: (v.float() if v.is_floating_point() else v).detach().cpu()
            for k, v in sd.items()}


def init_model(model: Model, generator: torch.Generator, device="cpu") -> Model:
    """Seeded random init of an unfused :class:`Model` on the CPU, whose
    statistics pass then runs on ``device`` (the model stays there).

    torch's default conv and linear init (kaiming_uniform, a=sqrt(5)), the
    attention's in-projection xavier_uniform with a zero bias (as
    ``nn.MultiheadAttention`` initialises it), random BN affine
    parameters, the Detect bias prior of
    multiyolov5_tpu/models/heads.py:38-50, and BN running statistics
    measured on one seeded random batch.  With unit running statistics the
    default init shrinks activations about threefold per conv, and the
    network's outputs become nearly constant over the image: near-tied
    scores and a one-class mask.  Measured statistics keep activations at
    unit scale, so random weights give spread scores and varied masks.
    The statistics pass runs the eval forward with only the BN layers in
    training mode, so BNs off that forward (BiSe's aux pair) keep unit
    statistics."""
    g = generator
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=g)
                if mod.bias is not None:
                    fan_in = mod.weight[0].numel()
                    bound = 1 / math.sqrt(fan_in)
                    mod.bias.uniform_(-bound, bound, generator=g)
            elif isinstance(mod, B.TransformerLayer):
                nn.init.xavier_uniform_(mod.ma.in_proj_weight, generator=g)
                mod.ma.in_proj_bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.weight.uniform_(0.8, 1.2, generator=g)
                mod.bias.uniform_(-0.1, 0.1, generator=g)
                mod.reset_running_stats()
                mod.momentum = None       # cumulative: one batch sets the stats
        det = model.spec.detect_index
        if det is not None and det >= 0:
            model.model[det].init_bias_prior()
        model.eval()
        for mod in model.modules():       # BN alone in training mode
            if isinstance(mod, nn.BatchNorm2d):
                mod.train()
        model.to(device)
        model(torch.rand(2, model.spec.ch_in, 256, 512, generator=g).to(device))
        model.eval()
        for mod in model.modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.momentum = BN_MOMENTUM
    return model


def seeded_state_dict(spec: ModelSpec, seed: int = 0, device="cpu") -> dict:
    """The unfused ``state_dict`` of a seeded random :class:`Model`, on the
    CPU.  The weights are drawn on the CPU; ``device`` runs the statistics
    pass (a card's statistics differ from the CPU's by float32 rounding)."""
    model = init_model(Model(spec), torch.Generator().manual_seed(seed), device)
    return {k: v.cpu() for k, v in model.state_dict().items()
            if not k.endswith(".num_batches_tracked")}
