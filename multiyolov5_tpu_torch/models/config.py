"""Model-config DSL compiler (counterpart of ``multiyolov5_tpu/models/config.py``).

Reads the reference yaml model DSL (rows of ``[from, number, module, args]``)
and compiles it into a static :class:`ModelSpec`: resolved per-layer
channels, depth/width-scaled args, the save set of intermediate outputs and
analytic strides.  Pure Python; the specs equal the JAX package's field
for field, for every row type its ``init_model`` takes.  Detection-only
configs (no ``n_segcls``) compile with ``seg_index`` and ``n_segcls`` None.  The
v5.0 hub configs (yolov3, yolov3-spp, yolov3-tiny, yolov5-fpn,
yolov5-panet, yolov5s-transformer) ship as JSON files under ``hub/``;
:func:`load_spec` takes their names.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from ..ops.nn import make_divisible

# Modules whose first arg is the output-channel count (reference yolo.py:389-390)
_CH_OUT_MODULES = {
    "Conv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP", "DWConv",
    "MixConv2d", "Focus", "CrossConv", "BottleneckCSP", "C3", "C3TR", "ASPP",
}
_REPEAT_INSERT = {"BottleneckCSP", "C3", "C3TR"}
_SEG_HEADS = {"SegMaskPSP", "SegMaskBase", "SegMaskBiSe", "SegMaskLab"}


@dataclass
class Row:
    i: int
    f: Union[int, List[int]]
    n: int                     # depth-scaled repeat count
    module: str
    args: List[Any]            # resolved args (post gd/gw scaling)
    c1: Union[int, List[int]]
    c2: int
    stride: int                # spatial downscale factor of the output


@dataclass
class ModelSpec:
    rows: List[Row]
    nc: int
    n_segcls: Optional[int]
    anchors: List[List[float]]
    strides: List[int]
    save: set = field(default_factory=set)
    detect_index: int = -1
    seg_index: Optional[int] = None
    yaml: Dict[str, Any] = field(default_factory=dict)
    ch_in: int = 3
    names: List[str] = field(default_factory=list)

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2

    @property
    def nl(self) -> int:
        return len(self.anchors)


def _resolve_arg(a: Any, env: Dict[str, Any]) -> Any:
    """Resolve string args ('nc', 'anchors', 'None', 'nearest') like the
    reference's eval() (models/yolo.py:381-386) but without exec."""
    if isinstance(a, str):
        if a in env:
            return env[a]
        if a == "None":
            return None
        if a in ("True", "False"):
            return a == "True"
        try:
            return int(a)
        except ValueError:
            pass
        try:
            return float(a)
        except ValueError:
            pass
        return a
    return a


def compile_spec(d: Dict[str, Any], ch_in: int = 3, nc: Optional[int] = None,
                 anchors=None) -> ModelSpec:
    d = dict(d)
    if nc is not None:
        d["nc"] = nc
    if anchors is not None:
        d["anchors"] = anchors
    gd = d["depth_multiple"]
    gw = d["width_multiple"]
    anchors_ = d["anchors"]
    nc_ = d["nc"]
    n_segcls = d.get("n_segcls")
    na = (len(anchors_[0]) // 2) if isinstance(anchors_, list) else anchors_
    no = na * (nc_ + 5)
    env = {"nc": nc_, "anchors": anchors_, "n_segcls": n_segcls,
           "nn.SiLU()": "silu"}

    rows: List[Row] = []
    ch: List[int] = [ch_in]
    strides: List[int] = [1]
    save = set()
    detect_index = -1
    seg_index = None
    det_strides: List[int] = []

    for i, (f, n, m, args) in enumerate(d["backbone"] + d["head"]):
        args = [_resolve_arg(a, env) for a in list(args)]
        n_scaled = max(round(n * gd), 1) if n > 1 else n
        fi = f if isinstance(f, int) else list(f)
        if isinstance(fi, int) and fi < -1:
            fi = i + fi
        elif isinstance(fi, list):
            fi = [i + j if j < -1 else j for j in fi]

        # ch is [input] + one entry per layer: layer j's channels at ch[j + 1]
        def get_ch(j):
            return ch[-1] if j == -1 else ch[j + 1]

        def get_stride(j):
            return strides[-1] if j == -1 else strides[j + 1]

        c1: Union[int, List[int]]
        stride_out = get_stride(fi if isinstance(fi, int) else fi[0])

        if m in _CH_OUT_MODULES:
            c1 = get_ch(fi)
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c1, c2, *args[1:]]
            # square list kernels like [1, 1] (hub yolov3.yaml) -> int
            if len(args) > 2 and isinstance(args[2], list) and \
                    len(set(args[2])) == 1:
                args[2] = args[2][0]
            if m in _REPEAT_INSERT:
                args.insert(2, n_scaled)
                n_scaled = 1
            if m == "Focus":
                stride_out *= 2
            elif (len(args) > 3 and isinstance(args[3], int)
                  and not isinstance(args[3], bool) and args[3] > 1):
                # strided variants (args = [c1, c2, k, s, ...]); a bool
                # args[3] is a C3-family shortcut flag, not a stride
                stride_out *= args[3]
        elif m == "nn.BatchNorm2d":
            c1 = get_ch(fi)
            c2 = c1
            args = [c1]
        elif m == "Concat":
            c1 = [get_ch(j) for j in fi]
            c2 = sum(c1)
        elif m == "Detect":
            c1 = [get_ch(j) for j in fi]
            if isinstance(args[1], int):
                # 'anchors: N' (reference yolo.py:405-406): N placeholder
                # anchors a level, for autoanchor to evolve
                args[1] = [list(range(args[1] * 2))] * len(fi)
                d["anchors"] = args[1]
            args.append(list(c1))
            c2 = no
            detect_index = i
            det_strides = [get_stride(j) for j in fi]
        elif m in _SEG_HEADS:
            args[1] = max(round(args[1] * gd), 1) if args[1] > 1 else args[1]
            args[2] = make_divisible(args[2] * gw, 8)
            c1 = [get_ch(j) for j in fi]
            args.append(list(c1))
            c2 = args[0]
            seg_index = i
            stride_out = 1
        elif m == "Contract":
            c1 = get_ch(fi)
            c2 = c1 * args[0] ** 2
            stride_out *= args[0]
        elif m == "Expand":
            c1 = get_ch(fi)
            c2 = c1 // args[0] ** 2
            stride_out //= args[0]
        elif m == "nn.Upsample":
            c1 = get_ch(fi)
            c2 = c1
            stride_out = stride_out // args[1]
        elif m == "nn.MaxPool2d":
            c1 = get_ch(fi)
            c2 = c1
            s = args[1] if len(args) > 1 and args[1] else args[0]  # torch: stride = k
            if s > 1:
                stride_out *= s
        else:
            c1 = get_ch(fi)
            c2 = c1
        rows.append(Row(i, fi, n_scaled, m, args, c1, c2, stride_out))
        for j in ([fi] if isinstance(fi, int) else fi):
            if j != -1:
                save.add(j)
        ch.append(c2)
        strides.append(stride_out)

    if seg_index is not None:
        save.add(seg_index)

    spec = ModelSpec(
        rows=rows, nc=nc_, n_segcls=n_segcls,
        anchors=d["anchors"] if isinstance(d["anchors"], list) else [],
        strides=det_strides, save=save,
        detect_index=detect_index, seg_index=seg_index, yaml=d, ch_in=ch_in,
        names=[str(j) for j in range(nc_)],
    )
    _check_anchor_order(spec)
    return spec


def _check_anchor_order(spec: ModelSpec) -> None:
    """Anchor area must ascend with stride; reverse if not (reference
    utils/autoanchor.py:12-20, sign(0) disagreeing like torch's .sign())."""
    if not spec.anchors or not spec.strides:
        return
    flat = [a * b for lv in spec.anchors for a, b in zip(lv[::2], lv[1::2])]
    da = flat[-1] - flat[0]
    ds = spec.strides[-1] - spec.strides[0]
    sign = lambda v: (v > 0) - (v < 0)  # noqa: E731
    if sign(da) != sign(ds):
        flipped = list(spec.anchors[::-1])
        spec.anchors = flipped
        if spec.detect_index is not None and spec.detect_index >= 0:
            spec.rows[spec.detect_index].args[1] = flipped


HUB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hub")


def hub_configs() -> List[str]:
    """The names of the hub configs under ``hub/`` (e.g. 'yolov3')."""
    return sorted(f[:-5] for f in os.listdir(HUB_DIR) if f.endswith(".yaml"))


def load_spec(cfg: Union[str, Dict[str, Any]], ch: int = 3, nc: Optional[int] = None,
              anchors=None) -> ModelSpec:
    """Accepts a dict, a path to a reference-format yaml (a JSON file, which
    is YAML, is read without PyYAML), a built-in name from
    :mod:`multiyolov5_tpu_torch.models.zoo` (e.g. 'yolov5s_city_seg') or a
    hub config's name (e.g. 'yolov3', :func:`hub_configs`).  ``ch`` is the
    input's channels; ``nc`` and ``anchors`` override the config's."""
    if isinstance(cfg, dict):
        d = cfg
    else:
        path = cfg if os.path.exists(cfg) else os.path.join(HUB_DIR, f"{cfg}.yaml")
        if os.path.exists(path):
            with open(path) as fh:
                text = fh.read()
            try:
                d = json.loads(text)
            except ValueError:
                import yaml
                d = yaml.safe_load(text)
        else:
            from . import zoo
            d = zoo.get(cfg)
    return compile_spec(d, ch, nc, anchors)
