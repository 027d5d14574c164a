"""Inference engine (counterpart of ``multiyolov5_tpu/engine.py``).

One call runs, on ``device``:
    letterboxed frame (uint8, or float in [0, 1]; any number of channels
    the spec takes) -> folded stem (K1; a model without the Focus +
    Conv(3, s2) stem runs from row 0 on the frame / 255) -> trunk (neck
    3x3s on K2; at batch > 1 the narrow backbone C3 on K7) -> seg head (its
    Pallas-site 3x3s on K2), if the model has one, + Detect decode
    (float32) -> NMS (K3 for one frame, one K5 launch for a batch) ->
    letterbox unmap -> upsample + argmax class map (K4)
and returns host arrays.  Every zoo entry and hub config runs: the four
seg heads, detection-only models (no class map), the 4-level P6 models
(stride 64), yolov3 and the transformer.  BNs that no conv absorbs keep
their running statistics in the fused model.  Weights come from a
JAX-package ``.npz`` checkpoint, a reference
``.pt`` (utils/checkpoint.load_pt: its config, when it carries one, wins
over ``cfg``), a ``state_dict``, or a seeded random init; BN is folded at build and
``half=True`` then casts the parameters to bfloat16.  Decode and NMS stay
float32.

The call takes the JAX engine's arguments (multiyolov5_tpu/engine.py:548):
``classes`` filters the single-label winners (or the multi-label rows),
``agnostic`` drops the class offset, ``multi_label`` keeps every (box,
class) pair above ``conf`` (``nms_batched``, up to 1024 rows), ``max_det``
caps the kept rows, and ``augment`` runs test-time augmentation: three
passes at scales 1, 0.83 (flipped on W) and 0.67, the scaled float frames
through K1's float mode, their candidates joined before one NMS; the class
map comes from the unscaled pass.  A list of weights builds an ensemble:
one member engine a path, their candidates joined before one NMS with
``max_nms`` 4096 (one K5 launch), the class map from the first member.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .models.config import ModelSpec, load_spec
from .models.model import Model, seeded_state_dict
from .ops import stem as stem_lib
from .ops.kernels import stem, upsample_argmax
from .ops.kernels.stem import MAX_CHANNELS as STEM_MAX_CHANNELS
from .ops.nms import nms_batched, nms_planar
from .ops.nn import fuse_conv_bn
from .utils.boxes import scale_coords
from .utils.checkpoint import load_checkpoint

_INV255 = np.float32(1.0 / 255.0)
# test-time augmentation (reference models/yolo.py:273-291): scales, and
# which pass is flipped on W
TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (False, True, False)


def scale_img_pad(x: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """(B, H, W, C) float frame -> bilinear (align_corners=False) resize to
    ``int(H * ratio) x int(W * ratio)``, padded with 0.447 on the bottom and
    right up to multiples of ``gs`` (multiyolov5_tpu/engine.py:131-143)."""
    if ratio == 1.0:
        return x
    _, h, w, _ = x.shape
    nh, nw = int(h * ratio), int(w * ratio)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                      align_corners=False)
    ph, pw = -(-nh // gs) * gs - nh, -(-nw // gs) * gs - nw
    y = F.pad(y, (0, pw, 0, ph), value=0.447)
    return y.permute(0, 2, 3, 1).contiguous()


class Engine:
    """Loads weights, folds BN and serves the fused pipeline.

    Args:
      weights: path of a native ``.npz`` or a reference ``.pt`` checkpoint,
        or None; a list of paths (``.npz`` and ``.pt`` mixed) builds an
        ensemble.
      cfg: model config (zoo name, yaml path or dict) when the checkpoint
        does not carry one, or for a seeded random init.
      device: where the model runs: "cuda" (the default) launches the
        kernels, "cpu" runs their plain versions.
      half: bfloat16 parameters and activations.
      seed: seed of the random init when there are no weights.
      spec, state_dict: an unfused torch-layout ``state_dict`` for ``spec``
        (for example ``from_jax_params`` of the JAX package's weights).
    """

    def __init__(self, weights: Optional[str] = None, cfg=None, *,
                 device: Union[str, torch.device] = "cuda", half: bool = True,
                 seed: int = 0, spec: Optional[ModelSpec] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        # multi-checkpoint ensemble (multiyolov5_tpu/engine.py:150-158)
        self.ensemble: List["Engine"] = []
        if isinstance(weights, (list, tuple)):
            self.ensemble = [Engine(w, cfg=cfg, device=device, half=half, seed=seed)
                             for w in weights[1:]]
            weights = weights[0] if weights else None
        if spec is not None:
            sd = state_dict
        elif weights and os.path.exists(weights):
            ck_cfg, sd = load_checkpoint(weights)
            spec = load_spec(ck_cfg or cfg)
        elif weights and cfg is None:
            raise FileNotFoundError(f"weights not found: {weights} (and no cfg given)")
        else:
            if weights:       # as the JAX engine does (multiyolov5_tpu/engine.py:211-216)
                print(f"WARNING: weights {weights!r} not found - random init from cfg {cfg!r}")
            spec = load_spec(cfg or "yolov5s_city_seg")
            sd = seeded_state_dict(spec, seed)
        self.spec = spec
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if half else torch.float32
        fsd = fuse_conv_bn(sd)

        # rows 0-1 run as the folded stem (K1) where they are Focus +
        # Conv(3, s2), on frames of any channel count K1 reads (the JAX
        # engine folds any ch_in, multiyolov5_tpu/engine.py:186); for uint8
        # frames /255 folds into conv1's weights, float frames (already in
        # [0, 1]) take them unscaled.  Any other stem runs in the model from
        # row 0, as the JAX engine runs a stem it does not fold
        # (multiyolov5_tpu/engine.py:379-387).  Decided here, from the spec
        # alone: the CPU and the card take the same route
        self.fold_stem = (stem_lib.can_fold_stem(spec)
                          and spec.ch_in <= STEM_MAX_CHANNELS)
        self.stem_weights = self.stem_weights_float = None
        if self.fold_stem:
            hwio = lambda k: np.asarray(fsd[k]).transpose(2, 3, 1, 0)  # noqa: E731
            w1, b1, w2, b2 = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                              for a in stem_lib.fold_stem_weights(
                                  hwio("model.0.conv.conv.weight"),
                                  np.asarray(fsd["model.0.conv.conv.bias"]),
                                  hwio("model.1.conv.weight"),
                                  np.asarray(fsd["model.1.conv.bias"])))
            self.stem_weights = (w1 * _INV255, b1, w2, b2)
            self.stem_weights_float = (w1, b1, w2, b2)

        model = Model(spec, fused=True)
        model.load_state_dict(fsd, strict=True)
        model.eval().requires_grad_(False).to(self.device)
        for p in model.parameters():      # buffers (anchors) stay float32
            p.data = p.data.to(self.dtype)
        self.model = model

    @property
    def stride(self) -> int:
        return int(max(self.spec.strides))

    @property
    def names(self) -> List[str]:
        return self.spec.names

    def forward(self, frames: torch.Tensor, raw: bool = False):
        """frames (B, H, W, ch_in) on the engine's device (``ch_in`` the
        spec's input channels), uint8, or float32 or bfloat16 in [0, 1]
        (the seg loader's x / 255, used as it is), H and W any multiples of
        the stride (serving's 512x1024, the eval loader's rect shapes such
        as 576x1024) -> (decoded candidates (B, no, N) float32, 1/8-res seg
        logits (B, n_segcls, h, w), or None for a detection-only model).
        With ``raw``, the first is the pair (decoded candidates, Detect's
        raw per-level maps)."""
        if frames.shape[1] % self.stride or frames.shape[2] % self.stride:
            raise ValueError(f"frame {tuple(frames.shape[1:3])} is not a "
                             f"multiple of the stride {self.stride}")
        decode = "both" if raw else True
        with torch.inference_mode():
            if not self.fold_stem:
                x = frames.to(self.dtype)
                x = x if frames.is_floating_point() else x / 255
                return self.model(x.permute(0, 3, 1, 2), decode=decode)
            weights = (self.stem_weights_float if frames.is_floating_point()
                       else self.stem_weights)
            y1 = stem(frames, *weights, out_dtype=self.dtype)
            return self.model(y1.permute(0, 3, 1, 2), start_layer=2, decode=decode)

    def forward_augment(self, frames: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Test-time augmentation (multiyolov5_tpu/engine.py:393-407): the
        frames at scales 1, 0.83 (flipped on W) and 0.67, the scaled ones
        as float frames in [0, 1].  Returns (the three passes' decoded
        candidates joined along N (B, no, 3 passes' N), boxes in the
        unscaled frame's pixels, in the order of the passes; the unscaled
        pass's 1/8-res seg logits)."""
        zs, seg = [], None
        with torch.inference_mode():
            x = frames if frames.is_floating_point() else frames.float() * _INV255
            for si, flip in zip(TTA_SCALES, TTA_FLIPS):
                if si == 1.0 and not flip:
                    z, seg = self.forward(frames)
                else:
                    z, _ = self.forward(scale_img_pad(x.flip(2) if flip else x, si,
                                                      self.stride))
                    z[:, :4] /= si
                    if flip:
                        z[:, 0] = frames.shape[2] - z[:, 0]
                zs.append(z)
            return torch.cat(zs, 2), seg

    def _class_mask(self, classes: Optional[Sequence[int]], device) -> Optional[torch.Tensor]:
        if classes is None:
            return None
        cm = torch.zeros(self.spec.nc, dtype=torch.float32)
        cm[list(classes)] = 1.0
        return cm.to(device)

    def __call__(self, img: Union[np.ndarray, torch.Tensor],
                 orig_hw: Tuple[int, int], conf: float = 0.25,
                 iou: float = 0.45, classes: Optional[Sequence[int]] = None,
                 agnostic: bool = False, multi_label: bool = False,
                 max_det: int = 300,
                 augment: bool = False) -> Tuple[List[np.ndarray], List[Optional[np.ndarray]]]:
        """img: (H, W, C) or (B, H, W, C) letterboxed RGB (C the spec's
        ``ch_in``, 3 but for a model built for other channels), uint8 or
        float in [0, 1].

        Returns (per image an (n, 6) float32 array [x1, y1, x2, y2, conf,
        cls] in original-frame pixels, per image an (H0, W0) uint8 class
        map, or None for a detection-only model)."""
        x = torch.as_tensor(img)
        if x.dim() == 3:
            x = x[None]
        x = x.to(self.device).contiguous()
        if self.ensemble:
            return self._call_ensemble(x, orig_hw, conf, iou, classes, agnostic,
                                       multi_label, max_det, augment)
        z, seg = self.forward_augment(x) if augment else self.forward(x)
        return self.postprocess(z, seg, tuple(x.shape[1:3]), orig_hw, conf, iou,
                                classes=classes, agnostic=agnostic,
                                multi_label=multi_label, max_det=max_det)

    def warmup(self, in_hw: Tuple[int, int], orig_hw: Tuple[int, int], **kw) -> None:
        """One call on a blank bs1 frame of ``in_hw``: builds the kernels and
        warms the allocator and cuDNN for that geometry."""
        self(np.zeros((1, *in_hw, self.spec.ch_in), np.uint8), orig_hw, **kw)

    def postprocess(self, z: torch.Tensor, seg: Optional[torch.Tensor],
                    in_hw: Tuple[int, int], orig_hw: Tuple[int, int],
                    conf: float = 0.25, iou: float = 0.45, *,
                    classes: Optional[Sequence[int]] = None, agnostic: bool = False,
                    multi_label: bool = False, max_det: int = 300):
        """NMS, letterbox unmap and class map of :meth:`forward`'s (or
        :meth:`forward_augment`'s) outputs, on the device they lie on;
        returns what ``__call__`` returns."""
        with torch.inference_mode():
            # serving caps (multiyolov5_tpu/engine.py:414-436): 1024 candidates
            cmask = self._class_mask(classes, z.device)
            if multi_label:
                boxes, valid = nms_batched(z.transpose(1, 2), conf, iou, multi_label=True,
                                           agnostic=agnostic, class_mask=cmask,
                                           max_nms=1024, max_det=max_det)
            else:
                boxes, valid = nms_planar(z, conf, iou, agnostic=agnostic, class_mask=cmask,
                                          max_nms=1024, max_det=max_det)
            # letterbox unmap + clip + round (reference detect.py:169)
            gain = min(in_hw[0] / orig_hw[0], in_hw[1] / orig_hw[1])
            px = (in_hw[1] - orig_hw[1] * gain) / 2
            py = (in_hw[0] - orig_hw[0] * gain) / 2
            pad = torch.tensor([px, py, px, py], dtype=torch.float32, device=z.device)
            lim = torch.tensor([orig_hw[1], orig_hw[0], orig_hw[1], orig_hw[0]],
                               dtype=torch.float32, device=z.device)
            xy = (boxes[..., :4] - pad) / gain
            xy = torch.minimum(xy.clamp_min(0.0), lim)
            boxes = torch.cat([torch.round(xy), boxes[..., 4:]], -1)
            masks = self.class_map(seg, orig_hw)
        return self._to_host(boxes, valid, masks)

    @staticmethod
    def class_map(seg: Optional[torch.Tensor], orig_hw: Tuple[int, int]) -> Optional[torch.Tensor]:
        """(B, H0, W0) uint8 argmax of the 1/8-res logits resized through the
        head's x8 to the frame (K4), or None without a seg head."""
        if seg is None:
            return None
        via = (seg.shape[2] * 8, seg.shape[3] * 8)
        return upsample_argmax(seg.contiguous(), orig_hw, via_hw=via)

    @staticmethod
    def _to_host(boxes: torch.Tensor, valid: torch.Tensor, masks: Optional[torch.Tensor]):
        boxes, valid = boxes.cpu().numpy(), valid.cpu().numpy()
        dets = [boxes[i][valid[i]] for i in range(boxes.shape[0])]
        if masks is None:
            return dets, [None] * len(dets)
        return dets, list(masks.cpu().numpy())

    def _call_ensemble(self, x, orig_hw, conf, iou, classes, agnostic, multi_label,
                       max_det, augment):
        """Multi-model NMS ensemble (multiyolov5_tpu/engine.py:637-672): the
        members' candidates joined, one ``nms_batched`` with its default
        ``max_nms`` 4096, ``scale_coords`` and round; the class map from
        this (the first) member."""
        with torch.inference_mode():
            zs, segs = zip(*(e.forward_augment(x) if augment else e.forward(x)
                             for e in [self] + self.ensemble))
            z, seg = torch.cat(zs, 2), segs[0]
            boxes, valid = nms_batched(z.transpose(1, 2), conf, iou, multi_label=multi_label,
                                       agnostic=agnostic,
                                       class_mask=self._class_mask(classes, z.device),
                                       max_det=max_det)
            xy = scale_coords(tuple(x.shape[1:3]), boxes[..., :4], orig_hw)
            boxes = torch.cat([torch.round(xy), boxes[..., 4:]], -1)
            masks = self.class_map(seg, orig_hw)
        return self._to_host(boxes, valid, masks)
