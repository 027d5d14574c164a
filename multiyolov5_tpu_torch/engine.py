"""Inference engine (counterpart of ``multiyolov5_tpu/engine.py``).

One call runs, on ``device``:
    letterboxed frame (uint8, or float in [0, 1]) -> folded stem (K1) ->
    trunk (neck 3x3s on K2; at batch > 1 the narrow backbone C3 on K7) ->
    seg head (its Pallas-site 3x3s on K2), if the model has one, + Detect
    decode (float32) -> NMS (K3 for one frame, one K5 launch for a batch)
    -> letterbox unmap -> upsample + argmax class map (K4)
and returns host arrays.  Every zoo entry runs: the four seg heads,
detection-only models (no class map) and the 4-level P6 models (stride
64).  Weights come from a JAX-package ``.npz`` checkpoint, from a
``state_dict``, or from a seeded random init; BN is folded at build and
``half=True`` then casts the parameters to bfloat16.  Decode and NMS stay
float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .models.config import ModelSpec, load_spec
from .models.model import Model, seeded_state_dict
from .ops import stem as stem_lib
from .ops.kernels import stem, upsample_argmax
from .ops.nms import nms_planar
from .ops.nn import fuse_conv_bn
from .utils.checkpoint import load_checkpoint

_INV255 = np.float32(1.0 / 255.0)


class Engine:
    """Loads weights, folds BN and serves the fused pipeline.

    Args:
      weights: path of a native ``.npz`` checkpoint, or None.
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
        if spec is not None:
            sd = state_dict
        elif weights:
            ck_cfg, sd = load_checkpoint(weights)
            spec = load_spec(ck_cfg or cfg)
        else:
            spec = load_spec(cfg or "yolov5s_city_seg")
            sd = seeded_state_dict(spec, seed)
        if not stem_lib.can_fold_stem(spec):
            raise NotImplementedError("the engine needs the Focus + Conv(3, s2) stem")
        self.spec = spec
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if half else torch.float32
        fsd = fuse_conv_bn(sd)

        # rows 0-1 run as the folded stem; for uint8 frames /255 folds into
        # conv1's weights, float frames (already in [0, 1]) take them unscaled
        hwio = lambda k: np.asarray(fsd[k]).transpose(2, 3, 1, 0)  # noqa: E731
        w1, b1, w2, b2 = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                          for a in stem_lib.fold_stem_weights(
                              hwio("model.0.conv.conv.weight"),
                              np.asarray(fsd["model.0.conv.conv.bias"]),
                              hwio("model.1.conv.weight"), np.asarray(fsd["model.1.conv.bias"])))
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

    def forward(self, frames: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """frames (B, H, W, 3) on the engine's device, uint8, or float32 or
        bfloat16 in [0, 1] (the seg loader's x / 255, used as it is), H and
        W any multiples of the stride (serving's 512x1024, the eval
        loader's rect shapes such as 576x1024) -> (decoded candidates (B,
        no, N) float32, 1/8-res seg logits (B, C, h, w), or None for a
        detection-only model)."""
        if frames.shape[1] % self.stride or frames.shape[2] % self.stride:
            raise ValueError(f"frame {tuple(frames.shape[1:3])} is not a "
                             f"multiple of the stride {self.stride}")
        weights = (self.stem_weights_float if frames.is_floating_point()
                   else self.stem_weights)
        with torch.inference_mode():
            y1 = stem(frames, *weights, out_dtype=self.dtype)
            return self.model(y1.permute(0, 3, 1, 2), start_layer=2)

    def __call__(self, img: Union[np.ndarray, torch.Tensor],
                 orig_hw: Tuple[int, int], conf: float = 0.25,
                 iou: float = 0.45) -> Tuple[List[np.ndarray], List[Optional[np.ndarray]]]:
        """img: (H, W, 3) or (B, H, W, 3) letterboxed RGB, uint8 or float in [0, 1].

        Returns (per image an (n, 6) float32 array [x1, y1, x2, y2, conf,
        cls] in original-frame pixels, per image an (H0, W0) uint8 class
        map, or None for a detection-only model)."""
        x = torch.as_tensor(img)
        if x.dim() == 3:
            x = x[None]
        x = x.to(self.device).contiguous()
        z, seg = self.forward(x)
        return self.postprocess(z, seg, tuple(x.shape[1:3]), orig_hw, conf, iou)

    def warmup(self, in_hw: Tuple[int, int], orig_hw: Tuple[int, int], **kw) -> None:
        """One call on a blank bs1 frame of ``in_hw``: builds the kernels and
        warms the allocator and cuDNN for that geometry."""
        self(np.zeros((1, *in_hw, 3), np.uint8), orig_hw, **kw)

    def postprocess(self, z: torch.Tensor, seg: Optional[torch.Tensor],
                    in_hw: Tuple[int, int], orig_hw: Tuple[int, int],
                    conf: float = 0.25, iou: float = 0.45):
        """NMS, letterbox unmap and class map of :meth:`forward`'s outputs,
        on the device they lie on; returns what ``__call__`` returns."""
        with torch.inference_mode():
            # serving caps (multiyolov5_tpu/engine.py:414-436): 1024 candidates, 300 dets
            boxes, valid = nms_planar(z, conf, iou, max_nms=1024, max_det=300)
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
            masks = None
            if seg is not None:
                via = (seg.shape[2] * 8, seg.shape[3] * 8)
                masks = upsample_argmax(seg.contiguous(), orig_hw, via_hw=via)
        boxes, valid = boxes.cpu().numpy(), valid.cpu().numpy()
        dets = [boxes[i][valid[i]] for i in range(boxes.shape[0])]
        if masks is None:
            return dets, [None] * len(dets)
        return dets, list(masks.cpu().numpy())
