"""NN helpers shared by the blocks (counterpart of ``multiyolov5_tpu/ops/nn.py``).

Parameters follow the reference PyTorch ``state_dict`` names and layouts
(OIHW conv weights), so the helpers here work on plain ``state_dict``s.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

# reference utils/torch_utils.py initialize_weights: every BN of the model
# runs at eps 1e-3 / momentum 0.03, not torch's 1e-5 / 0.1 defaults
BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k, d: int = 1):
    """'same' padding for an odd kernel, an int or an (kh, kw) pair
    (reference models/common.py:22-27)."""
    if isinstance(k, (tuple, list)):
        return tuple(d * (kk - 1) // 2 for kk in k)
    return d * (k - 1) // 2


def make_divisible(x: float, divisor: int = 8) -> int:
    """reference utils/general.py make_divisible (ceil to multiple)."""
    return int(math.ceil(x / divisor) * divisor)


def fuse_conv_bn(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold every conv-following BN of a ``state_dict`` into its conv.

    Same math as reference utils/torch_utils.py:182-202 (fuse_conv_and_bn):
      w' = w * gamma / sqrt(var + eps);  b' = beta - gamma * mean / sqrt(var + eps)
    A BN named ``<x>.bn`` belongs to ``<x>.conv``; a BN in a bare Sequential
    (``<x>.1``) belongs to its numeric predecessor (``<x>.0``).  The folded
    BN's weight, bias and running stats leave the dict.  A BN with no such
    conv (BottleneckCSP's and MixConv2d's post-concat BNs, ``nn.BatchNorm2d``
    rows, DAPPM's pre-activation BNs) keeps its entries: the fused model
    applies it from its running statistics (:func:`batch_norm`), as
    multiyolov5_tpu/ops/nn.py:565-568 skips it.  Math runs in float32
    numpy, in the JAX package's order, so both give equal weights.
    """
    out = {k: v for k, v in sd.items() if not k.endswith(".num_batches_tracked")}
    bns = sorted({k[:-len(".running_mean")] for k in out
                  if k.endswith(".running_mean")})
    for bn in bns:
        if bn.endswith(".bn"):
            conv = bn[:-len(".bn")] + ".conv"
        else:
            head, _, idx = bn.rpartition(".")
            conv = f"{head}.{int(idx) - 1}" if idx.isdigit() else ""
        w = out.get(conv + ".weight")
        gamma = np.asarray(out[bn + ".weight"], np.float32)
        if w is None or w.ndim != 4 or w.shape[0] != gamma.shape[0]:
            continue
        beta = np.asarray(out[bn + ".bias"], np.float32)
        mean = np.asarray(out[bn + ".running_mean"], np.float32)
        var = np.asarray(out[bn + ".running_var"], np.float32)
        scale = gamma / np.sqrt(var + BN_EPS)
        b = beta - mean * scale
        prev_b = out.pop(conv + ".bias", None)
        if prev_b is not None:
            b = b + np.asarray(prev_b, np.float32) * scale
        out[conv + ".weight"] = torch.from_numpy(
            np.asarray(w, np.float32) * scale[:, None, None, None])
        out[conv + ".bias"] = torch.from_numpy(np.asarray(b, np.float32))
        for suffix in (".weight", ".bias", ".running_mean", ".running_var"):
            del out[bn + suffix]
    return out


def batch_norm(bn: torch.nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """A BN that no conv absorbs: ``bn(x)`` in training mode; in eval mode
    scale = gamma * rsqrt(var + eps) and shift = beta - mean * gamma *
    rsqrt(var + eps) in float32, both cast to x's dtype, then x * scale +
    shift, as multiyolov5_tpu/ops/nn.py:361-366 applies it.  So a bfloat16
    engine (bf16 gamma and beta, float32 running statistics) rounds as the
    JAX one does."""
    if bn.training:
        return bn(x)
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    gamma = bn.weight.float()
    scale = (gamma * inv).to(x.dtype)
    shift = (bn.bias.float() - bn.running_mean.float() * gamma * inv).to(x.dtype)
    return x * scale[:, None, None] + shift[:, None, None]


class Dropout(torch.nn.Module):
    """Dropout whose mask comes from an explicit generator, as the JAX
    package's ``Ctx.dropout`` (multiyolov5_tpu/ops/nn.py:526-534) draws
    from the step's rng: in training mode with ``generator`` set (by
    ``models/model.Model.dropout_rng``), each element is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``; with no generator,
    or in eval mode, the input passes through unchanged.

    On a mesh (``mesh`` set with the generator) ``x`` is this rank's slice
    of the global batch, and the JAX mask is one draw over the global
    batch: every rank draws the global mask from the same generator and
    keeps its own batch rows and H rows, so a step's mask does not depend
    on the number of ranks."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.generator = None
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0 or self.generator is None:
            return x
        keep = 1.0 - self.p
        b, c, h, w = x.shape
        nd, nm = (1, 1) if self.mesh is None else (self.mesh.n_data, self.mesh.n_model)
        mask = torch.empty((b * nd, c, h * nm, w), dtype=torch.float32, device=x.device)
        mask.bernoulli_(keep, generator=self.generator)
        if self.mesh is not None:
            d, m = self.mesh.data_index, self.mesh.model_index
            mask = mask[d * b:(d + 1) * b, :, m * h:(m + 1) * h]
        return torch.where(mask.bool(), x / keep, 0.0).to(x.dtype)
