"""Global-batch BatchNorm: the JAX step's BN semantics over the world of ranks.

The JAX package's step, jitted over a mesh, computes every BN's training
moments over the global batch (its trainer.py:196-223), so ``--sync-bn`` is
a no-op there.  :class:`GlobalBatchNorm2d` gives the port the same: its
moments cover every batch row and every H shard of the mesh's world.
``torch.nn.SyncBatchNorm`` is no substitute: it raises on CPU tensors, and
the tests here run the same code the card runs.

The moments merge per-rank (count, mean, centred sum of squares) triples
(Chan et al.'s pairwise update), gathered in one all-gather: the float32
error does not grow with the element count, as a raw sum of squares' does.
Momentum, eps and the unbiased running variance are ``nn.BatchNorm2d``'s,
so the statistics equal one BN's over the concatenated batch.  Tensors
that every rank of the model group holds whole (ops/shard.py ``whole``)
are counted once, over the data group; a rank that holds none of a split
map's rows counts none.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import shard
from .comm import all_gather_stacked


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """An ``nn.BatchNorm2d`` whose training moments span ``self.mesh``'s
    world; in eval mode, or on a mesh of one rank, it is the plain BN.
    Made by :func:`convert`, which keeps the module's parameters, buffers
    and ``state_dict`` keys."""

    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.mesh is None or self.mesh.size == 1:
            return super().forward(x)
        s = shard.active()
        group = self.mesh.data if s is not None and s.whole else self.mesh.world
        xf = x.float()
        n = x.numel() // x.shape[1]
        mean = xf.mean((0, 2, 3))
        m2 = torch.square(xf - mean[None, :, None, None]).sum((0, 2, 3))
        part = torch.stack([torch.full_like(mean, float(n)), mean, m2])       # (3, C)
        if not shard.holds_rows():      # a copy of another rank's rows: counts none
            part = part * 0.0
        cnt, means, m2s = all_gather_stacked(part, group).unbind(1)            # (ranks, C)
        total = cnt.sum(0)
        mean = (cnt * means).sum(0) / total
        var = (m2s.sum(0) + (cnt * torch.square(means - mean)).sum(0)) / total
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            mom = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                   else self.momentum)
            self.running_mean.mul_(1 - mom).add_(mean.detach(), alpha=mom)
            self.running_var.mul_(1 - mom).add_(
                var.detach() * (total / (total - 1)), alpha=mom)
        inv = torch.rsqrt(var + self.eps)
        y = (xf - mean[None, :, None, None]) * (self.weight * inv)[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(x.dtype)


def convert(model: nn.Module, mesh) -> nn.Module:
    """Make every ``nn.BatchNorm2d`` of ``model`` a :class:`GlobalBatchNorm2d`
    over ``mesh`` (in place; returns ``model``)."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.__class__ = GlobalBatchNorm2d
            m.mesh = mesh
    return model
