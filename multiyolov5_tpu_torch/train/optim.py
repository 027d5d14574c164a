"""Optimizer, EMA and schedules (counterpart of ``multiyolov5_tpu/train/optim.py``).

reference train.py:115-151: nominal batch 64 -> gradient accumulation,
weight-decay scaling, param groups (BN gains no-decay / weights decay /
biases no-decay), SGD(momentum, nesterov) or Adam, one-cycle cosine LR with
per-group warmup, ModelEMA decay 0.9999*(1-exp(-t/2000)).

The updates are written out, in the JAX package's order of operations, and
run in place on the parameters' own tensors, one ``torch._foreach`` call per
operation and group (the JAX package builds new arrays).  ``torch.optim.SGD``
would need its param groups' learning rates rewritten every warmup step and
orders nesterov's arithmetic differently.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

GROUP_BN, GROUP_WEIGHT, GROUP_BIAS = 0, 1, 2


def classify_params(params: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor]
                    ) -> Dict[str, int]:
    """Param-group assignment (reference train.py:120-137): BN gains -> 0
    (no decay), other weights -> 1 (decay), biases -> 2.  ``state`` holds
    the BN running statistics by name."""
    groups = {}
    for k in params:
        if k.endswith(".bias"):
            groups[k] = GROUP_BIAS
        elif k.endswith(".weight") and k[: -len(".weight")] + ".running_mean" in state:
            groups[k] = GROUP_BN
        else:
            groups[k] = GROUP_WEIGHT
    return groups


def _split(names: Sequence[str], groups: Dict[str, int]) -> Dict[int, List[int]]:
    out: Dict[int, List[int]] = {GROUP_BN: [], GROUP_WEIGHT: [], GROUP_BIAS: []}
    for i, k in enumerate(names):
        out[groups[k]].append(i)
    return out


def _pick(ts: Sequence[torch.Tensor], idx: Sequence[int]) -> List[torch.Tensor]:
    return [ts[i] for i in idx]


def sgd_update(names: Sequence[str], params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], bufs: Sequence[torch.Tensor],
               groups: Dict[str, int], lr: float, lr_bias: float, momentum: float,
               weight_decay: float, nesterov: bool = True) -> None:
    """torch.optim.SGD semantics, in place: g' = g + wd*w (weight group
    only); buf = mu*buf + g'; d = g' + mu*buf (nesterov) or buf; w -= lr*d,
    with ``lr_bias`` for the bias group (its own warmup ramp, reference
    train.py:348-352).  ``grads`` are left as they were."""
    for gid, idx in _split(names, groups).items():
        if not idx:
            continue
        p, b = _pick(params, idx), _pick(bufs, idx)
        g = _pick(grads, idx)
        if gid == GROUP_WEIGHT and weight_decay:
            g = torch._foreach_add(g, p, alpha=weight_decay)
        torch._foreach_mul_(b, momentum)
        torch._foreach_add_(b, g)
        d = torch._foreach_add(g, b, alpha=momentum) if nesterov else b
        torch._foreach_add_(p, d, alpha=-(lr_bias if gid == GROUP_BIAS else lr))


def adam_update(names: Sequence[str], params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], m: Sequence[torch.Tensor],
                v: Sequence[torch.Tensor], t: int, groups: Dict[str, int], lr: float,
                lr_bias: float, beta1: float, weight_decay: float, beta2: float = 0.999,
                eps: float = 1e-8) -> None:
    """torch.optim.Adam (reference --adam path, train.py:131) with coupled
    weight decay on the weight group, in place; ``t`` is the step number
    after this update (1 for the first)."""
    # bias corrections in float32, as the JAX package computes them
    bc1 = float(1 - np.float32(beta1) ** np.float32(t))
    bc2 = float(1 - np.float32(beta2) ** np.float32(t))
    for gid, idx in _split(names, groups).items():
        if not idx:
            continue
        p, mm, vv = _pick(params, idx), _pick(m, idx), _pick(v, idx)
        g = _pick(grads, idx)
        if gid == GROUP_WEIGHT and weight_decay:
            g = torch._foreach_add(g, p, alpha=weight_decay)
        torch._foreach_mul_(mm, beta1)
        torch._foreach_add_(mm, g, alpha=1 - beta1)
        torch._foreach_mul_(vv, beta2)
        torch._foreach_add_(vv, torch._foreach_mul(g, g), alpha=1 - beta2)
        den = torch._foreach_sqrt(torch._foreach_div(vv, bc2))
        torch._foreach_add_(den, eps)
        step = torch._foreach_div(torch._foreach_div(mm, bc1), den)
        torch._foreach_add_(p, step, alpha=-(lr_bias if gid == GROUP_BIAS else lr))


# ---------------------------------------------------------------------------
# EMA (reference utils/torch_utils.py:270-304)
# ---------------------------------------------------------------------------


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> float:
    """The decay after ``updates`` optimizer steps, in float64 (the JAX
    package's float32 ``1 - exp(-u/tau)`` is off by ~1e-4 relative at u = 1)."""
    return decay * (1.0 - math.exp(-updates / tau))


def ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor], d: float) -> None:
    """ema = ema*d + (1-d)*new, in place, for every float entry (torch
    ModelEMA covers the whole state_dict: params AND BN running stats);
    other entries are copied."""
    keys = [k for k, v in ema.items() if v.is_floating_point()]
    e = [ema[k] for k in keys]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, [new[k].to(ema[k].dtype) for k in keys], alpha=1.0 - d)
    for k, v in ema.items():
        if not v.is_floating_point():
            v.copy_(new[k])


# ---------------------------------------------------------------------------
# Schedules (host-side scalar math)
# ---------------------------------------------------------------------------


@dataclass
class WarmupCosine:
    """One-cycle cosine epoch schedule + linear per-iteration warmup
    (reference train.py:143-147, 344-352)."""

    lr0: float
    lrf: float
    epochs: int
    warmup_iters: int
    warmup_bias_lr: float = 0.1
    warmup_momentum: float = 0.8
    momentum: float = 0.937
    linear: bool = False

    def lf(self, epoch: float) -> float:
        if self.linear:
            return (1 - epoch / (self.epochs - 1)) * (1.0 - self.lrf) + self.lrf
        return ((1 - math.cos(epoch * math.pi / self.epochs)) / 2) * (self.lrf - 1) + 1

    def at(self, ni: int, epoch: int) -> Tuple[float, float, float]:
        """Returns (lr, lr_bias, momentum) for integrated batch ni."""
        base = self.lr0 * self.lf(epoch)
        if ni <= self.warmup_iters:
            xi = [0, max(self.warmup_iters, 1)]
            lr = float(np.interp(ni, xi, [0.0, base]))
            lr_bias = float(np.interp(ni, xi, [self.warmup_bias_lr, base]))
            mom = float(np.interp(ni, xi, [self.warmup_momentum, self.momentum]))
            return lr, lr_bias, mom
        return base, base, self.momentum

    def accumulate_at(self, ni: int, nbs: int, total_bs: int) -> int:
        """Warmup-ramped gradient accumulation.  The reference (this fork,
        train.py:347) interps to math.floor(nbs/total_bs) and never
        reassigns after warmup, so the steady state IS that floor value."""
        end = max(math.floor(nbs / total_bs), 1)
        if ni <= self.warmup_iters:
            return max(1, int(round(np.interp(
                ni, [0, max(self.warmup_iters, 1)], [1, end]))))
        return end
