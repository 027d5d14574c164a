"""Dual-task train step and training state (counterpart of
``multiyolov5_tpu/train/trainer.py``).

Each call of the step reproduces the reference's schedule (reference
train.py:335-401): a detection forward and backward, then a segmentation
forward and backward, the BN running statistics advancing in both.  The
gradients accumulate in the parameters' ``.grad`` across calls; when
``do_update`` is set, one SGD (nesterov) or Adam step over the 3 param
groups fires, the EMA of every float ``state_dict`` entry follows, and the
gradients are zeroed.  Compute runs under bf16 autocast by default, with
float32 parameters and no GradScaler, as the JAX package's bf16 compute
does; ``compute_dtype=torch.float32`` runs it in float32.  On the card the
model runs channels_last.

The seg loss is K6 (ops/kernels/seg_ce.py) wherever the JAX package would
call ``seg_ce_up8`` (its trainer.py:125-141: plain CE without aux heads, a
PSP/Base/Lab head), on the card always, not only on a TPU.  The OHEM and
focal losses, and BiSe's aux heads (``seg_aux``: the main, aux16 and aux32
logits, weighted 1, ``seg_aux_weight * 1.5`` and ``seg_aux_weight / 2``),
upsample the logits to the label size and take the plain losses.

The step's ``rng`` (a ``torch.Generator`` on the model's device) feeds the
dropout of the Base and BiSe heads (ops/nn.Dropout); with ``rng=None`` they
drop nothing, as the JAX ``Ctx.dropout`` does with no rng.  ``remat``
recomputes each forward in the backward (``torch.utils.checkpoint``,
non-reentrant), as the JAX step's ``jax.checkpoint``: the recomputation
redraws the same dropout mask from the generator's saved state and leaves
the BN running statistics as the first forward left them (JAX's
checkpoint is functional, so its state comes from one forward).

Data parallelism (``mesh``, parallel/mesh.py): each rank runs the step on
its slice of the global batch, and the step is the JAX step jitted over
the mesh (its trainer.py:196-223).  Every BN takes its moments over the
world (parallel/sync_bn.py), the losses their normalisers over the global
batch (train/losses.py; K6 its global denominator), and each rank's loss
is its term of the global loss, so the sum of the ranks' gradients is the
global gradient: on update steps one all-reduce of the accumulated
``.grad`` (the sum is linear, so reducing the accumulation equals reducing
each step's).  A flat all-reduce of the port's own, not DDP's reducer:
the step runs two backwards through one module and the det backward never
reaches the seg head, which DDP handles only with
``find_unused_parameters`` and a reducer per backward.  Optimizer, EMA and
the update count stay replicated (every rank applies the same summed
gradient).  ``cfg.batch_size`` is the global detection batch.  With
``n_model`` > 1 (dp x sp) the images' H axis is split over the model
group (parallel/spatial.py, ops/shard.py; in units of the largest stride,
so the shards may be uneven: ``shard_train_batch(mesh, batch, unit)`` and
the step's ``heights``, and a rank with no rows computes a copy of
another's): the forwards run sharded, the
det raw maps, seg logits and seg labels are gathered over the model group,
each rank of a model group takes the loss of its data slice at
``1 / n_model`` (so each gradient is counted once across the model
group) with normalisers over the data group, and the seg loss takes the
plain path, as the JAX step turns ``fused_ce`` off under a model axis.

Not ported: ``pack_stem``, the ``det_hwna`` layout and the one-hot gather
(TPU layout work).
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..models.config import ModelSpec
from ..models.model import Model, init_model
from ..ops import shard
from ..ops.kernels import seg_ce
from ..ops.resize import resize_bilinear
from ..parallel import sync_bn
from ..parallel.comm import all_gather
from ..parallel.mesh import split_rows
from ..utils.checkpoint import to_jax_params
from . import optim
from .losses import DetectionLoss, ohem_ce_loss, seg_focal_loss, segmentation_loss


@dataclass
class TrainConfig:
    """The step's settings (the JAX package's TrainConfig less the epoch
    count, the seg batch size and the target cap, which its CLI reads)."""

    hyp: Dict[str, float]
    batch_size: int = 16               # detection batch size
    nbs: int = 64                      # nominal batch size
    detgain: float = 0.6               # reference train.py:290
    seggain: float = 0.35
    seg_loss: str = "ce"               # ce | ohem | focal
    seg_enabled: bool = True           # False = detection-only training
    seg_aux: bool = False              # BiSe head -> True (aux_num=2)
    seg_aux_weight: float = 0.1
    adam: bool = False
    quad: bool = False                 # quad collate (reference train.py:368)
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = False                # recompute each forward in the backward
    class_weight: Optional[np.ndarray] = None


@dataclass
class TrainState:
    """The training state, updated in place by the step.

    model: the unfused network, float32 parameters, in training mode; their
    ``.grad`` hold the gradients accumulated since the last update.  opt:
    {"momentum": {name: buffer}} for SGD, {"m": ..., "v": ..., "t": steps}
    for Adam.  ema: every ``state_dict`` entry (parameters, BN statistics,
    anchors) by name.  updates: optimizer steps taken."""

    model: Model
    opt: Dict[str, Any]
    ema: Dict[str, torch.Tensor]
    updates: int = 0

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's live ``state_dict`` entries, ``num_batches_tracked`` aside."""
        return {k: v for k, v in self.model.state_dict().items()
                if not k.endswith(".num_batches_tracked")}


def _load(model: Model, sd: Dict[str, torch.Tensor]) -> None:
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad = [k for k in missing if not k.endswith(".num_batches_tracked")] + unexpected
    if bad:
        raise KeyError(f"state_dict does not match the model: {bad[:8]}")


def create_train_state(spec: ModelSpec, cfg: TrainConfig, seed: int = 0,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None,
                       device="cuda") -> Tuple[TrainState, Dict[str, int]]:
    """(state, param groups) on ``device``: the weights of ``state_dict``
    (an unfused torch-layout one, e.g. ``from_jax_params`` of the JAX
    package's), or a seeded random init (models/model.init_model)."""
    dev = torch.device(device)
    model = Model(spec)
    if state_dict is None:
        init_model(model, torch.Generator().manual_seed(seed))
    else:
        _load(model, state_dict)
    model.to(dev)
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    model.train()
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = torch.zeros_like(p)
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
    opt = {"m": zeros(), "v": zeros(), "t": 0} if cfg.adam else {"momentum": zeros()}
    ts = TrainState(model, opt, {})
    ts.ema = {k: v.detach().clone() for k, v in ts.state_dict().items()}
    groups = optim.classify_params(params, dict(model.named_buffers()))
    return ts, groups


def _images(a, dev: torch.device) -> torch.Tensor:
    """(B, H, W, 3) host or device images -> float32 (B, 3, H, W) on
    ``dev``, channels_last on the card (the NHWC data as it lies)."""
    x = torch.as_tensor(a).to(dev).permute(0, 3, 1, 2).float()
    return x if dev.type == "cuda" else x.contiguous()


def _forward(model: Model, x: torch.Tensor, rng: Optional[torch.Generator], remat: bool,
             mesh=None, plan: Optional[shard.Plan] = None):
    """``model(x)`` with its dropout drawing from ``rng``, sharded over the
    mesh's model group as ``plan`` splits H when it has one; with ``remat``, under a
    non-reentrant checkpoint whose recomputation restarts ``rng`` from its
    state at the first forward (the same mask) and puts the BN running
    statistics back as that forward left them."""
    spatial = mesh is not None and mesh.n_model > 1

    def call(inp):
        ctx = (shard.sharded(mesh.model, mesh.data, plan) if spatial
               else contextlib.nullcontext())
        with model.dropout_rng(rng, mesh), ctx:
            return model(inp)

    if not remat:
        return call(x)
    rng_state = rng.get_state() if rng is not None else None
    calls = [0]

    def run(inp):
        again = calls[0] > 0
        calls[0] += 1
        if not again:
            return call(inp)
        bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
        saved = [(m.running_mean.clone(), m.running_var.clone(),
                  m.num_batches_tracked.clone()) for m in bns]
        now = rng.get_state() if rng is not None else None
        if rng is not None:
            rng.set_state(rng_state)
        try:
            return call(inp)
        finally:
            if rng is not None:
                rng.set_state(now)
            with torch.no_grad():
                for m, (mean, var, n) in zip(bns, saved):
                    m.running_mean.copy_(mean)
                    m.running_var.copy_(var)
                    m.num_batches_tracked.copy_(n)

    return checkpoint(run, x, use_reentrant=False)


def make_train_step(spec: ModelSpec, cfg: TrainConfig, groups: Dict[str, int], mesh=None):
    """Returns step(ts, det_imgs, det_tgts, det_mask, seg_imgs, seg_lbls,
    lr, lr_bias, momentum, do_update, rng=None, heights=None) -> (ts, metrics).

    det_imgs (B, H, W, 3) uint8; det_tgts (B, T, 5) [cls, xywh] normalized
    and det_mask (B, T) bool, from losses.pad_targets; seg_imgs (B', H', W',
    3) float in [0, 1]; seg_lbls (B', H', W') int, -1 unlabelled; host
    arrays or tensors.  On a ``mesh`` (every rank calls the step) they are
    this rank's slice (parallel/mesh.shard_train_batch); with ``n_model``
    > 1, ``heights`` is (det H, seg H) of the whole images, which fixes
    every rank's rows (mesh.split_rows).  ``rng``: the
    dropout generator (a ``torch.Generator`` on the model's device, the
    same seed on every rank), or None for no dropout.  metrics:
    {"det_items": (lbox, lobj, lcls, loss), "seg_loss", "total"}, the
    global batch's, tensors on the state's device (reading them
    synchronises)."""
    det_loss_fn = DetectionLoss(
        nc=spec.nc, na=spec.na,
        anchors=np.asarray(spec.anchors, np.float32).reshape(spec.nl, spec.na, 2)
        / np.asarray(spec.strides, np.float32)[:, None, None],
        strides=spec.strides, hyp=cfg.hyp)
    accumulate_target = max(round(cfg.nbs / cfg.batch_size), 1)
    # reference train.py:117 scales weight decay by total_bs*accumulate/nbs
    wd = cfg.hyp.get("weight_decay", 0.0) * cfg.batch_size * accumulate_target / cfg.nbs
    cw = None if cfg.class_weight is None else torch.as_tensor(cfg.class_weight,
                                                               dtype=torch.float32)
    seg_module = spec.rows[spec.seg_index].module if spec.seg_index is not None else None
    if cfg.seg_aux and cfg.seg_enabled and seg_module != "SegMaskBiSe":
        raise ValueError(f"seg_aux needs the BiSe head's aux pair, not {seg_module}")
    parallel = mesh is not None and mesh.size > 1
    spatial = mesh is not None and mesh.n_model > 1
    # the ranks whose losses add up to the global loss, and each one's share
    loss_group = (mesh.data if spatial else mesh.world) if parallel else None
    share = 1.0 / mesh.n_model if spatial else 1.0
    fused_ce = (cfg.seg_loss == "ce" and not cfg.seg_aux and not spatial
                and seg_module in ("SegMaskPSP", "SegMaskBase", "SegMaskLab"))
    low = cfg.compute_dtype != torch.float32
    aux_w = cfg.seg_aux_weight

    def seg_loss_fn(out, lbls):
        if fused_ce:
            return seg_ce(out, lbls, cw, group=loss_group)
        hw = tuple(lbls.shape[-2:])
        if isinstance(out, (list, tuple)):     # BiSe in training: main, aux16, aux32
            out = out if cfg.seg_aux else out[:1]
            up = [resize_bilinear(z, hw) for z in out]
        else:
            up = [resize_bilinear(out, hw)]
        if cfg.seg_loss == "ohem":
            return ohem_ce_loss(up, lbls, aux=cfg.seg_aux,
                                aux_weight=(aux_w * 1.5, aux_w / 2.0), group=loss_group)
        if cfg.seg_loss == "focal":
            return seg_focal_loss(up[0], lbls, group=loss_group)
        return segmentation_loss(up, lbls, aux=cfg.seg_aux, aux_num=2,
                                 aux_weight=aux_w, weight=cw, group=loss_group)

    def gathered(out, plan):
        """Under dp x sp, the whole maps of sharded outputs (raw maps,
        logits: H axis 2, W axis 3; labels: H axis 1, input rows), through
        autograd."""
        if not spatial:
            return out
        if isinstance(out, (list, tuple)):
            return [gathered(o, plan) for o in out]
        if out.dim() >= 4:
            return all_gather(out, mesh.model, 2, plan.at(out.shape[3]))
        return all_gather(out, mesh.model, 1, plan.rows)

    def plan_of(a, h: Optional[int]):
        """Under dp x sp, how the whole images' ``h`` rows split over the
        model group (mesh.split_rows in units of the largest stride, as
        mesh.shard_train_batch cut this rank's images ``a``, (B, h_r, W, 3))."""
        if not spatial:
            return None
        if h is None:
            raise ValueError("dp x sp: the step needs heights=(det H, seg H), the "
                             "whole images' rows")
        plan = shard.Plan(split_rows(h, mesh.n_model, max(spec.strides)), a.shape[2])
        if a.shape[1] != plan.rows[mesh.model_index]:
            raise ValueError(f"dp x sp: {a.shape[1]} rows on model index "
                             f"{mesh.model_index}, where mesh.split_rows gives {plan.rows} "
                             f"of {h}")
        return plan

    def inputs(x, plan):
        return shard.take_rows(x, plan, mesh.model) if spatial else x

    def all_reduce_grads(params) -> None:
        """Sum the accumulated gradients over the world, in one flat buffer."""
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh.world.all_reduce_(flat)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def update(ts: TrainState, lr: float, lr_bias: float, momentum: float) -> None:
        names, params = zip(*ts.model.named_parameters())
        grads = [p.grad for p in params]
        with torch.no_grad():
            if parallel:
                all_reduce_grads(params)
            if cfg.adam:
                ts.opt["t"] += 1
                optim.adam_update(names, params, grads, [ts.opt["m"][k] for k in names],
                                  [ts.opt["v"][k] for k in names], ts.opt["t"], groups,
                                  lr, lr_bias, momentum, wd)
            else:
                optim.sgd_update(names, params, grads,
                                 [ts.opt["momentum"][k] for k in names], groups, lr,
                                 lr_bias, momentum, wd)
            ts.updates += 1
            optim.ema_update(ts.ema, ts.state_dict(), optim.ema_decay(ts.updates))
            torch._foreach_zero_(grads)

    def step(ts: TrainState, det_imgs, det_tgts, det_mask, seg_imgs, seg_lbls,
             lr: float, lr_bias: float, momentum: float, do_update: bool,
             rng: Optional[torch.Generator] = None,
             heights: Optional[Tuple[int, int]] = None):
        model = ts.model
        dev = next(model.parameters()).device
        if parallel:
            sync_bn.convert(model, mesh)
        amp = torch.autocast(dev.type, dtype=cfg.compute_dtype, enabled=low)
        det_h, seg_h = heights or (None, None)
        plan = plan_of(det_imgs, det_h)
        with amp:
            det_raw, _ = _forward(model, inputs(_images(det_imgs, dev) / 255.0, plan), rng,
                                  cfg.remat, mesh, plan)
        dloss, ditems = det_loss_fn(gathered(det_raw, plan), torch.as_tensor(det_tgts).to(dev),
                                    torch.as_tensor(det_mask).to(dev), group=loss_group)
        dloss = dloss * cfg.detgain * (4.0 if cfg.quad else 1.0)
        (dloss * share).backward()
        terms = [dloss.detach()]
        if cfg.seg_enabled and spec.seg_index is not None:
            # second forward: the BN statistics already advanced on the det batch
            plan = plan_of(seg_imgs, seg_h)
            with amp:
                _, seg_out = _forward(model, inputs(_images(seg_imgs, dev), plan), rng,
                                      cfg.remat, mesh, plan)
            # reference train.py:386 scales the mean CE by the DETECTION
            # batch size (the two tasks share one accumulated optimizer step)
            sl = seg_loss_fn(gathered(seg_out, plan),
                             gathered(torch.as_tensor(seg_lbls).to(dev), plan)) \
                * cfg.batch_size * cfg.seggain
            (sl * share).backward()
            terms.append(sl.detach())
        else:
            terms.append(torch.zeros((), dtype=torch.float32, device=dev))
        # the global det and seg losses: each rank's terms summed
        dl, sloss = loss_group.sum(torch.stack(terms)) if parallel else terms
        total = dl + sloss
        if do_update:
            update(ts, lr, lr_bias, momentum)
        return ts, {"det_items": ditems, "seg_loss": sloss, "total": total}

    return step


def checkpoint_tree(ts: TrainState, spec: ModelSpec, epoch: Optional[int] = None,
                    best_fitness: Optional[float] = None) -> Dict[str, Any]:
    """The JAX package's training checkpoint (its cli/train.py:469-475), for
    utils/checkpoint.save_npz: HWIO conv weights, EMA beside the raw
    weights, the optimizer state and the update count."""
    params, state = to_jax_params(ts.state_dict())
    ema_params, ema_state = to_jax_params(ts.ema)
    if "momentum" in ts.opt:
        opt = to_jax_params(ts.opt["momentum"])[0]
    else:
        opt = (to_jax_params(ts.opt["m"])[0], to_jax_params(ts.opt["v"])[0],
               np.asarray(ts.opt["t"], np.int32))
    return {"params": params, "state": state, "ema_params": ema_params,
            "ema_state": ema_state, "opt": opt,
            "updates": np.asarray(ts.updates, np.int32), "epoch": epoch,
            "best_fitness": best_fitness, "spec_yaml": json.dumps(spec.yaml)}
