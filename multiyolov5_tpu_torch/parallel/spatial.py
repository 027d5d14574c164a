"""Spatial (H-axis) model parallelism (counterpart of
``multiyolov5_tpu/parallel/spatial.py``).

The JAX package shards the activations' H axis over the mesh's ``model``
axis with sharding annotations and lets GSPMD insert the halo exchanges and
gathers.  The port writes them: inside ops/shard.py's ``sharded`` context
each rank holds its rows of every map, convs and max pools with vertical
reach take halos from ``parallel/comm.halo_exchange`` (3x3 convs at
dilation 1-3 in C3, the neck, RFB2 and FFM; ASPP's dilations 3, 6 and 9;
stride-2 convs: 1 row above, none below; SPP's k5/9/13 pools, filled with
``-inf``), and the ops that read the whole map (the adaptive pools, the
global means, the align-corners bilinear resizes of the seg heads, the
neck's upsamples in any mode but nearest) work from a gather.  Focus, 1x1
convs, nearest upsamples and concats stay local.
Parameters are replicated.

H splits in units of the largest stride (mesh.split_rows), so a level's
shards are whole rows but need not be equal: H = 32k for any k, as GSPMD
takes any H.  The halos and gathers take each rank's row count (gloo
gathers equal sizes: the parts are padded to the largest and trimmed).
Where k < ``n_model``, a rank without rows computes a copy of the last
rank's and gives nothing.  Every row type runs sharded: the transformer
on the gathered map, the max pools on halos of ``-inf``, a zero pad's
rows on the first and last ranks that hold rows.

The forward is ``Model(kernels=False)``'s, as the JAX path forces
``sever=False``: the K1/K2/K7 kernels take whole maps.  The same sharded
forward, in training mode under global-batch BN, is the dp x sp train step
(train/trainer.py).
"""

from __future__ import annotations

import torch

from ..models.model import Model
from ..ops import shard
from ..ops.nn import fuse_conv_bn
from ..ops.resize import resize_bilinear
from .comm import all_gather
from .mesh import Mesh, split_rows


def spatial_forward(model: Model, mesh: Mesh, compute_dtype=torch.bfloat16,
                    fused: bool = True, decode: bool = True):
    """The eval forward of ``model`` (an unfused :class:`Model` on this
    rank's device) with the batch split over the mesh's data axis and H
    over its model axis.

    Returns ``fn(x)`` for the global batch of NHWC uint8/float frames in
    [0, 255] (every rank passes the same ``x``; each takes its slice).
    Outputs are replicated on every rank, as the JAX path's
    ``out_shardings=P()``: the decoded candidates (B, no, N) float32 (the
    raw per-level maps with ``decode=False``) and the seg logits upsampled
    to the input's size, (B, n_segcls, H, W) float32, or None.  ``fused``
    folds the BNs first (the JAX ``fused``).  H must be a multiple of the
    largest stride; the shards need not be even (:func:`spatial_sharding_ok`)."""
    spec = model.spec
    dev = next(model.parameters()).device
    net = model
    if fused:
        net = Model(spec, fused=True, kernels=False)
        net.load_state_dict(fuse_conv_bn({k: v.detach().cpu()
                                          for k, v in model.state_dict().items()}))
        net.to(dev)
    net.eval()
    det_mod = net.model[spec.detect_index] if spec.detect_index is not None else None
    low = compute_dtype != torch.float32

    @torch.no_grad()
    def fn(x) -> tuple:
        x = torch.as_tensor(x)
        hw = tuple(x.shape[1:3])
        plan = shard.Plan(split_rows(hw[0], mesh.n_model, max(spec.strides)), hw[1])
        b = x.shape[0] // mesh.n_data
        d = mesh.data_index
        src = shard.src_of(plan.rows, mesh.model_index)
        top = sum(plan.rows[:src])
        xs = x[d * b:(d + 1) * b, top:top + plan.rows[src]].to(dev)
        xs = xs.permute(0, 3, 1, 2).float().contiguous() / 255.0
        with torch.autocast(dev.type, dtype=compute_dtype, enabled=low), \
                shard.sharded(mesh.model, mesh.data, plan):
            raw, seg = net(xs, decode=False)
        rows = (lambda t: all_gather(t, mesh.data, 0)) if mesh.n_data > 1 else (lambda t: t)

        def whole(t):       # (B, ..., h, w[, no]): H axis 2, W axis 3
            return all_gather(t, mesh.model, 2, plan.at(t.shape[3]))

        det = None
        if raw is not None:
            raw = [rows(whole(r)) for r in raw]
            if decode:
                det = det_mod._decode([r.permute(0, 1, 4, 2, 3).flatten(1, 2) for r in raw])
            else:
                det = raw
        if seg is not None:
            seg = rows(resize_bilinear(whole(seg).float(), hw))
        return det, seg

    return fn


def spatial_sharding_ok(h: int, n_model: int, max_stride: int = 32) -> bool:
    """True when H shards evenly at every pyramid level (uneven shards run
    too, a rank taking a unit of ``max_stride`` rows more than another)."""
    return (h % (max_stride * n_model)) == 0
