"""The ranks of tests/test_torch_parallel.py: module-level functions a
spawned process imports (torch and the port only, no JAX).

:func:`launch` starts ``world`` processes on a ``file://`` store under the
test's temporary directory (no port is shared between test workers), each
running :func:`rank_main` over the same list of jobs; a job is a name in
``JOBS`` and its keyword arguments, the global inputs every rank slices.
Each rank saves {job name: its result} with ``torch.save``; ``launch``
returns the ranks' results in rank order.  :func:`launch_cli` runs the
training CLI as ranks, its own rendezvous included.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class ThreadGroup:
    """One rank of a group whose ranks are threads of this process (see
    :func:`run_threads`): ``parallel/comm.Group``'s collectives over shared
    slots and a barrier, for quick checks of the sharded ops without
    spawning processes."""

    pg = None

    def __init__(self, size: int, index: int, box: dict):
        self.ranks, self.size, self.index, self._box = list(range(size)), size, index, box

    def _swap(self, t: torch.Tensor):
        self._box["slots"][self.index] = t.detach().clone()
        self._box["barrier"].wait()
        got = list(self._box["slots"])
        self._box["barrier"].wait()
        return got

    def all_reduce_(self, t):
        got = self._swap(t)
        t.copy_(sum(got[1:], got[0].clone()))
        return t

    def all_gather_raw(self, t):
        return torch.stack(self._swap(t.contiguous()))

    def broadcast_(self, t):
        t.copy_(self._swap(t)[0])
        return t

    def sum(self, t):
        return self.all_reduce_(t.detach().clone())


def run_threads(size: int, fn):
    """``fn(group, index)`` on ``size`` threads, each with its
    :class:`ThreadGroup`; their results in index order."""
    import threading

    box = {"slots": [None] * size, "barrier": threading.Barrier(size)}
    out, errors = [None] * size, []

    def one(i):
        try:
            out[i] = fn(ThreadGroup(size, i, box), i)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            box["barrier"].abort()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def launch(world: int, jobs, tmp_path, timeout_s: float = 240.0):
    out = os.path.join(str(tmp_path), f"ranks{world}")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    ctx = mp.start_processes(rank_main, args=(world, store, jobs, out), nprocs=world,
                             join=False, start_method="spawn")
    while not ctx.join(timeout=timeout_s):
        pass
    return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False) for r in range(world)]


def launch_cli(world: int, argv, tmp_path, timeout_s: float = 300.0):
    """``cli.train.main(argv)`` as ``world`` ranks (``--num-processes``,
    ``--process-id``); each rank's (save_dir, best fitness2)."""
    out = os.path.join(str(tmp_path), "cli_ranks")
    os.makedirs(out, exist_ok=True)
    ctx = mp.start_processes(cli_rank, args=(world, list(argv), out), nprocs=world,
                             join=False, start_method="spawn")
    while not ctx.join(timeout=timeout_s):
        pass
    return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False) for r in range(world)]


def cli_rank(rank: int, world: int, argv, out: str) -> None:
    from multiyolov5_tpu_torch.cli import train

    torch.set_num_threads(1)
    res = train.main(argv + ["--num-processes", str(world), "--process-id", str(rank)])
    torch.save(res, os.path.join(out, f"{rank}.pt"))


def rank_main(rank: int, world: int, store: str, jobs, out: str) -> None:
    from multiyolov5_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", world, rank, backend="gloo")
    res = {}
    try:
        for name, kw in jobs:
            res[name] = JOBS[kw.get("job", name)](**{k: v for k, v in kw.items() if k != "job"})
            dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out, f"{rank}.pt"))


def _mesh(n_data, n_model):
    from multiyolov5_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(n_data, n_model)


def _rows(a, mesh):
    from multiyolov5_tpu_torch.parallel.mesh import shard_batch
    return shard_batch(mesh, [a])[0]


def job_bn(x, grad, weight, bias, n_data=2, n_model=1):
    """A global-batch BN's output, input and parameter gradients and
    running statistics on this rank's slice ((B, C, H, W): batch rows,
    then H rows)."""
    from multiyolov5_tpu_torch.ops.nn import BN_EPS, BN_MOMENTUM
    from multiyolov5_tpu_torch.parallel import sync_bn
    from multiyolov5_tpu_torch.parallel.mesh import local_rows

    mesh = _mesh(n_data, n_model)
    bn = torch.nn.BatchNorm2d(x.shape[1], eps=BN_EPS, momentum=BN_MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    sync_bn.convert(bn, mesh).train()

    def mine(a):
        return local_rows(mesh, _rows(torch.from_numpy(a), mesh), 1, axis=2)

    xl = mine(x).requires_grad_(True)
    y = bn(xl)
    (y * mine(grad)).sum().backward()
    return {"y": y.detach(), "dx": xl.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "mean": bn.running_mean, "var": bn.running_var}


def job_det_loss(preds, tgts, tmask, nc, na, anchors, strides, hyp):
    """DetectionLoss on this rank's batch rows: the loss term, the items
    and the gradient of its slice of the raw maps."""
    from multiyolov5_tpu_torch.train.losses import DetectionLoss

    mesh = _mesh(2, 1)
    fn = DetectionLoss(nc=nc, na=na, anchors=anchors, strides=strides, hyp=hyp)
    ps = [_rows(torch.from_numpy(p), mesh).requires_grad_(True) for p in preds]
    loss, items = fn(ps, _rows(torch.from_numpy(tgts), mesh),
                     _rows(torch.from_numpy(tmask), mesh), group=mesh.world)
    loss.backward()
    return {"loss": loss.detach(), "items": items, "grads": [p.grad for p in ps]}


def job_seg_loss(logits, labels, kind, weight=None):
    """A seg loss on this rank's batch rows: its term and its logits'
    gradient.  kind: ohem | focal | ce | seg_ce_plain | prob_ohem."""
    from multiyolov5_tpu_torch.ops.kernels import seg_ce
    from multiyolov5_tpu_torch.train import losses as L

    mesh = _mesh(2, 1)
    z = _rows(torch.from_numpy(logits), mesh).requires_grad_(True)
    y = _rows(torch.from_numpy(labels), mesh)
    w = None if weight is None else torch.from_numpy(weight)
    g = mesh.world
    fns = {"ohem": lambda: L.ohem_ce_loss(z, y, group=g),
           "focal": lambda: L.seg_focal_loss(z, y, group=g),
           "ce": lambda: L.cross_entropy_seg(z, y, w, group=g),
           "prob_ohem": lambda: L.prob_ohem_ce_loss(z, y, min_kept=64, group=g),
           "seg_ce_plain": lambda: seg_ce(z, y, w, group=g)}
    loss = fns[kind]()
    loss.backward()
    return {"loss": loss.detach(), "dz": z.grad}


def _state(spec_dict, sd, head_cfg):
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.train.trainer import TrainConfig, create_train_state

    spec = load_spec(spec_dict)
    cfg = TrainConfig(compute_dtype=torch.float32, **head_cfg)
    ts, groups = create_train_state(spec, cfg, state_dict=sd, device="cpu")
    return spec, cfg, ts, groups


def job_step(spec_dict, sd, cfg_kw, batches, updates, n_data, n_model, seed=None,
             lr=(0.001, 0.002, 0.9)):
    """The port's train step over the mesh on this rank's slices of the
    global ``batches`` (H split in units of the largest stride); the state
    and each step's metrics."""
    from multiyolov5_tpu_torch.parallel.mesh import shard_train_batch
    from multiyolov5_tpu_torch.train.trainer import make_train_step

    mesh = _mesh(n_data, n_model)
    spec, cfg, ts, groups = _state(spec_dict, sd, cfg_kw)
    step = make_train_step(spec, cfg, groups, mesh=mesh)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    metrics = []
    for batch, up in zip(batches, updates):
        ts, m = step(ts, *shard_train_batch(mesh, batch, max(spec.strides)), *lr, up, rng=gen,
                     heights=(batch[0].shape[1], batch[3].shape[1]))
        metrics.append({k: v.clone() for k, v in m.items()})
    return {"state": ts.state_dict(), "ema": dict(ts.ema), "opt": ts.opt,
            "updates": ts.updates, "metrics": metrics}


def job_spatial(spec_dict, sd, x, n_data, n_model):
    """``spatial_forward`` (float32, fused) of the global batch ``x``."""
    from multiyolov5_tpu_torch.models.config import load_spec
    from multiyolov5_tpu_torch.models.model import Model
    from multiyolov5_tpu_torch.parallel.spatial import spatial_forward

    mesh = _mesh(n_data, n_model)
    model = Model(load_spec(spec_dict))
    model.load_state_dict(sd, strict=False)
    det, seg = spatial_forward(model, mesh, compute_dtype=torch.float32)(x)
    return {"det": det, "seg": seg}


def job_halo(x, top, bottom, fill):
    """``halo_exchange`` of this rank's H rows of ``x`` (B, C, H, W) over
    the world, and the gradient of each row for a seeded upstream."""
    from multiyolov5_tpu_torch.parallel.comm import halo_exchange
    from multiyolov5_tpu_torch.parallel.mesh import local_rows

    mesh = _mesh(1, dist.get_world_size())
    xl = local_rows(mesh, torch.from_numpy(x), 1, axis=2).requires_grad_(True)
    y = halo_exchange(xl, top, bottom, mesh.model, fill)
    g = torch.from_numpy(np.random.RandomState(mesh.rank).randn(*y.shape).astype(np.float32))
    (y * torch.where(torch.isfinite(y), g, 0.0)).sum().backward()
    return {"y": y.detach(), "g": g, "dx": xl.grad}


def job_sharded_ckpt(path, tree=None):
    """``save_sharded`` of ``tree`` (every rank), or ``load_sharded``."""
    from multiyolov5_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    if tree is not None:
        save_sharded(path, tree)
        return None
    return load_sharded(path)


JOBS = {"bn": job_bn, "det_loss": job_det_loss, "seg_loss": job_seg_loss,
        "step": job_step, "spatial": job_spatial, "halo": job_halo,
        "sharded_ckpt": job_sharded_ckpt}
