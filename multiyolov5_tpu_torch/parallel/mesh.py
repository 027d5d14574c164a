"""The process mesh (counterpart of ``multiyolov5_tpu/parallel/mesh.py``).

The reference trains on NCCL DDP (reference train.py:585-621).  The JAX
package lays its devices out as a (data, model) mesh and jits the step over
it.  The port keeps PyTorch's idiom, one process a rank: the world of
processes is the mesh's devices, and rank ``r`` sits at ``(r // n_model,
r % n_model)``, as ``np.reshape(devices, (n_data, n_model))`` lays them out.
Each rank holds its slice of the global batch: its batch rows (the data
axis) and, with ``n_model`` > 1, its H rows of the images and seg labels
(the model axis, parallel/spatial.py).

Backends: NCCL where every rank has a card of its own; gloo on the CPU, and
where ranks share a card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .comm import Group


@dataclass
class Mesh:
    """An (n_data, n_model) mesh as this rank sees it: its position and
    its three groups (the world, the ranks of its data index along the
    model axis, the ranks of its model index along the data axis)."""

    n_data: int
    n_model: int
    rank: int
    world: Group
    data: Group          # the ranks that hold other batch rows at this model index
    model: Group         # the ranks that hold other H rows of this batch slice

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def size(self) -> int:
        return self.n_data * self.n_model


def choose_backend(device: str, num_processes: int) -> str:
    """NCCL when each of ``num_processes`` ranks has a card of its own,
    gloo on the CPU and when ranks share a card (NCCL refuses two ranks on
    one device)."""
    if torch.device(device).type == "cuda" and num_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int, num_processes: int) -> torch.device:
    """The device of ``rank``: the CPU for a CPU ``device``; on the card
    ``cuda:rank`` when every rank has a card of its own, else the one card
    ``device`` names, shared."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if num_processes <= torch.cuda.device_count():
        return torch.device("cuda", rank)
    return torch.device("cuda", dev.index or 0)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: str = "cpu",
                           timeout_s: float = 1800.0) -> Optional[str]:
    """Join the process group (replaces reference env:// init_process_group,
    train.py:619).  ``coordinator`` is ``host:port`` of the rendezvous
    (``tcp://``), or a ``file://`` URL a test passes.  ``backend`` None
    takes :func:`choose_backend`'s for ``device``.  No-op for one process or when the group is
    already up; returns the backend, printed once by rank 0."""
    if not num_processes or num_processes <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator is None:
        raise ValueError("--num-processes > 1 needs --coordinator host:port")
    backend = backend or choose_backend(device, num_processes)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = rank_device(device, process_id, num_processes)
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    if process_id == 0:
        print(f"torch.distributed: {num_processes} processes over {backend}", flush=True)
    return backend


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) mesh over the world of processes; every rank
    calls it, in the same order as any other group it makes.  Raises
    ``ValueError`` unless n_data * n_model ranks exist (one process is a
    world of 1)."""
    world = world_size()
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_model < 1:
        raise ValueError(f"make_mesh: n_model must be >= 1, got {n_model}")
    if n_data is None:
        n_data = world // n_model
    need = n_data * n_model
    if need < 1 or need != world:
        raise ValueError(
            f"make_mesh: need {n_data}x{n_model}={need} ranks but the world has "
            f"{world} process(es). Start one process a rank (--num-processes "
            f"{max(need, 1)}) and give every rank a place on the mesh.")
    grid = np.arange(need).reshape(n_data, n_model)

    def group(ranks: Sequence[int], mine: bool):
        ranks = [int(r) for r in ranks]
        pg = dist.new_group(ranks) if world > 1 and len(ranks) > 1 else None
        return (ranks, pg) if mine else None

    data = model = None
    for m in range(n_model):            # every rank creates every group, in one order
        data = group(grid[:, m], rank % n_model == m) or data
    for d in range(n_data):
        model = group(grid[d], rank // n_model == d) or model
    world_pg = dist.group.WORLD if world > 1 else None
    return Mesh(n_data, n_model, rank, Group(range(world), rank, world_pg),
                Group(data[0], rank, data[1]), Group(model[0], rank, model[1]))


def round_batch_for_devices(bs: int, n_dev: int) -> int:
    """Round a batch size UP to the next multiple of ``n_dev`` so the batch
    axis shards evenly (reference analog: the DDP total_batch_size //
    world_size check, train.py:585-621)."""
    if n_dev <= 1:
        return bs
    return -(-bs // n_dev) * n_dev


def split_rows(h: int, parts: int, unit: int) -> Tuple[int, ...]:
    """Each of ``parts`` ranks' rows of ``h`` rows, in whole ``unit``s (the
    largest stride, so that every pyramid level splits into whole rows),
    as even as they go: the first ranks take one unit more.  A rank gets
    none where there are fewer units than ranks."""
    if h % unit:
        raise ValueError(f"shard: {h} rows are not a multiple of the stride {unit}")
    k = h // unit
    return tuple((k // parts + (r < k % parts)) * unit for r in range(parts))


def _part(a, axis: int, rows: Sequence[int], index: int):
    """Part ``index`` of ``a`` cut along ``axis`` into ``rows``."""
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(sum(rows[:index]), sum(rows[:index + 1]))
    return a[tuple(sl)]


def shard_batch(mesh: Mesh, tree):
    """This rank's batch rows of each array of a tuple or list (global
    batch first, rank 0's slice first)."""
    def mine(a):
        n = a.shape[0]
        if n % mesh.n_data:
            raise ValueError(f"shard: axis 0 of {n} does not split into {mesh.n_data}")
        return _part(a, 0, (n // mesh.n_data,) * mesh.n_data, mesh.data_index)

    return type(tree)(mine(a) for a in tree)


def shard_train_batch(mesh: Mesh, args, unit: int):
    """This rank's slice of the step's batch (det_imgs, det_tgts, det_mask,
    seg_imgs, seg_lbls), from the global batch: its batch rows, and with
    ``n_model`` > 1 its H rows of the images and seg labels, split in
    ``unit``s (the largest stride) as :func:`local_rows` splits them."""
    det_imgs, det_tgts, det_mask, seg_imgs, seg_lbls = shard_batch(mesh, list(args))
    det_imgs, seg_imgs, seg_lbls = (local_rows(mesh, a, unit)
                                    for a in (det_imgs, seg_imgs, seg_lbls))
    return det_imgs, det_tgts, det_mask, seg_imgs, seg_lbls


def local_rows(mesh: Mesh, a, unit: int, axis: int = 1):
    """This rank's H rows (``axis``) of a batch slice that every rank of
    its model group holds whole: what ``shard_train_batch`` takes of the
    images after a loader's shard-local batch.  H splits by
    :func:`split_rows` in ``unit``s (the largest stride, so every pyramid
    level splits into whole rows), so a rank may get a unit more than
    another, or none."""
    if mesh.n_model == 1:
        return a
    return _part(a, axis, split_rows(a.shape[axis], mesh.n_model, unit), mesh.model_index)


def replicate(mesh: Mesh, tensors):
    """Rank 0's values of each tensor in ``tensors`` (an iterable), on
    every rank, in place."""
    for t in tensors:
        mesh.world.broadcast_(t)


def host_barrier() -> None:
    """Wait until every rank reaches here; no-op in one process."""
    if world_size() > 1:
        dist.barrier()
