"""Joint detection + segmentation trainer (counterpart of
``multiyolov5_tpu/cli/train.py``; reference train.py).

The JAX CLI's flags, defaults and loop, with ``--device`` picking the card
("" is ``cuda``, a number ``cuda:N``, ``cpu`` the plain versions on the
CPU): interleaved det/seg batches sharing one optimizer step through the
warmup-ramped gradient accumulation (train/trainer.py: bf16 autocast
unless ``--fp32``, channels_last on the card, K6 for the plain-CE seg
loss), SGD nesterov or Adam over 3 param groups, the one-cycle cosine with
per-group warmup (capped at half the run), EMA; the training loaders
(mosaic, mixup, ``random_perspective``, HSV, flips, ``--rect``, ``--quad``,
``--image-weights``, ``--cache-images``; the seg scale-crop-jitter) and
``--multi-scale``; autoanchor; after each epoch the EMA weights through an
``Engine`` (float32): ``seg_validation`` every ``--seg-eval-interval``
epochs and in the last ``--seg-eval-tail``, ``evaluate_detection`` (conf
0.001, iou 0.6) on a rect val loader built once; fitness2
(0.1 mAP50 + 0.2 mAP + 0.7 mIoU), ``results.txt``, ``last.npz`` /
``best.npz`` (the JAX checkpoint format, which its ``load_npz`` reads) and
``strip_optimizer`` at the end; ``--resume`` (optimizer state, EMA and the
update count restored; a finished run fine-tunes ``--epochs`` more) and
``--evolve``.  ``hyp.yaml`` and ``opt.yaml`` are written as JSON (JSON is
YAML); ``--data``, ``--hyp`` and ``--cfg`` files are read as JSON, or as
yaml where PyYAML is installed.  Unless ``--nosave``, ``labels.jpg`` and
the first three batches' mosaics (``train_batch{0,1,2}.jpg``); at the end
``results.png``, and ``evolve.png`` after ``--evolve`` (utils/plots.py, no
matplotlib).

Weights & Biases (utils/loggers.py, where wandb imports; else one printed
line says it is off): the run's scalars each epoch, ``--upload-dataset``
(dataset artifacts with ground-truth tables), box panels of the val
images every ``--bbox-interval`` epochs joined on the val table, model
artifacts of ``last.npz`` every ``--save-period`` epochs and at the end,
and ``--resume wandb-artifact://project/run_id``, which trains on from the
run's model artifact (the JAX checkpoint format: either CLI's artifact
resumes in the other).

The step's dropout (the Base and BiSe heads) draws from a
``torch.Generator`` on the device seeded from ``--seed``, as the JAX CLI
splits its rng key each step; the loaders draw from generators derived
from ``--seed``, the epoch and the position, so a run is reproducible.

Parallelism (parallel/mesh.py): ``--num-processes N --process-id R
--coordinator host:port`` runs one process a rank, started once per rank
(NCCL when every rank has a card of its own, gloo on the CPU and where
ranks share a card); ``--model-parallel M`` makes the mesh (N / M, M),
the image H axis split over M ranks (dp x sp).  Batch sizes round up to
the data axis as the JAX CLI's do, the loaders are shard-local (each data
index loads its slice; a model group's ranks take their H rows of it),
the step is the global-batch step (train/trainer.py), and rank 0 alone
evaluates and writes ``results.txt``, the checkpoints and the run files.
``--sync-bn`` is the JAX no-op: the global-batch BN is always on.

Not here: ``--no-pack-stem`` is accepted (the packed stem is TPU layout
work).  TensorBoard writes through ``torch.utils.tensorboard`` where it
imports, else one printed line says it is off.

Run: ``python -m multiyolov5_tpu_torch.cli.train --data d.json --cfg
yolov5s_city_seg --epochs 2 --device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..data.augment import resize_linear
from ..data.detection import DetectionDataset, DetectionLoader
from ..data.hyps import EVOLVE_META, load_hyp, read_yaml
from ..data.segmentation import get_citys_loader, get_citysbdd_loader, get_custom_loader
from ..engine import Engine
from ..evaluation import evaluate_detection, seg_validation
from ..models.config import load_spec
from ..models.model import Model, init_model
from ..parallel.mesh import (host_barrier, initialize_distributed, local_rows, make_mesh,
                             rank_device, replicate, round_batch_for_devices, world_size)
from ..train.optim import WarmupCosine
from ..train.trainer import (TrainConfig, checkpoint_tree, create_train_state,
                             make_train_step)
from ..utils import checkpoint as ckpt_lib
from ..utils.autoanchor import check_anchors
from ..utils.general import (get_latest_run, increment_path, labels_to_class_weights,
                             labels_to_image_weights, print_mutation, set_logging)
from ..utils.loggers import WandbLogger, check_wandb_resume, wandb_module
from ..utils.metrics import fitness2
from ..utils.plots import plot_evolution, plot_images, plot_labels, plot_results
from .detect import select_device


def multiscale_resize(imgs: np.ndarray, sf: float, gs: int) -> np.ndarray:
    """--multi-scale batch resize (reference train.py:354-361): both dims
    scaled by ``sf`` and rounded to the stride grid, cv2's ``INTER_LINEAR``."""
    if sf == 1.0:
        return imgs
    h0, w0 = imgs.shape[1:3]
    nh = max(int(round(h0 * sf / gs)) * gs, gs)
    nw = max(int(round(w0 * sf / gs)) * gs, gs)
    return np.stack([resize_linear(im, (nw, nh)) for im in imgs], 0)


def _batch_targets(n: int, tgts: np.ndarray, tmask: np.ndarray) -> np.ndarray:
    """A batch's padded targets as ``plot_images`` takes them: (k, 6) rows
    of [image, cls, xywh]."""
    if not tmask.any():
        return np.zeros((0, 6))
    return np.concatenate([np.repeat(np.arange(n), tmask.sum(1))[:, None], tgts[tmask]], 1)


def _opt_dict(opt) -> dict:
    return {k: (v if isinstance(v, (int, float, bool, str, list)) or v is None else str(v))
            for k, v in vars(opt).items()}


def _initial_state_dict(spec, seed: int):
    model = init_model(Model(spec), torch.Generator().manual_seed(seed))
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith(".num_batches_tracked")}


def _set_anchors(sd: dict, spec) -> None:
    """The Detect buffers of ``sd`` from ``spec.anchors`` (pixels)."""
    a = np.asarray(spec.anchors, np.float32).reshape(spec.nl, -1, 2)
    d = spec.detect_index
    sd[f"model.{d}.anchors"] = torch.from_numpy(
        a / np.asarray(spec.strides, np.float32)[:, None, None])
    sd[f"model.{d}.anchor_grid"] = torch.from_numpy(a.reshape(spec.nl, 1, -1, 1, 1, 2).copy())


def _restore(ts, tree, device) -> None:
    """Optimizer state, EMA and the update count of a training checkpoint
    (the JAX format: HWIO weights; SGD a dict of momentum buffers, Adam
    (m, v, t))."""
    opt = tree.get("opt")
    if opt is not None:
        def load(d):
            return {k: v.to(device) for k, v in ckpt_lib.from_jax_params(d, {}).items()}
        if isinstance(opt, dict):
            if "momentum" not in ts.opt:
                raise ValueError("the checkpoint holds SGD state; drop --adam to resume it")
            buf = load(opt)
            ts.opt["momentum"] = {k: buf[k] for k in ts.opt["momentum"]}
        else:
            if "m" not in ts.opt:
                raise ValueError("the checkpoint holds Adam state; pass --adam to resume it")
            m, v, t = opt
            ts.opt["m"], ts.opt["v"], ts.opt["t"] = load(m), load(v), int(t)
    if tree.get("ema_params"):
        ema = ckpt_lib.from_jax_params(tree["ema_params"], tree.get("ema_state") or {})
        merged, _ = ckpt_lib.intersect_load({k: v.cpu() for k, v in ts.ema.items()}, ema)
        ts.ema = {k: v.to(device) for k, v in merged.items()}
    if tree.get("updates") is not None:
        ts.updates = int(tree["updates"])


def _rank0_path(path: str, rank: int) -> str:
    """Rank 0's value of ``path`` on every rank."""
    if world_size() == 1:
        return path
    obj = [path if rank == 0 else None]
    torch.distributed.broadcast_object_list(obj, src=0)
    return obj[0]


def train(opt):
    """One training run; with ``--num-processes`` > 1, this rank's part of
    it (every rank calls it).  Returns (save_dir, best fitness2)."""
    set_logging()
    n_proc = max(1, opt.num_processes or 0)
    rank = opt.process_id if n_proc > 1 else 0
    # rendezvous before any other use of the devices (reference train.py:619)
    joined = n_proc > 1 and not torch.distributed.is_initialized()
    initialize_distributed(opt.coordinator, n_proc, rank, device=select_device(opt.device))
    try:
        return _train(opt, rank)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(opt, rank: int):
    world = world_size()
    device = rank_device(select_device(opt.device), rank, world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    main_rank = rank == 0
    hyp = load_hyp(opt.hyp)
    if opt.label_smoothing:
        hyp["label_smoothing"] = opt.label_smoothing
    save_dir = Path(_rank0_path(
        increment_path(Path(opt.project) / opt.name, exist_ok=opt.exist_ok), rank))
    wdir = save_dir / "weights"
    last, best = wdir / "last.npz", wdir / "best.npz"
    if main_rank:
        wdir.mkdir(parents=True, exist_ok=True)
        with open(save_dir / "hyp.yaml", "w") as fh:      # JSON is YAML
            json.dump(hyp, fh, indent=1)
        with open(save_dir / "opt.yaml", "w") as fh:
            json.dump(_opt_dict(opt), fh, indent=1)
    results_file = save_dir / "results.txt"

    data = read_yaml(opt.data)
    # W&B (reference train.py:40, wandb_utils.py:80-157), on rank 0: may swap
    # the dataset's splits for downloaded artifacts and, on a
    # wandb-artifact:// resume, point opt.weights at the pulled last.npz
    wandb_logger = None
    if main_rank:
        wandb_logger = WandbLogger(opt, save_dir.stem, None, data)
        if wandb_logger.enabled and wandb_logger.data_dict:
            data = wandb_logger.data_dict
        elif not opt.no_wandb and wandb_module() is None:
            print("W&B: off (wandb does not import)")
    nc = 1 if opt.single_cls else int(data["nc"])
    names = ["item"] if opt.single_cls else data.get("names", [str(i) for i in range(nc)])
    spec = load_spec(opt.cfg, nc=nc)
    sd = _initial_state_dict(spec, opt.seed)

    # pretrained init (reference train.py:93-95 intersect_dicts)
    start_epoch, best_fitness = 0, 0.0
    resume_tree = None
    if opt.weights and os.path.exists(opt.weights):
        if opt.weights.endswith(".pt"):
            _, new, _ = ckpt_lib.load_pt(opt.weights)
        else:
            tree = ckpt_lib.load_npz(opt.weights)
            new = ckpt_lib.from_jax_params(tree["params"], tree["state"])
            if opt.resume:
                start_epoch = int(tree.get("epoch", -1)) + 1
                best_fitness = float(tree.get("best_fitness") or 0.0)
                resume_tree = tree
                if start_epoch <= 0:
                    raise ValueError(f"{opt.weights} has no training epochs recorded, "
                                     "nothing to resume")
                if opt.epochs <= start_epoch:
                    # reference train.py:174-177: a finished run fine-tunes
                    # for `epochs` ADDITIONAL epochs
                    print(f"{opt.weights} trained for {start_epoch} epochs; "
                          f"fine-tuning {opt.epochs} additional epochs")
                    opt.epochs += start_epoch
        sd, n = ckpt_lib.intersect_load(sd, new)
        print(f"transferred {n} items from {opt.weights}")
        key = f"model.{spec.detect_index}.anchors"
        if key in new and tuple(new[key].shape) == tuple(sd[key].shape):
            # the checkpoint's anchors (an autoanchored run's) are the loss's too
            a = new[key].numpy() * np.asarray(spec.strides, np.float32)[:, None, None]
            spec.anchors = [list(map(float, lv.reshape(-1))) for lv in a]

    imgsz = opt.img_size[0] if isinstance(opt.img_size, list) else opt.img_size
    gs = max(spec.strides)
    bs = opt.batch_size
    # the mesh (JAX CLI :140-162): --model-parallel N splits the image H
    # axis over N ranks, the rest is data parallel; batch sizes round UP to
    # the data axis, never silently to one device
    n_mp = max(1, opt.model_parallel)
    if world % n_mp:
        raise SystemExit(f"--model-parallel {n_mp} does not divide the {world} processes")
    n_data = world // n_mp
    mesh = make_mesh(n_data, n_mp) if world > 1 else None
    if world > 1:
        seg_bs0 = opt.seg_batch_size or bs
        # --quad: collate_fn4 merges 4 loader images into one, so the
        # collated det batch (bs/4) is what must divide the data axis
        new_bs = (4 * round_batch_for_devices(-(-bs // 4), n_data)
                  if opt.quad else round_batch_for_devices(bs, n_data))
        new_seg = round_batch_for_devices(seg_bs0, n_data)
        if (new_bs, new_seg) != (bs, seg_bs0) and main_rank:
            print(f"NOTE: rounding batch sizes up for {n_data}-way data parallelism: "
                  f"det {bs}->{new_bs}, seg {seg_bs0}->{new_seg}")
        bs = new_bs
        opt.seg_batch_size = new_seg
    d_index = 0 if mesh is None else mesh.data_index
    # scale loss gains to detect layers / classes / image size (reference train.py:248-250)
    nl = spec.nl
    hyp["box"] *= 3.0 / nl
    hyp["cls"] *= nc / 80.0 * 3.0 / nl
    hyp["obj"] *= (imgsz / 640) ** 2 * 3.0 / nl

    # shard-local loaders: each data index loads its slice of every batch
    # (DistributedSampler analog, reference utils/datasets.py:76)
    bs_local = bs // n_data
    train_ds = DetectionDataset(data["train"], img_size=imgsz, batch_size=bs_local, augment=True,
                                hyp=hyp, rect=opt.rect, stride=gs, single_cls=opt.single_cls,
                                cache_images=opt.cache_images,
                                image_weights=opt.image_weights)
    if opt.quad:
        opt.max_targets *= 4    # collate_fn4 merges 4 images' labels into one item
    train_loader = DetectionLoader(train_ds, batch_size=bs_local, max_targets=opt.max_targets,
                                   shuffle=True, workers=opt.workers, seed=opt.seed,
                                   quad=opt.quad, shard=d_index, num_shards=n_data)
    nb = len(train_loader)

    seg_enabled = bool(data.get("segtrain")) and spec.seg_index is not None
    seg_kind = opt.seg_data_kind
    seg_factory = {"citys": get_citys_loader, "citysbdd": get_citysbdd_loader,
                   "custom": get_custom_loader}[seg_kind]
    seg_kwargs = dict(root=data.get("segtrain"), split="train", mode="train",
                      batch_size=(opt.seg_batch_size or bs) // n_data, workers=opt.workers,
                      base_size=opt.base_size, seed=opt.seed, shard=d_index,
                      num_shards=n_data)
    segval_kwargs = dict(root=data.get("segval"), split="val",
                         mode="val" if seg_kind == "citysbdd" else "testval",
                         batch_size=max(bs // 8, 1), workers=opt.workers,
                         base_size=opt.base_size)
    if seg_kind == "custom":
        seg_kwargs["n_segcls"] = spec.n_segcls
        segval_kwargs["n_segcls"] = spec.n_segcls
        segval_kwargs["batch_size"] = 1
    else:
        seg_kwargs["crop_size"] = (imgsz, imgsz // 2)
        segval_kwargs["crop_size"] = (512, 512)
    seg_loader = seg_factory(**seg_kwargs) if seg_enabled else None
    segval_loader = seg_factory(**segval_kwargs) if seg_enabled and main_rank else None
    if seg_enabled and len(seg_loader) == 0:
        raise ValueError(f"{data['segtrain']}: fewer seg training images than one batch "
                         f"({seg_loader.bs})")
    if not seg_enabled:
        print("detection-only training (no segtrain in the dataset file or no seg "
              "head in the model)")
    if not opt.nosave and main_rank:     # reference train.py:217-218
        labelled = [lb for lb in train_ds.labels if len(lb)]
        plot_labels(np.concatenate(labelled, 0) if labelled else np.zeros((0, 5)), names,
                    save_dir)

    if not opt.noautoanchor:    # reference train.py:224
        old = [list(a) for a in spec.anchors]
        check_anchors(train_ds, spec, np.random.RandomState(opt.seed),
                      thr=hyp["anchor_t"], imgsz=imgsz)
        if [list(a) for a in spec.anchors] != old:
            _set_anchors(sd, spec)
    cw = labels_to_class_weights(train_ds.labels, nc)
    # BiSe's training forward returns [main, aux16, aux32]: its aux loss is
    # structural (reference train.py:383-388)
    seg_aux = opt.seg_aux or (spec.seg_index is not None
                              and spec.rows[spec.seg_index].module == "SegMaskBiSe")

    cfg = TrainConfig(hyp=hyp, batch_size=bs, detgain=opt.detgain, seggain=opt.seggain,
                      seg_loss=opt.seg_loss, seg_enabled=seg_enabled, seg_aux=seg_aux,
                      adam=opt.adam, quad=opt.quad, remat=opt.remat,
                      compute_dtype=torch.float32 if opt.fp32 else torch.bfloat16)
    ts, groups = create_train_state(spec, cfg, seed=opt.seed, state_dict=sd, device=device)
    if resume_tree is not None:
        _restore(ts, resume_tree, device)
    if mesh is not None:
        # rank 0's weights, optimizer state and EMA on every rank
        replicate(mesh, [*ts.model.state_dict().values(), *ts.ema.values(),
                         *[v for k, d in ts.opt.items() if k != "t" for v in d.values()]])
        if main_rank:
            print(f"data-parallel over {n_data} ranks"
                  + (f" x spatial over {n_mp}" if n_mp > 1 else ""))
    step = make_train_step(spec, cfg, groups, mesh=mesh)

    nbs = 64
    nw = max(round(hyp["warmup_epochs"] * nb), 800)
    # cap warmup at half the run (reference train.py:262, commented out
    # there: without it tiny runs never leave warmup)
    nw = min(nw, max((opt.epochs - start_epoch) * nb // 2, 1))
    sched = WarmupCosine(lr0=hyp["lr0"], lrf=hyp["lrf"], epochs=opt.epochs,
                         warmup_iters=nw, warmup_bias_lr=hyp["warmup_bias_lr"],
                         warmup_momentum=hyp["warmup_momentum"],
                         momentum=hyp["momentum"], linear=opt.linear_lr)

    tb = None
    if not opt.no_tb and main_rank:
        try:
            from torch.utils.tensorboard import SummaryWriter
            tb = SummaryWriter(str(save_dir))
        except ImportError:
            print("TensorBoard: off (torch.utils.tensorboard does not import)")

    val_loader = None       # the det val loader is shape-stable across epochs
    if data.get("val") and not opt.noval and main_rank:
        val_ds = DetectionDataset(data["val"], img_size=opt.img_size_test, batch_size=bs,
                                  augment=False, rect=True, stride=gs, pad=0.5,
                                  single_cls=opt.single_cls)
        val_loader = DetectionLoader(val_ds, batch_size=bs, max_targets=300,
                                     workers=opt.workers, drop_last=False)

    gen = torch.Generator(device).manual_seed(opt.seed)   # the step's dropout
    ms_rng = np.random.RandomState(opt.seed)              # --multi-scale draws
    print(f"Image sizes {imgsz} train; {nb} det batches/epoch; "
          f"starting training for {opt.epochs} epochs...")
    t0 = time.time()
    miou = 0.0
    maps = np.zeros(nc)
    results = (0, 0, 0, 0, 0, 0, 0)
    dummy_seg = (np.zeros((2, 64, 64, 3), np.float32), np.full((2, 64, 64), -1, np.int64))
    for epoch in range(start_epoch, opt.epochs):
        # the loaders' epochs follow the run's, so a resumed run draws what
        # an uninterrupted one would
        train_loader.epoch = epoch
        if seg_enabled:
            seg_loader.epoch = epoch
        if opt.image_weights:
            # per-class weights scaled by (1 - mAP) -> image resampling
            # (reference train.py:303-316)
            iw = labels_to_image_weights(train_ds.labels, nc, cw * (1 - maps) ** 2 / nc)
            train_loader.set_image_weights(iw)
        mloss = np.zeros(4)
        msegloss = 0.0
        mloss_dev = msegloss_dev = None
        ni_base = nb * epoch
        seg_iter = iter(seg_loader) if seg_enabled else None
        i = -1
        for i, (imgs, tgts, tmask, _, _) in enumerate(train_loader):
            if seg_enabled:
                try:
                    seg_imgs, seg_masks = next(seg_iter)
                except StopIteration:
                    seg_iter = iter(seg_loader)
                    seg_imgs, seg_masks = next(seg_iter)
            else:
                seg_imgs, seg_masks = dummy_seg
            if len(imgs) * n_data == 1 or (seg_enabled and len(seg_imgs) * n_data == 1):
                continue  # reference train.py:338 BN/SE batch-1 guard (global batch)
            if opt.multi_scale:
                # bucketed multi-scale (reference train.py:354-361), drawn from
                # a seeded generator of its own (the same on every rank); the
                # sizes stay whole multiples of the stride on every H shard
                sf = (0.5, 0.75, 1.0, 1.25, 1.5)[ms_rng.randint(5)]
                imgs = multiscale_resize(imgs, sf, gs * n_mp)
            ni = i + ni_base
            if ni < 3 and not opt.nosave and main_rank:     # reference train.py:413-415
                plot_images(imgs.astype(np.float32), _batch_targets(len(imgs), tgts, tmask),
                            fname=save_dir / f"train_batch{ni}.jpg", names=names)
            heights = (imgs.shape[1], seg_imgs.shape[1])
            if n_mp > 1:        # this rank's H rows of its data slice
                imgs, seg_imgs, seg_masks = (local_rows(mesh, a, gs) for a in
                                             (imgs, seg_imgs, seg_masks))
            lr, lr_bias, mom = sched.at(ni, epoch)
            accumulate = sched.accumulate_at(ni, nbs, bs)
            ts, metrics = step(ts, imgs, tgts, tmask, seg_imgs, seg_masks, lr, lr_bias,
                               mom, (ni % accumulate) == 0, rng=gen, heights=heights)
            # running sums on the device; read when printing and at the end
            mloss_dev = metrics["det_items"] if mloss_dev is None \
                else mloss_dev + metrics["det_items"]
            msegloss_dev = metrics["seg_loss"] if msegloss_dev is None \
                else msegloss_dev + metrics["seg_loss"]
            if i % opt.log_interval == 0 and main_rank:
                items = metrics["det_items"].cpu().numpy()
                segl = float(metrics["seg_loss"]) / bs
                print(f"epoch {epoch}/{opt.epochs - 1} it {i}/{nb} "
                      f"box {items[0]:.4f} obj {items[1]:.4f} cls {items[2]:.4f} "
                      f"seg {segl:.4f} lr {lr:.5f}", flush=True)
        if mloss_dev is not None:
            mloss = mloss_dev.cpu().numpy() / (i + 1)
            msegloss = float(msegloss_dev) / bs / (i + 1)

        # --- eval of the EMA weights (reference train.py:430-453), on rank 0
        # (reference rank-0 gating, train.py:430): the EMA is replicated ---
        if (seg_enabled and main_rank and (epoch % opt.seg_eval_interval == 0
                                           or epoch >= opt.epochs - opt.seg_eval_tail)) \
                or val_loader is not None:
            eng = Engine(spec=spec, state_dict={k: v.detach().cpu() for k, v in ts.ema.items()},
                         device=device, half=False)
            if seg_enabled and (epoch % opt.seg_eval_interval == 0
                                or epoch >= opt.epochs - opt.seg_eval_tail):
                _, miou = seg_validation(eng, segval_loader, nclass=spec.n_segcls or 1)
            if val_loader is not None:
                wl = None
                if wandb_logger is not None and wandb_logger.enabled:
                    wandb_logger.current_epoch = epoch
                    if wandb_logger.bbox_interval > 0 and epoch % wandb_logger.bbox_interval == 0:
                        wl = wandb_logger       # this epoch's box panels
                results, maps, _ = evaluate_detection(eng, val_loader, names=names,
                                                      conf_thres=0.001, iou_thres=0.6,
                                                      wandb_logger=wl)
            del eng
        fi = float(fitness2(np.array(results[:4]).reshape(1, -1), miou)[0])
        tags = ["train/box_loss", "train/obj_loss", "train/cls_loss", "train/seg_loss",
                "metrics/precision", "metrics/recall", "metrics/mAP_0.5",
                "metrics/mAP_0.5:0.95", "metrics/mIoU", "metrics/fitness2", "x/lr0"]
        vals = [*mloss[:3], msegloss, *results[:4], miou, fi,
                sched.at(nb * (epoch + 1), epoch)[0]]
        if tb is not None:
            for tag, val in zip(tags, vals):
                tb.add_scalar(tag, float(val), epoch)
        if wandb_logger is not None and wandb_logger.enabled:
            wandb_logger.log({t: float(v) for t, v in zip(tags, vals)})
            wandb_logger.end_epoch(best_result=fi > best_fitness)
        if main_rank:
            with open(results_file, "a") as fh:
                fh.write(f"{epoch} " + " ".join(
                    f"{x:.5g}" for x in (*mloss, msegloss, *results[:4], miou, fi)) + "\n")

        # --- checkpoint (reference train.py:474-499: --nosave skips all but
        # the final epoch, and --evolve never saves mid-run) ---
        final_epoch = epoch == opt.epochs - 1
        if main_rank and ((not opt.nosave)
                          or (final_epoch and not getattr(opt, "evolve", False))):
            ck = checkpoint_tree(ts, spec, epoch=epoch, best_fitness=max(best_fitness, fi))
            ckpt_lib.save_npz(str(last), ck)
            if fi > best_fitness:
                ckpt_lib.save_npz(str(best), ck)
            if wandb_logger is not None and wandb_logger.enabled and (
                    final_epoch or (opt.save_period > 0 and epoch % opt.save_period == 0)):
                # the model artifact (reference wandb_utils.py:179-191)
                wandb_logger.log_model(str(last), opt, epoch, fi, best=fi > best_fitness)
        best_fitness = max(best_fitness, fi)
        if main_rank:
            print(f"epoch {epoch} done: fitness2 {fi:.4f} (best {best_fitness:.4f}) "
                  f"mIoU {miou:.4f}")

    if main_rank:
        for f in (last, best):      # finalize (reference strip_optimizer)
            if f.exists():
                ckpt_lib.strip_optimizer(str(f))
        plot_results(results_file, save_dir)
    if tb is not None:
        tb.close()
    if wandb_logger is not None:
        wandb_logger.finish()
    host_barrier()          # rank 0's files are written before any rank returns
    if main_rank:
        print(f"{opt.epochs - start_epoch} epochs completed in "
              f"{(time.time() - t0) / 3600:.3f} hours. Results: {save_dir}")
    return str(save_dir), best_fitness


def evolve(opt, generations: int = 300):
    """Genetic hyperparameter evolution (reference train.py:638-717): each
    generation mutates from the evolve.txt elite (80% mutation probability,
    sigma 0.2, parent weighted by fitness among the top 5), trains, and
    appends (fitness, hyps).  The draws come from ``np.random.RandomState``
    seeded by ``--seed`` and the generation (the JAX CLI reseeds the global
    generator from the clock)."""
    meta = EVOLVE_META
    opt.noval, opt.nosave = False, True
    evolve_file = Path(opt.project) / "evolve.txt"
    evolve_file.parent.mkdir(parents=True, exist_ok=True)
    base_hyp = load_hyp(opt.hyp)
    keys = [k for k in meta if k in base_hyp]
    for gen in range(generations):
        hyp = dict(base_hyp)
        if evolve_file.exists() and evolve_file.stat().st_size:
            npr = np.random.RandomState(opt.seed + gen)
            x = np.loadtxt(str(evolve_file), ndmin=2)
            n = min(5, len(x))
            x = x[np.argsort(-x[:, 0])][:n]           # column 0: each generation's fitness2
            w = x[:, 0] - x[:, 0].min() + 1e-6
            parent = x[npr.choice(n, p=w / w.sum())]
            for i, k in enumerate(keys):
                hyp[k] = float(parent[i + 5])
            mp, s = 0.8, 0.2
            g = np.array([meta[k][0] for k in keys])
            v = np.ones(len(keys))
            while (v == 1).all():
                v = (g * (npr.random_sample(len(keys)) < mp) * npr.randn(len(keys))
                     * npr.random_sample() * s + 1).clip(0.3, 3.0)
            for i, k in enumerate(keys):
                hyp[k] = float(hyp[k] * v[i])
        for k in keys:  # clip to bounds
            hyp[k] = float(np.clip(hyp[k], meta[k][1], meta[k][2]))

        gen_opt = argparse.Namespace(**vars(opt))
        gen_opt.evolve = False
        gen_opt.name = f"evolve_gen{gen}"
        gen_opt.exist_ok = True
        hyp_path = Path(tempfile.mkdtemp()) / "hyp_evolve.yaml"
        with open(hyp_path, "w") as fh:
            json.dump(hyp, fh)
        gen_opt.hyp = str(hyp_path)
        _, fi = train(gen_opt)
        print_mutation({k: hyp[k] for k in keys}, (fi, 0, 0, 0, 0),
                       yaml_file=str(Path(opt.project) / "hyp_evolved.yaml"),
                       evolve_txt=str(evolve_file))
        print(f"evolve gen {gen}: fitness {fi:.4f} -> {evolve_file}")
    plot_evolution(str(evolve_file), keys)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--weights", type=str, default="", help="initial weights")
    p.add_argument("--cfg", type=str, default="yolov5s_city_seg")
    p.add_argument("--data", type=str, default="data/cityscapes_det.yaml")
    p.add_argument("--hyp", type=str, default="scratch")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=18)
    p.add_argument("--seg-batch-size", type=int, default=0, help="0 = same")
    p.add_argument("--img-size", nargs="+", type=int, default=[832, 1024])
    p.add_argument("--base-size", type=int, default=1024, help="seg long side")
    p.add_argument("--rect", action="store_true")
    p.add_argument("--resume", nargs="?", const=True, default=False)
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--noval", action="store_true", help="skip det eval")
    p.add_argument("--noautoanchor", action="store_true")
    p.add_argument("--evolve", action="store_true")
    p.add_argument("--evolve-generations", type=int, default=300)
    p.add_argument("--cache-images", action="store_true")
    p.add_argument("--image-weights", action="store_true")
    p.add_argument("--device", default="",
                   help="'' or N: the card (cuda, cuda:N); cpu: the plain versions on the CPU")
    p.add_argument("--multi-scale", action="store_true")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--adam", action="store_true")
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--sync-bn", action="store_true",
                   help="no-op: the global-batch BN is always on under data parallelism")
    p.add_argument("--quad", action="store_true",
                   help="quad dataloader: fold 4 images into one 2x-res "
                        "batch item (reference collate_fn4, loss x4)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--model-parallel", type=int, default=1,
                   help="shard the image H axis over this many ranks "
                        "(dp x sp; processes = data_parallel * model_parallel)")
    # one process a rank (reference --local_rank/env:// DDP, train.py:585-621):
    # start every rank with the same coordinator address
    p.add_argument("--coordinator", default=None,
                   help="host:port of the rendezvous (or a file:// URL)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="total processes, one a rank (0/1 = one process)")
    p.add_argument("--process-id", type=int, default=0, help="this process's rank")
    p.add_argument("--project", default="runs/train")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-targets", type=int, default=128)
    p.add_argument("--detgain", type=float, default=0.6)
    p.add_argument("--seggain", type=float, default=0.35)
    p.add_argument("--seg-loss", choices=["ce", "ohem", "focal"], default="ce")
    p.add_argument("--seg-aux", action="store_true", help="BiSe aux heads")
    p.add_argument("--seg-data-kind", choices=["citys", "citysbdd", "custom"],
                   default="citys")
    p.add_argument("--seg-eval-interval", type=int, default=10)
    p.add_argument("--seg-eval-tail", type=int, default=40)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--no-pack-stem", action="store_true",
                   help="accepted: the packed 4x4-s2d train stem is TPU layout work "
                        "the port does not have")
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--no-tb", action="store_true", help="disable TensorBoard")
    p.add_argument("--no-wandb", action="store_true", help="disable W&B")
    p.add_argument("--upload-dataset", action="store_true",
                   help="upload dataset as a W&B artifact")
    p.add_argument("--bbox-interval", type=int, default=-1,
                   help="W&B bbox-debug-panel epoch interval (-1 = epochs/10)")
    p.add_argument("--artifact-alias", type=str, default="latest",
                   help="dataset artifact version to use")
    p.add_argument("--save-period", type=int, default=-1,
                   help="log model artifact every N epochs (-1 = final only)")
    p.add_argument("--img-size-test", type=int, default=1024)
    return p


def main(argv=None):
    opt = build_parser().parse_args(argv)
    if check_wandb_resume(opt):
        # wandb-artifact:// resume: WandbLogger pulls the checkpoint and the
        # stored run config inside train() (reference wandb_utils.py:42-53)
        pass
    elif opt.resume and not opt.weights:
        # resolve the checkpoint and reuse the run's saved settings
        # (reference train.py:596-603)
        ckpt = opt.resume if isinstance(opt.resume, str) else get_latest_run(opt.project)
        if not (ckpt and os.path.isfile(ckpt)):
            raise FileNotFoundError(f"--resume checkpoint not found: {ckpt!r}")
        opt_yaml = Path(ckpt).parent.parent / "opt.yaml"
        if opt_yaml.is_file():
            saved = read_yaml(str(opt_yaml)) or {}
            for k, v in saved.items():
                if hasattr(opt, k) and k not in ("resume", "weights", "exist_ok", "device",
                                                 "process_id", "coordinator"):
                    setattr(opt, k, v)
        opt.weights = ckpt
        opt.resume = True
        opt.project = str(Path(ckpt).parent.parent.parent)
        opt.name = Path(ckpt).parent.parent.name
        opt.exist_ok = True
        print(f"Resuming training from {ckpt}")
    if isinstance(opt.img_size, list) and len(opt.img_size) > 1:
        opt.img_size_test = opt.img_size[1]
    print(opt)
    if opt.evolve:
        return evolve(opt, generations=opt.evolve_generations)
    return train(opt)


if __name__ == "__main__":
    main()
