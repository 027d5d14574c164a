"""Profiling (counterpart of ``multiyolov5_tpu/utils/profiling.py``).

The reference's tracing tools (SURVEY.md §5) on PyTorch: ``model_info``'s
parameter and GFLOPs summary (reference utils/torch_utils.py:205-226), a
FLOP counter that computes nothing, per-row timing (reference
``Model.forward(profile=True)``, models/yolo.py:301-314), the standalone op
profiler (utils/torch_utils.py:97-133) and a ``torch.profiler`` trace.

On the card, times come from CUDA events; on the CPU from the host clock.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models.config import ModelSpec
from ..models.model import Model
from .checkpoint import _STATE_SUFFIXES


def _trainable(sd: Dict[str, object]) -> Dict[str, object]:
    """The entries the JAX package keeps in ``params``: no BN running
    statistics, no anchor buffers, no ``num_batches_tracked``."""
    return {k: v for k, v in sd.items()
            if not k.endswith(_STATE_SUFFIXES + (".num_batches_tracked",))}


def model_info(spec: ModelSpec, sd: Dict[str, object], img_size: int = 640,
               verbose: bool = False) -> dict:
    """Layers, parameters and GFLOPs at ``img_size`` x ``img_size``
    (reference ``model_info``).  ``sd`` is a ``state_dict`` (folded or not)
    or the JAX package's params; its trainable entries are counted."""
    params = _trainable(sd)
    n_p = sum(math.prod(v.shape) for v in params.values())
    if verbose:
        print(f"{'layer':>5} {'name':>45} {'shape':>20} {'params':>12}")
        for i, (k, v) in enumerate(params.items()):
            print(f"{i:5} {k:>45} {str(tuple(v.shape)):>20} {math.prod(v.shape):12}")
    flops = estimate_gflops(spec, sd, img_size)
    n_layers = len(spec.rows)
    print(f"Model Summary: {n_layers} layers, {n_p} parameters, "
          f"{flops:.1f} GFLOPS @ {img_size}x{img_size}")
    return {"layers": n_layers, "parameters": n_p, "gflops": flops}


def estimate_gflops(spec: ModelSpec, sd: Optional[Dict[str, object]] = None,
                    img_size=640) -> float:
    """GFLOPs of one forward at ``img_size`` (int or (H, W)): 2 x the MACs
    of every convolution at its actual output size in the graph, as
    ``FlopCounterMode`` counts them.  The plain network (``kernels=False``)
    runs on the ``meta`` device, so nothing is computed.

    The Focus conv counts: the JAX counter misses it (its Focus path at
    multiyolov5_tpu/models/blocks.py:415 never calls ``_add_macs``), so it
    reads 0.906 GF low on pspv5s at 512x1024.  Det-only yolov5s at 640
    reads 16.958 (the reference's thop 17.0).  ``sd`` is accepted for the
    JAX signature and not read: folded and unfolded networks count the same
    (BN is not counted), so the folded one is always built."""
    hw = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
    with torch.device("meta"):
        model = Model(spec, fused=True, kernels=False)
    model.to("meta").eval()
    with FlopCounterMode(display=False) as counter:
        model(torch.empty(1, spec.ch_in, *hw, device="meta"))
    return counter.get_total_flops() / 1e9


def _mark(cuda: bool):
    """A point in time: a recorded CUDA event on the card, else the host clock."""
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(t0, t1) -> float:
    """Milliseconds between two :func:`_mark` points (events synchronised)."""
    return (t1 - t0) * 1e3 if isinstance(t0, float) else t0.elapsed_time(t1)


def profile_op(fn, *args, n: int = 100, name: str = "op") -> float:
    """Seconds per call of ``fn(*args)`` (reference utils/torch_utils.profile):
    ``n`` calls back to back, after 3 warm-up calls, between two CUDA events
    when an argument lies on the card, else on the host clock."""
    cuda = any(torch.is_tensor(a) and a.is_cuda for a in args)
    for _ in range(3):
        fn(*args)
    if cuda:
        torch.cuda.synchronize()
    t0 = _mark(cuda)
    for _ in range(n):
        fn(*args)
    t1 = _mark(cuda)
    if cuda:
        torch.cuda.synchronize()
    dt = _ms(t0, t1) / n / 1e3
    print(f"{name}: {dt * 1e3:.3f} ms/iter")
    return dt


def profile_layers(model: Model, img_hw=(256, 256), batch: int = 1,
                   repeats: int = 10) -> List[Tuple[int, str, float, float]]:
    """Per-row time of ``model``'s eval forward from row 0 on a zero frame.

    Each row's module is timed directly: a CUDA event (on the CPU the host
    clock) before and after it, over ``repeats`` forwards after one warm-up.
    The frame is NHWC in memory, as the engine's, in the parameters' dtype.
    Prints and returns ``(row, module, cumulative ms, row ms)`` a spec row."""
    p = next(model.parameters())
    x = torch.zeros(batch, *img_hw, model.spec.ch_in, dtype=p.dtype,
                    device=p.device).permute(0, 3, 1, 2)
    marks: Dict[int, list] = {row.i: [] for row in model.spec.rows}
    hooks = []
    for row in model.spec.rows:
        mod = model.model[row.i]
        hooks.append(mod.register_forward_pre_hook(
            lambda _m, _a, i=row.i: marks[i].append([_mark(p.is_cuda)])))
        hooks.append(mod.register_forward_hook(
            lambda _m, _a, _o, i=row.i: marks[i][-1].append(_mark(p.is_cuda))))
    try:
        with torch.inference_mode():
            model(x)
            for m in marks.values():
                m.clear()
            for _ in range(repeats):
                model(x)
        if p.is_cuda:
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    rows, cum = [], 0.0
    print(f"{'idx':>4} {'module':>16} {'cum ms':>10} {'delta ms':>10}")
    for row in model.spec.rows:
        ms = sum(_ms(a, b) for a, b in marks[row.i]) / repeats
        cum += ms
        rows.append((row.i, row.module, cum, ms))
        print(f"{row.i:>4} {row.module:>16} {cum:>10.3f} {ms:>10.3f}")
    return rows


@contextlib.contextmanager
def trace(log_dir: str = "runs/trace"):
    """A ``torch.profiler`` context (CPU activities, and CUDA's where a card
    is present) that writes its Chrome trace to
    ``log_dir/profile.pt.trace.json``; yields that path.
    ``tools/trace_report.py`` reads it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "profile.pt.trace.json")
    with profile(activities=acts) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    print(f"profile trace written to {path}")
