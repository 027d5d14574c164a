"""Dynamic-batching inference server (counterpart of
``multiyolov5_tpu/serving.py``).

Requests enqueue BGR frames; a dispatcher thread coalesces them into
batches (up to ``max_batch``, waiting at most ``max_wait_ms``), groups them
by frame geometry, letterboxes each frame on the engine's device (one copy
of the frame to the card), pads the batch to a bucket size by repeating its
last frame, and runs one batched :class:`Engine` call per bucket.  At
batch > 1 the engine's forward runs the backbone's narrow C3 through kernel
K7.

    server = InferenceServer(engine=Engine(cfg="yolov5s_city_seg"), img_size=1024)
    fut = server.submit(frame_bgr)          # from any thread
    boxes, class_map = fut.result()       # class_map None for a detection-only model
    server.stats() / server.close()
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from .data.letterbox import check_img_size, letterbox
from .engine import Engine


class InferenceServer:
    """Args as the JAX package's server, plus ``device`` for the engine it
    builds when none is given (the card by default)."""

    def __init__(self, weights: Any = None, cfg: Any = None,
                 img_size: int = 1024, max_batch: int = 8,
                 max_wait_ms: float = 2.0, conf: float = 0.25,
                 iou: float = 0.45, half: bool = True,
                 engine: Optional[Engine] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.engine = engine or Engine(weights, cfg=cfg, half=half, device=device)
        self.img_size = check_img_size(img_size, self.engine.stride)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.conf = conf
        self.iou = iou
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._closed = threading.Event()
        self._n_frames = 0
        self._n_batches = 0
        self._t_device = 0.0
        # batch-size buckets: a collected batch is padded up to the nearest one
        self._buckets = sorted({1, max_batch} | {
            b for b in (2, 4, 8, 16, 32, 64) if b < max_batch})
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API -----------------------------------------------------------

    def submit(self, frame_bgr: np.ndarray) -> Future:
        """Enqueue one BGR uint8 frame; resolves to (boxes (n,6), class_map)."""
        if self._closed.is_set():
            raise RuntimeError("server closed")
        fut: Future = Future()
        self._q.put((frame_bgr, fut))
        if self._closed.is_set() and fut.cancel():  # raced with close()
            raise RuntimeError("server closed")
        return fut

    def infer(self, frame_bgr: np.ndarray, timeout: float = 30.0):
        return self.submit(frame_bgr).result(timeout)

    def stats(self) -> dict:
        return {"frames": self._n_frames, "batches": self._n_batches,
                "mean_batch": self._n_frames / max(self._n_batches, 1),
                "device_s": round(self._t_device, 3)}

    def close(self) -> None:
        self._closed.set()
        self._q.put(None)
        self._thread.join(timeout=5)
        # cancel anything still queued so waiting clients don't hang forever
        while True:
            try:
                item = self._q.get_nowait()
            except queue_mod.Empty:
                break
            if item is not None and not item[1].done():
                item[1].cancel()

    def warmup(self, orig_hw: Tuple[int, int]) -> None:
        """Run every batch bucket once for a frame geometry."""
        frame = np.zeros((*orig_hw, 3), np.uint8)
        for b in self._buckets:
            futs = [self.submit(frame) for _ in range(b)]
            for f in futs:
                f.result(timeout=600)

    # -- dispatcher -----------------------------------------------------------

    def _collect(self) -> Optional[List[Tuple[np.ndarray, Future]]]:
        item = self._q.get()
        if item is None:
            return None
        batch = [item]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue_mod.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post sentinel for shutdown
                break
            batch.append(nxt)
        return batch

    def letterbox_batch(self, frames: List[np.ndarray]) -> torch.Tensor:
        """BGR frames of one geometry -> (bucket, S, S, 3) RGB uint8 on the
        engine's device, padded by repeating the last frame."""
        dev = self.engine.device
        x = torch.stack([letterbox(f, self.img_size, auto=False, stride=self.engine.stride,
                                   device=dev)[0].flip(-1) for f in frames])
        b = next(s for s in self._buckets if s >= len(frames))
        if b > len(frames):
            x = torch.cat([x, x[-1:].expand(b - len(frames), *x.shape[1:])])
        return x.contiguous()

    def _loop(self) -> None:
        while not self._closed.is_set():
            batch = self._collect()
            if batch is None:
                return
            by_shape = {}
            for frame, fut in batch:
                by_shape.setdefault(tuple(frame.shape[:2]), []).append((frame, fut))
            for orig_hw, items in by_shape.items():
                try:
                    x = self.letterbox_batch([f for f, _ in items])
                    t0 = time.perf_counter()
                    dets, masks = self.engine(x, orig_hw, conf=self.conf, iou=self.iou)
                    self._t_device += time.perf_counter() - t0
                    self._n_batches += 1
                    self._n_frames += len(items)
                    for (_, fut), d, m in zip(items, dets, masks):
                        fut.set_result((d, m))
                except Exception as e:
                    for _, fut in items:
                        if not fut.done():
                            fut.set_exception(e)
