"""Inference engine with continuous batching (port of
quant_tpu/serving/engine.py:38-214).

Requests (single NHWC images) enter a queue; a scheduler thread drains
up to `max_batch` of them (waiting at most `max_wait_ms` once one is
pending), pads the batch to the smallest fitting bucket, runs the model
and resolves each request's Future with its logits. PyTorch runs
eagerly, so buckets only bound the padding; `warmup` runs each bucket
once so first requests do not pay the kernels' build. ServingFrontend,
rpc and the worker are queued for Slice D.
"""

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from quant_tpu_torch.device import DeviceLike, resolve_device

# Ring-buffer depth for latency percentiles: recent-window stats, O(1) mem.
_LATENCY_WINDOW = 2048


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, input_shape: Sequence[int],
                 max_batch: int = 64,
                 batch_buckets: Optional[Sequence[int]] = None,
                 max_wait_ms: float = 2.0, device: DeviceLike = 'cuda'):
        """
        Args:
            model: an eval-ready (packed, folded) model on `device`,
                called as model(x) on an NHWC float32 batch.
            input_shape: per-example shape, e.g. (224, 224, 3).
            max_batch: largest batch run at once.
            batch_buckets: ascending batch sizes (default powers of two
                up to max_batch).
            max_wait_ms: batching window after the first pending request.
            device: where the model runs ('cuda' by default; raises if
                CUDA is missing).
        """
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device.type != self.device.type or (
                self.device.index is not None
                and model_device != self.device):
            raise ValueError(f'model lives on {model_device}, engine '
                             f'device is {self.device}')
        self.model = model
        self.input_shape = tuple(input_shape)
        self.max_batch = max_batch
        self.buckets = sorted(set(
            (batch_buckets or [b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256)
                               if b <= max_batch])) | {max_batch})
        self.max_wait = max_wait_ms / 1000.0
        self._queue: queue.Queue = queue.Queue()
        # Guards the stats counters and the latency window.
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._stats = {'requests': 0, 'batches': 0, 'padded': 0}
        self._latencies: collections.deque = collections.deque(
            maxlen=_LATENCY_WINDOW)

    # -- public API ------------------------------------------------------

    def start(self) -> 'InferenceEngine':
        self._thread.start()
        return self

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run each bucket once (builds the kernels on first use)."""
        for b in (buckets or self.buckets):
            if b not in self.buckets:
                raise ValueError(f'{b} is not a configured bucket '
                                 f'({self.buckets})')
            self._run(np.zeros((b,) + self.input_shape, np.float32))

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10)

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one image; returns a Future resolving to its logits."""
        if tuple(image.shape) != self.input_shape:
            raise ValueError(
                f'expected shape {self.input_shape}, got {image.shape}')
        fut: Future = Future()
        self._queue.put((np.asarray(image, np.float32), fut,
                         time.perf_counter()))
        with self._lock:
            self._stats['requests'] += 1
        return fut

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Synchronous batch prediction (bypasses the queue); inputs
        larger than max_batch are chunked."""
        outs = []
        for start in range(0, images.shape[0], self.max_batch):
            chunk = images[start:start + self.max_batch]
            n = chunk.shape[0]
            padded = np.zeros((self._bucket_for(n),) + self.input_shape,
                              np.float32)
            padded[:n] = chunk
            outs.append(self._run(padded)[:n])
        return np.concatenate(outs) if outs else np.empty((0,))

    @property
    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            lats = np.asarray(self._latencies)
        if lats.size:
            out['latency_ms'] = {
                'p50': float(np.percentile(lats, 50) * 1e3),
                'p99': float(np.percentile(lats, 99) * 1e3),
                'max': float(lats.max() * 1e3),
                'window': int(lats.size),
            }
        return out

    # -- internals -------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _run(self, batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(batch).to(self.device)
            return self.model(x).to(torch.float32).cpu().numpy()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(items) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break

            n = len(items)
            bucket = self._bucket_for(n)
            batch = np.zeros((bucket,) + self.input_shape, np.float32)
            for i, (img, _, _) in enumerate(items):
                batch[i] = img
            try:
                out = self._run(batch)
            except Exception as e:  # noqa: BLE001 — resolve futures with it
                for _, fut, _ in items:
                    fut.set_exception(e)
                continue
            done = time.perf_counter()
            for i, (_, fut, _) in enumerate(items):
                fut.set_result(out[i].copy())
            with self._lock:
                self._stats['batches'] += 1
                self._stats['padded'] += bucket - n
                self._latencies.extend(done - t0 for _, _, t0 in items)
