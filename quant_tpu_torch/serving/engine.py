"""Inference engine with continuous batching, and a load balancer over
engines (port of quant_tpu/serving/engine.py).

`InferenceEngine`: requests (single NHWC images) enter a queue; a
scheduler thread drains up to `max_batch` of them (waiting at most
`max_wait_ms` once one is pending), pads the batch to the smallest
fitting bucket, runs the model and resolves each request's Future with
its logits. PyTorch runs eagerly, so buckets only bound the padding;
`warmup` runs each bucket once so first requests do not pay the
kernels' build.

A model sharded over a 'model' group (parallel.sharding.shard_model)
is served by one engine a rank of the group. The group's first rank
(the leader) owns the queue, the batching and the futures: each batch
it runs goes to the group by broadcast, and the other ranks'
engines (followers) run a loop that takes the same batch and runs the
same forward, so the forward's gathers line up. `predict`, `submit` and
`warmup` are the leader's; `start()` starts the follower's loop, and the
leader's `stop()` ends every rank's (a follower's `stop()` waits for
it). The results are the unsharded engine's.

A model banded over a 'space' group (parallel.spatial.band_model) is
served the same way over that group: the leader broadcasts each batch,
every rank takes its band of the images' rows and runs the same forward
(its halo exchanges line up), and the leader returns the logits, which
every rank of the group holds. JAX's engine takes
`input_sharding=spatial_sharding(mesh)` and lets GSPMD band the input;
here the banded model carries its group, and `input_sharding`, where
given, must be `parallel.spatial_sharding` of the model's own mesh and
axis.

`ServingFrontend` dispatches requests over backends with the engine's
surface: in-process engines, or `serving.rpc.RemoteEngineClient`s of
engines in worker processes (`serving.worker`).
"""

import collections
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from quant_tpu_torch import _build
from quant_tpu_torch.device import DeviceLike, resolve_device
from quant_tpu_torch.parallel import spatial

logger = logging.getLogger(__name__)

# Ring-buffer depth for latency percentiles: recent-window stats, O(1) mem.
_LATENCY_WINDOW = 2048
# The header a leader broadcasts to its followers: (op, rows).
_STOP, _RUN = 0, 1


def _latency_stats(windows: list[np.ndarray]) -> dict:
    """{'latency_ms': p50, p99, max, window} over the union of latency
    windows (seconds); {} when they are empty."""
    lats = np.concatenate([np.asarray(w, np.float64).ravel()
                           for w in windows] or [np.empty(0)])
    if not lats.size:
        return {}
    return {'latency_ms': {
        'p50': float(np.percentile(lats, 50) * 1e3),
        'p99': float(np.percentile(lats, 99) * 1e3),
        'max': float(lats.max() * 1e3),
        'window': int(lats.size),
    }}


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, input_shape: Sequence[int],
                 max_batch: int = 64,
                 batch_buckets: Optional[Sequence[int]] = None,
                 max_wait_ms: float = 2.0, device: DeviceLike = 'cuda',
                 input_sharding: Optional[tuple] = None):
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
            input_sharding: JAX's keyword: None, or the placements
                `parallel.spatial_sharding(mesh, axis)` of the banded
                model's own mesh and axis (raises otherwise).

        A tensor-parallel model (its `tp` set) or a banded one (`space`)
        makes this rank's engine its group's leader or a follower
        (module docstring).
        """
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device.type != self.device.type or (
                self.device.index is not None
                and model_device != self.device):
            raise ValueError(f'model lives on {model_device}, engine '
                             f'device is {self.device}')
        self.model = model.eval()
        self._model_device = model_device
        self._space = getattr(model, 'space', None)
        if input_sharding is not None and (
                self._space is None or input_sharding != spatial.
                spatial_sharding(self._space.mesh, self._space.axis)):
            raise ValueError(
                f'input_sharding {input_sharding} is not the placements of '
                "the model's own 'space' axis: band the model with "
                'parallel.band_model and pass spatial_sharding of its mesh')
        # The group whose leader serves: the model's 'model' or 'space'.
        self._group = getattr(model, 'tp', None) or self._space
        self.leader = self._group is None or self._group.index == 0
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
        # One forward (and its broadcast) at a time: a sharded model's
        # collectives must reach the group in one order.
        self._run_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop if self.leader else self._follow, daemon=True)
        self._stats = {'requests': 0, 'batches': 0, 'padded': 0}
        self._latencies: collections.deque = collections.deque(
            maxlen=_LATENCY_WINDOW)

    # -- public API ------------------------------------------------------

    def start(self) -> 'InferenceEngine':
        self._thread.start()
        return self

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run each bucket once (builds the kernels on first use); a
        follower runs the leader's warm-up batches through its loop."""
        if not self.leader:
            return
        for b in (buckets or self.buckets):
            if b not in self.buckets:
                raise ValueError(f'{b} is not a configured bucket '
                                 f'({self.buckets})')
            self._run(np.zeros((b,) + self.input_shape, np.float32))

    def stop(self, timeout: Optional[float] = 10) -> None:
        """End the scheduler; a leader then ends its followers' loops, a
        follower waits (up to `timeout` s) for its leader to."""
        if not self.leader:
            self._thread.join(timeout=timeout)
            return
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        if self._group is not None:
            with self._run_lock:
                self._send(None)

    def _leading(self) -> None:
        if not self.leader:
            raise RuntimeError('a follower engine takes no requests: its '
                               "group's leader (model rank 0) serves")

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one image; returns a Future resolving to its logits."""
        self._leading()
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
        self._leading()
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
    def load(self) -> int:
        """Pending request count (least-loaded dispatch key)."""
        return self._queue.qsize()

    def ping(self) -> bool:
        """Liveness probe: the scheduler thread runs and was not stopped."""
        return self._thread.is_alive() and not self._stop.is_set()

    def latency_window(self) -> np.ndarray:
        """Recent request latencies in seconds, copied under the lock."""
        with self._lock:
            return np.asarray(self._latencies)

    @property
    def stats(self) -> dict:
        """Request, batch and padding counts, the latency percentiles of
        the recent window and, under 'kernel_launches', the launch counts
        of the port's kernels in this process (a worker process serves
        one engine, so they are its engine's)."""
        with self._lock:
            out = dict(self._stats)
            lats = np.asarray(self._latencies)
        out.update(_latency_stats([lats]))
        out['kernel_launches'] = _build.launch_counts()
        return out

    # -- internals -------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _run(self, batch: np.ndarray) -> np.ndarray:
        with self._run_lock, torch.inference_mode():
            x = torch.from_numpy(batch).to(self._model_device)
            if self._group is not None:
                self._send(x)
            return self.model(self._band(x)).to(torch.float32).cpu().numpy()

    def _band(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's band of a batch for a banded model; x otherwise."""
        if self._space is None:
            return x
        return spatial.output_band(self._space, x)

    def _header(self, op: int, rows: int) -> torch.Tensor:
        """(op, rows) from the leader, by broadcast over the group."""
        head = torch.tensor([op, rows], dtype=torch.int64,
                            device=self._model_device)
        dist.broadcast(head, dist.get_global_rank(self._group.group, 0),
                       group=self._group.group)
        return head

    def _send(self, x: Optional[torch.Tensor]) -> None:
        """The leader's batch (None: stop) to its followers."""
        self._header(_STOP if x is None else _RUN,
                     0 if x is None else x.shape[0])
        if x is not None:
            dist.broadcast(x, dist.get_global_rank(self._group.group, 0),
                           group=self._group.group)

    def _receive(self) -> Optional[torch.Tensor]:
        """A follower's next batch from its leader (None: stop)."""
        op, rows = self._header(_STOP, 0).tolist()
        if op == _STOP:
            return None
        x = torch.empty((rows,) + self.input_shape, dtype=torch.float32,
                        device=self._model_device)
        dist.broadcast(x, dist.get_global_rank(self._group.group, 0),
                       group=self._group.group)
        return x

    def _follow(self) -> None:
        """A follower's loop: the leader's batches, each through the
        same forward, until the leader stops."""
        if self._model_device.type == 'cuda':
            torch.cuda.set_device(self._model_device)
        with torch.inference_mode():
            while (x := self._receive()) is not None:
                self.model(self._band(x))

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


class ServingFrontend:
    """Load balancer over serving backends.

    A backend is anything with the engine surface: start(), stop(),
    submit(image) -> Future, load, stats and latency_window(), and
    optionally ping(): an in-process `InferenceEngine` or a
    `serving.rpc.RemoteEngineClient` of an engine in another process.
    Every backend serves the same variables. Rules, as JAX's:

    * `submit` goes to the least-loaded live backend (pending requests),
      ties broken round-robin;
    * only a transport error (`_TRANSPORT_ERRORS`: the backend is
      unreachable) counts toward eviction, and `max_failures` consecutive
      ones evict it; a backend that answered with an error stays live,
      so a malformed request cannot take the fleet down;
    * a daemon thread pings evicted backends every `reprobe_interval`
      seconds and re-admits those that answer; when every backend is
      evicted, `submit` re-probes once before it raises;
    * `stats` reports a backend whose stats fail inline, and aggregates
      request and batch counts and the latency percentiles over the
      union of the backends' windows.
    """

    # The backend is unreachable (a health event), against an error the
    # backend reported while alive (a remote ValueError comes back over
    # the RPC as RuntimeError).
    _TRANSPORT_ERRORS = (ConnectionError, OSError, EOFError, TimeoutError)

    def __init__(self, engines: Sequence, max_failures: int = 2,
                 reprobe_interval: float = 0.5):
        if not engines:
            raise ValueError('ServingFrontend needs at least one engine')
        self.engines = list(engines)
        self._rr = 0
        self._lock = threading.Lock()
        self._alive = [True] * len(self.engines)
        self._fails = [0] * len(self.engines)
        self._max_failures = max_failures
        self._reprobe_interval = reprobe_interval
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None

    def start(self) -> 'ServingFrontend':
        for e in self.engines:
            e.start()
        self._health_thread = threading.Thread(target=self._health_loop,
                                               daemon=True)
        self._health_thread.start()
        return self

    def stop(self) -> None:
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
        for e in self.engines:
            e.stop()

    # -- health ----------------------------------------------------------

    @staticmethod
    def _ping(engine: object) -> bool:
        probe = getattr(engine, 'ping', None)
        if probe is None:
            return True  # no probe surface: assume live
        try:
            return bool(probe())
        except Exception:  # noqa: BLE001 — liveness is boolean
            return False

    def _health_loop(self) -> None:
        while not self._health_stop.wait(self._reprobe_interval):
            self._reprobe_dead()

    def _reprobe_dead(self) -> None:
        with self._lock:
            dead = [i for i, a in enumerate(self._alive) if not a]
        for i in dead:
            if self._ping(self.engines[i]):
                with self._lock:
                    self._alive[i] = True
                    self._fails[i] = 0
                logger.info('serving frontend: backend %d rejoined', i)

    def _record_outcome(self, idx: int, ok: bool) -> None:
        with self._lock:
            if ok:
                self._fails[idx] = 0
                return
            self._fails[idx] += 1
            if self._fails[idx] >= self._max_failures and self._alive[idx]:
                self._alive[idx] = False
                logger.warning('serving frontend: backend %d evicted after '
                               '%d consecutive failures', idx,
                               self._fails[idx])

    def _record_from_future(self, idx: int, fut: Future) -> None:
        exc = fut.exception()
        if exc is None:
            self._record_outcome(idx, ok=True)
        elif isinstance(exc, self._TRANSPORT_ERRORS):
            self._record_outcome(idx, ok=False)
        # else the backend answered with an error: it is alive, and the
        # caller sees the error through the future.

    @property
    def alive(self) -> list[bool]:
        with self._lock:
            return list(self._alive)

    # -- dispatch --------------------------------------------------------

    def _pick(self) -> int:
        with self._lock:
            candidates = [i for i, a in enumerate(self._alive) if a]
        if not candidates:
            # Every backend evicted: a restarted worker may be back.
            self._reprobe_dead()
            with self._lock:
                candidates = [i for i, a in enumerate(self._alive) if a]
            if not candidates:
                raise RuntimeError('serving frontend: no live backends')
        with self._lock:
            loads = {i: self.engines[i].load for i in candidates}
            lo = min(loads.values())
            n = len(self.engines)
            for off in range(n):
                i = (self._rr + off) % n
                if loads.get(i) == lo:
                    self._rr = (i + 1) % n
                    return i
        raise AssertionError('unreachable: a least-loaded candidate exists')

    def submit(self, image: np.ndarray) -> Future:
        last_exc: Optional[Exception] = None
        for _ in range(len(self.engines)):
            idx = self._pick()
            try:
                fut = self.engines[idx].submit(image)
            except self._TRANSPORT_ERRORS as e:
                self._record_outcome(idx, ok=False)
                last_exc = e
                continue
            fut.add_done_callback(
                lambda f, i=idx: self._record_from_future(i, f))
            return fut
        raise RuntimeError(f'serving frontend: submit failed on every '
                           f'backend (last: {last_exc})')

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Scatter rows over the backends through submit, gather in
        order."""
        futs = [self.submit(img) for img in images]
        return np.stack([f.result(timeout=60) for f in futs])

    @property
    def stats(self) -> dict:
        per, windows = [], []
        for e in self.engines:
            # A dead backend must not take the monitoring surface down.
            try:
                per.append(e.stats)
            except Exception as err:  # noqa: BLE001 — report, don't die
                per.append({'requests': 0, 'batches': 0,
                            'error': f'{type(err).__name__}: {err}'})
            try:
                windows.append(e.latency_window())
            except Exception:  # noqa: BLE001 — reported through stats
                pass
        out = {'engines': per, 'alive': self.alive,
               'requests': sum(s['requests'] for s in per),
               'batches': sum(s['batches'] for s in per)}
        out.update(_latency_stats(windows))
        return out
