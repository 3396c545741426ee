"""Cross-process serving: engines behind a minimal socket RPC (port of
quant_tpu/serving/rpc.py, sockets, pickle and numpy only).

`InferenceEngine` batches inside one process; this module puts engines
behind a process boundary:

* `EngineServer` — wraps an engine in a threaded TCP server speaking a
  length-prefixed pickle protocol (submit / stats / latencies / ping /
  shutdown). Concurrent client requests become concurrent queue entries,
  so the engine's continuous batching works exactly as in-process.
* `RemoteEngineClient` — submit(image) -> Future over a connection pool;
  tracks in-flight count (`load`) for least-loaded dispatch.
* `ServingFrontend` (serving/engine.py) accepts clients and engines
  interchangeably — anything with submit()/load/stats.

Trust model: the payload is pickle over TCP — deserialization executes
code, so the port must only ever be reachable by the deployment's own
processes. Two gates enforce that:

* Binding a non-loopback interface REQUIRES a shared `secret`
  (EngineServer raises otherwise); loopback binds may omit it.
* When a secret is set (either side), every connection starts with a
  challenge-response handshake — server sends a random nonce, client
  answers HMAC-SHA256(secret, nonce) — verified with a constant-time
  compare BEFORE the first pickle byte is parsed. Unauthenticated
  peers are disconnected without ever reaching pickle.loads.

Wire format: 8-byte big-endian length + payload both ways (raw bytes
for the handshake, pickle after it), JAX's. Only numpy arrays and plain
Python values cross it, never tensors, so a JAX client and a port server
(or the other way round) interchange.
"""

import hmac
import logging
import os
import pickle
import socket
import socketserver
import struct
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_HDR = struct.Struct('>Q')
_NONCE_BYTES = 32
# Handshake frames are small; reject absurd lengths before allocating.
_MAX_HANDSHAKE = 1024


def _is_loopback(host: str) -> bool:
    return host in ('127.0.0.1', '::1', 'localhost')


def _send_raw(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_raw(sock: socket.socket, max_len: int = _MAX_HANDSHAKE) -> bytes:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if n > max_len:
        raise ConnectionError(f'handshake frame too large ({n} bytes)')
    return _recv_exact(sock, n)


def _send_msg(sock: socket.socket, obj: object) -> None:
    payload = pickle.dumps(obj, protocol=4)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError('peer closed the connection')
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> object:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return pickle.loads(_recv_exact(sock, n))


class EngineServer:
    """Serve one InferenceEngine over TCP; one thread per connection.

    Each connection handles a stream of request dicts:
      {'op': 'submit', 'image': ndarray}  -> {'ok': True, 'logits': nd}
      {'op': 'stats'}                     -> {'ok': True, 'stats': dict}
      {'op': 'latencies'}                 -> {'ok': True,
                                              'latencies': ndarray}
      {'op': 'ping'}                      -> {'ok': True}
      {'op': 'shutdown'}                  -> {'ok': True} then stops
    Errors come back as {'ok': False, 'error': str}.
    """

    def __init__(self, engine: object, host: str = '127.0.0.1',
                 port: int = 0,
                 secret: Optional[bytes] = None) -> None:
        if secret is None and not _is_loopback(host):
            raise ValueError(
                f'EngineServer on non-loopback host {host!r} requires a '
                'shared secret: the payload is pickle (code-executing on '
                'deserialize). Pass secret=... to both server and '
                'clients, or bind loopback.')
        self.engine = engine
        self._secret = secret
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:  # one connection, many requests
                sock = self.request
                if outer._secret is not None:
                    try:
                        nonce = os.urandom(_NONCE_BYTES)
                        _send_raw(sock, nonce)
                        answer = _recv_raw(sock)
                        want = hmac.new(outer._secret, nonce,
                                        'sha256').digest()
                        if not hmac.compare_digest(answer, want):
                            logger.warning(
                                'rpc: bad auth from %s — closing',
                                self.client_address)
                            return
                    except (ConnectionError, EOFError, OSError,
                            struct.error):
                        return
                while True:
                    try:
                        req = _recv_msg(sock)
                    except (ConnectionError, EOFError, OSError):
                        return
                    if not isinstance(req, dict):
                        # Protocol error: reply once, drop the
                        # connection (never index a non-dict payload).
                        try:
                            _send_msg(sock, {
                                'ok': False,
                                'error': 'protocol error: request must '
                                         'be a dict'})
                        except (ConnectionError, OSError):
                            pass
                        return
                    try:
                        _send_msg(sock, outer._dispatch(req))
                    except (ConnectionError, OSError):
                        return
                    if req.get('op') == 'shutdown':
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._shutdown_evt = threading.Event()

    def _dispatch(self, req: dict) -> dict:
        try:
            op = req.get('op')
            if op == 'submit':
                fut = self.engine.submit(np.asarray(req['image']))
                return {'ok': True,
                        'logits': np.asarray(fut.result(timeout=600))}
            if op == 'stats':
                return {'ok': True, 'stats': self.engine.stats}
            if op == 'latencies':
                # latency_window() copies under the engine lock; the
                # raw deque mutates concurrently in the scheduler
                # thread.
                win = getattr(self.engine, 'latency_window', None)
                lats = win() if callable(win) else np.asarray(
                    getattr(self.engine, '_latencies', []))
                return {'ok': True, 'latencies': np.asarray(lats)}
            if op == 'ping':
                return {'ok': True}
            if op == 'shutdown':
                self._shutdown_evt.set()
                return {'ok': True}
            return {'ok': False, 'error': f'unknown op {op!r}'}
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            return {'ok': False, 'error': f'{type(e).__name__}: {e}'}

    def start(self) -> 'EngineServer':
        self.engine.start()
        self._thread.start()
        return self

    def wait_for_shutdown(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown_evt.wait(timeout)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self.engine.stop()


class RemoteEngineClient:
    """submit(image) -> Future against a remote EngineServer.

    A pool of persistent connections; each submit borrows one for the
    round trip (server-side the request parks in the engine queue, so
    concurrent borrows = concurrent batchable requests). `load` counts
    in-flight requests for the frontend's least-loaded dispatch.
    """

    def __init__(self, host: str, port: int, pool_size: int = 16,
                 connect_timeout: float = 30.0,
                 secret: Optional[bytes] = None):
        self.host, self.port = host, port
        self._pool: list[socket.socket] = []
        self._pool_lock = threading.Lock()
        self._pool_size = pool_size
        self._executor = ThreadPoolExecutor(max_workers=pool_size)
        self._inflight = 0
        self._timeout = connect_timeout
        self._secret = secret
        # Fail fast on a dead backend.
        self._call({'op': 'ping'})

    # -- connection pool --
    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self._timeout)
        # Handshake under the (short) connect timeout: a secret-less
        # server would never send a nonce — fail fast, not in 600 s.
        if self._secret is not None:
            nonce = _recv_raw(sock)
            _send_raw(sock, hmac.new(self._secret, nonce,
                                     'sha256').digest())
        sock.settimeout(600)
        return sock

    def _borrow(self) -> tuple[socket.socket, bool]:
        """-> (socket, came_from_pool)."""
        with self._pool_lock:
            if self._pool:
                return self._pool.pop(), True
        return self._connect(), False

    def _give_back(self, sock: socket.socket) -> None:
        with self._pool_lock:
            if len(self._pool) < self._pool_size:
                self._pool.append(sock)
                return
        sock.close()

    def _drop_pool(self) -> None:
        with self._pool_lock:
            stale, self._pool = self._pool, []
        for s in stale:
            s.close()

    def _roundtrip(self, sock: socket.socket, req: dict) -> dict:
        _send_msg(sock, req)
        return _recv_msg(sock)

    def _call(self, req: dict) -> dict:
        sock, pooled = self._borrow()
        try:
            resp = self._roundtrip(sock, req)
        except Exception:
            sock.close()
            if not pooled:
                raise
            # A pooled connection can be stale (server restarted since
            # it was parked, e.g. after a crash + rejoin): retry ONCE on
            # a fresh connection before declaring the backend dead.
            sock = self._connect()
            try:
                resp = self._roundtrip(sock, req)
            except Exception:
                sock.close()
                raise
        self._give_back(sock)
        if not resp.get('ok'):
            raise RuntimeError(
                f'engine {self.host}:{self.port}: {resp.get("error")}')
        return resp

    # -- engine-compatible surface --
    def start(self) -> 'RemoteEngineClient':
        return self

    def stop(self) -> None:
        self._executor.shutdown(wait=False)
        with self._pool_lock:
            for s in self._pool:
                s.close()
            self._pool.clear()

    @property
    def load(self) -> int:
        return self._inflight

    def ping(self) -> bool:
        """Round-trip liveness probe; drops stale pooled connections on
        failure so a later rejoin starts from a clean pool."""
        try:
            self._call({'op': 'ping'})
            return True
        except Exception:  # noqa: BLE001 — liveness is boolean
            self._drop_pool()
            return False

    def submit(self, image: np.ndarray) -> Future:
        with self._pool_lock:
            self._inflight += 1

        def call():
            try:
                return self._call({'op': 'submit',
                                   'image': np.asarray(image)})['logits']
            finally:
                with self._pool_lock:
                    self._inflight -= 1

        return self._executor.submit(call)

    @property
    def stats(self) -> dict:
        return self._call({'op': 'stats'})['stats']

    def latency_window(self) -> np.ndarray:
        return np.asarray(self._call({'op': 'latencies'})['latencies'])

    def shutdown_server(self) -> None:
        try:
            self._call({'op': 'shutdown'})
        except Exception:  # server may die before replying fully
            pass
