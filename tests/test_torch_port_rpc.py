"""The port's serving stack across processes: ServingFrontend's rules,
the socket RPC (handshake, protocol errors, wire compatibility with the
JAX package's client and server) and engine worker processes on the CPU.

Backends in the rule tests are stubs with the engine's surface. The
worker test spawns two real worker processes of the 'lenet_random' spec
on the CPU; both build the model from one seed, so an in-process engine
of the same spec gives every request's expected logits whichever worker
served it.
"""

import os
import pathlib
import socket
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from quant_tpu.serving import rpc as jrpc
from quant_tpu_torch.serving import rpc, worker
from quant_tpu_torch.serving.engine import InferenceEngine, ServingFrontend
from quant_tpu_torch.serving.rpc import EngineServer, RemoteEngineClient

LENET_SPEC = {'model': 'lenet_random', 'seed': 5, 'max_batch': 8,
              'max_wait_ms': 2.0, 'device': 'cpu'}
# One forward of the same CPU model on the same image; a request's
# arithmetic does not depend on the rest of its batch, so only the
# float32 rounding of the CPU's conv and matmul kernels at another batch
# size remains.
SERVE_TOL = dict(rtol=1e-6, atol=1e-6)


class Stub:
    """The engine surface, answering each submit with the image's sum."""

    def __init__(self, load=0, lats=(0.001,), error=None):
        self.load, self.submitted, self.error = load, 0, error
        self.lats = np.asarray(lats)
        self.pings = True

    @property
    def stats(self):
        return {'requests': 3, 'batches': 1}

    def start(self):
        return self

    def stop(self):
        pass

    def ping(self):
        return self.pings

    def submit(self, image):
        self.submitted += 1
        f = Future()
        if self.error is not None:
            f.set_exception(self.error)
        else:
            f.set_result(np.asarray(image).sum(keepdims=True))
        return f

    def latency_window(self):
        return self.lats


def test_frontend_least_loaded_with_round_robin_ties():
    busy, a, b = Stub(load=5), Stub(), Stub()
    frontend = ServingFrontend([busy, a, b])
    for _ in range(4):
        frontend.submit(np.zeros(1))
    assert (busy.submitted, a.submitted, b.submitted) == (0, 2, 2)
    a.load = 1  # b alone is least loaded now
    for _ in range(3):
        frontend.submit(np.zeros(1))
    assert b.submitted == 5
    with pytest.raises(ValueError, match='at least one'):
        ServingFrontend([])


def test_frontend_evicts_on_transport_errors_only():
    """A backend that answers with an error stays live; one that is
    unreachable (a ConnectionError in its future, or raised by submit)
    is evicted after max_failures consecutive failures; a success in
    between resets the count."""
    answered = Stub(error=RuntimeError('engine: bad shape'))
    frontend = ServingFrontend([answered, Stub()], max_failures=2)
    results = [frontend.submit(np.ones(2)) for _ in range(6)]
    assert sum(r.exception() is not None for r in results) == 3
    assert frontend.alive == [True, True]

    gone = Stub(error=ConnectionRefusedError('worker gone'))
    frontend = ServingFrontend([gone, Stub()], max_failures=2)
    frontend.submit(np.ones(2))  # gone, failure 1
    frontend.submit(np.ones(2))
    assert frontend.alive == [True, True]
    gone.error = None
    frontend.submit(np.ones(2))  # gone answers: the count resets
    gone.error = ConnectionRefusedError('worker gone')
    for _ in range(4):
        frontend.submit(np.ones(2))
    assert frontend.alive == [False, True]
    for _ in range(3):
        assert frontend.submit(np.ones(2)).result() == 2.0
    assert gone.submitted == 4

    class Refusing(Stub):
        def submit(self, image):
            raise ConnectionResetError('reset')

    frontend = ServingFrontend([Refusing(), Stub()], max_failures=1)
    assert frontend.submit(np.ones(3)).result() == 3.0  # retried on 1
    assert frontend.alive == [False, True]


def test_frontend_readmits_a_backend_that_answers_pings():
    gone = Stub(error=ConnectionRefusedError('worker gone'))
    gone.pings = False
    frontend = ServingFrontend([gone], max_failures=1,
                               reprobe_interval=0.05).start()
    try:
        frontend.submit(np.ones(1))
        assert frontend.alive == [False]
        # Every backend evicted: submit re-probes once, then raises.
        with pytest.raises(RuntimeError, match='no live backends'):
            frontend.submit(np.ones(1))
        gone.error, gone.pings = None, True
        deadline = time.monotonic() + 10
        while frontend.alive != [True]:
            assert time.monotonic() < deadline, 'never re-admitted'
            time.sleep(0.02)
        assert frontend.submit(np.ones(1)).result() == 1.0
    finally:
        frontend.stop()
    assert not frontend._health_thread.is_alive()


def test_frontend_stats_survive_a_dead_backend_and_aggregate_windows():
    class Dead(Stub):
        @property
        def stats(self):
            raise ConnectionRefusedError('engine gone')

        def latency_window(self):
            raise ConnectionRefusedError('engine gone')

    a, b = Stub(lats=[0.001, 0.003]), Stub(lats=[0.002])
    stats = ServingFrontend([Dead(), a, b]).stats
    assert stats['requests'] == 6 and stats['batches'] == 2
    assert 'ConnectionRefusedError' in stats['engines'][0]['error']
    assert stats['latency_ms']['window'] == 3
    assert stats['latency_ms']['p50'] == pytest.approx(2.0)
    assert stats['latency_ms']['max'] == pytest.approx(3.0)


def _linear_engine(max_batch=4):
    """An InferenceEngine of a seeded Linear layer on the CPU (inputs (6,),
    logits (3,))."""
    model = torch.nn.Linear(6, 3)
    with torch.no_grad():
        model.weight.copy_(torch.arange(18.0).reshape(3, 6) / 10)
        model.bias.copy_(torch.tensor([0.5, -1.0, 2.0]))
    return InferenceEngine(model, (6,), max_batch=max_batch,
                           max_wait_ms=5.0, device='cpu')


def test_engine_load_ping_and_latency_window():
    engine = _linear_engine()
    assert not engine.ping()  # scheduler not started
    images = np.random.default_rng(0).standard_normal((5, 6)).astype(
        np.float32)
    futs = [engine.submit(img) for img in images]
    assert engine.load == 5 and engine.latency_window().size == 0
    engine.start()
    try:
        assert engine.ping()
        got = np.stack([f.result(timeout=30) for f in futs])
    finally:
        engine.stop()
    assert not engine.ping() and engine.load == 0
    np.testing.assert_allclose(got, engine.predict(images), **SERVE_TOL)
    window = engine.latency_window()
    assert window.shape == (5,) and (window > 0).all()
    window[:] = -1  # a copy: the engine's window is untouched
    assert (engine.latency_window() > 0).all()


def test_rpc_secret_handshake():
    """HMAC challenge-response: the right secret round-trips; a wrong or
    missing one is disconnected before any pickle byte is read."""
    server = EngineServer(Stub(), secret=b'\x00s3cret\n').start()
    port = server.address[1]
    try:
        good = RemoteEngineClient('127.0.0.1', port, secret=b'\x00s3cret\n')
        assert good.submit(np.ones(3, np.float32)).result(timeout=30) == 3.0
        good.stop()
        # The file's bytes verbatim: a stripped newline is another key,
        # and the server hangs up.
        with pytest.raises(ConnectionError):
            RemoteEngineClient('127.0.0.1', port, secret=b'\x00s3cret',
                               connect_timeout=5.0)
        # No secret: the server reads the client's first frame as the
        # answer and hangs up; the client, reading the nonce as its
        # reply, fails whichever way those random bytes unpickle.
        with pytest.raises(Exception):  # noqa: B017
            RemoteEngineClient('127.0.0.1', port, connect_timeout=5.0)
    finally:
        server.stop()


def test_rpc_non_loopback_bind_requires_secret():
    with pytest.raises(ValueError, match='secret'):
        EngineServer(Stub(), host='0.0.0.0')
    server = EngineServer(Stub(), host='0.0.0.0', secret=b's')
    server._server.server_close()


def test_rpc_non_dict_payload_gets_protocol_error():
    server = EngineServer(Stub()).start()
    try:
        sock = socket.create_connection(('127.0.0.1', server.address[1]),
                                        timeout=10)
        sock.settimeout(10)
        rpc._send_msg(sock, ['not', 'a', 'dict'])
        resp = rpc._recv_msg(sock)
        assert resp['ok'] is False and 'protocol error' in resp['error']
        assert sock.recv(1) == b''  # the server hung up after replying
        sock.close()
    finally:
        server.stop()


def test_jax_client_reads_a_port_server():
    """The JAX package's RemoteEngineClient against the port's EngineServer
    over a port InferenceEngine: logits, stats, latencies and ping cross
    as numpy arrays and Python values."""
    engine = _linear_engine()
    server = EngineServer(engine, secret=b'k').start()
    images = np.random.default_rng(1).standard_normal((6, 6)).astype(
        np.float32)
    try:
        client = jrpc.RemoteEngineClient('127.0.0.1', server.address[1],
                                         secret=b'k')
        got = np.stack([client.submit(img).result(timeout=30)
                        for img in images])
        assert client.ping() and client.stats['requests'] == 6
        assert client.latency_window().shape == (6,)
        with pytest.raises(RuntimeError, match='expected shape'):
            client.submit(np.zeros(5, np.float32)).result(timeout=30)
        client.stop()
    finally:
        server.stop()
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, engine.predict(images), **SERVE_TOL)


def test_port_client_reads_a_jax_server():
    server = jrpc.EngineServer(Stub(lats=[0.001, 0.002]),
                               secret=b'k').start()
    try:
        client = RemoteEngineClient('127.0.0.1', server.address[1],
                                    secret=b'k')
        frontend = ServingFrontend([client])
        out = frontend.predict(np.ones((3, 4), np.float32))
        np.testing.assert_array_equal(out, np.full((3, 1), 4.0, np.float32))
        assert frontend.stats['latency_ms']['window'] == 2
        client.stop()
    finally:
        server.stop()


def test_two_workers_serve_fail_over_and_shut_down():
    """Two 'lenet_random' worker processes on the CPU behind a frontend:
    64 requests equal an in-process engine of the same spec; one worker
    killed, the requests sent to it fail with transport errors until it
    is evicted, and then the survivor serves every request."""
    procs, clients = worker.spawn_engine_workers(2, LENET_SPEC,
                                                 secret=os.urandom(16))
    frontend = ServingFrontend(clients, max_failures=2).start()
    images = np.random.default_rng(0).standard_normal(
        (64, 28, 28, 1)).astype(np.float32)
    try:
        want = worker.build_engine_from_spec(LENET_SPEC).predict(images)
        assert not np.allclose(want, want[:1])  # input-dependent logits
        np.testing.assert_allclose(frontend.predict(images), want,
                                   **SERVE_TOL)
        stats = frontend.stats
        assert stats['requests'] == 64 and stats['alive'] == [True, True]
        assert all(s['requests'] > 0 for s in stats['engines'])
        assert stats['latency_ms']['window'] == 64

        procs[0].kill()
        procs[0].wait(timeout=30)
        failed = 0
        deadline = time.monotonic() + 60
        while frontend.alive != [False, True]:
            assert time.monotonic() < deadline, 'worker 0 never evicted'
            exc = frontend.submit(images[0]).exception(timeout=60)
            assert exc is None or isinstance(
                exc, ServingFrontend._TRANSPORT_ERRORS), exc
            failed += exc is not None
        assert failed == 2
        np.testing.assert_allclose(frontend.predict(images[:16]), want[:16],
                                   **SERVE_TOL)
        assert 'error' in frontend.stats['engines'][0]
    finally:
        frontend._health_stop.set()
        clients[1].shutdown_server()
        for c in clients:
            c.stop()
        for p in procs:
            if p.poll() is None:
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [-9, 0]


def test_spawn_kills_started_workers_when_one_fails(monkeypatch):
    """A worker whose device is missing exits non-zero and the spawn
    raises; when client construction fails after the workers came up,
    every started worker is killed and reaped before the error."""
    with pytest.raises(RuntimeError, match='exited rc=1'):
        worker.spawn_engine_workers(1, {**LENET_SPEC, 'device': 'meta'},
                                    timeout=60)
    marker = f'QTT_LEAK_TEST_{os.getpid()}_{threading.get_ident()}'

    def boom(*args, **kwargs):
        raise RuntimeError('client construction failed')

    monkeypatch.setattr(rpc, 'RemoteEngineClient', boom)
    with pytest.raises(RuntimeError, match='client construction'):
        worker.spawn_engine_workers(2, {**LENET_SPEC, 'warmup': False},
                                    env={'QTT_MARKER': marker})

    def marked_pids():
        alive = []
        for pid in filter(str.isdigit, os.listdir('/proc')):
            try:
                env = pathlib.Path(f'/proc/{pid}/environ').read_bytes()
            except OSError:
                continue
            if marker.encode() in env:
                alive.append(pid)
        return alive

    assert marked_pids() == []


def test_worker_specs_that_wait_for_checkpoints_raise(tmp_path):
    """The checkpoint specs need their directory: without one, or with one
    that holds no config and checkpoint, they raise (they serve in
    tests/test_torch_port_prepare.py); an unknown spec raises too."""
    for kind, key in (('experiment', 'experiment_dir'),
                      ('artifact', 'artifact_dir')):
        with pytest.raises(KeyError, match=key):
            worker.build_engine_from_spec({'model': kind, 'device': 'cpu'})
        with pytest.raises(FileNotFoundError):
            worker.build_engine_from_spec({
                'model': kind, key: str(tmp_path), 'device': 'cpu',
                'input_shape': [28, 28, 1]})
    with pytest.raises(ValueError, match='unknown model spec'):
        worker.build_engine_from_spec({'model': 'vgg'})
