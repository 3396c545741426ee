"""The port's InferenceEngine serving a tensor-parallel model
(serving/engine.py over parallel.sharding.shard_model), on the CPU over
gloo, against the unsharded engine (tests/serving/test_tp_serving.py).

A world of 2 ranks (mesh data 1 x model 2) is spawned once for the file.
Each rank shards the same packed model (the LeNet-5 ls-1 x ls-2 of
test_tp_serving.py, and the threshold-folded, stripped XNOR ResNet of
test_tp_packed.py; seeded, exported and folded by the port, as
tests/test_torch_port_tp.py's forward cases) and builds an engine on
it: rank 0's engine leads (queue, batching, futures), rank 1's follows.
Cases:

* `predict` and the queued `submit` path of the leader equal the
  unsharded engine's logits within 1e-5, the folded chain within JAX's
  2e-4 of its sharded forward;
* the leader's warm-up runs on the follower too, `stop()` ends both
  ranks' engines, and the follower refuses requests.
"""

import numpy as np
import pytest
import torch

from chip_smoke import tail_calls
from tests.test_torch_port_tp import (
    FOLDED, FOLDED_TOL, FORWARD_TOL, _port_model, jax_forward_case,
    run_world,
)

SERVE_CASES = ('lenet', 'xnor_folded')
ENGINE_TOL = dict(rtol=1e-5, atol=1e-5)  # test_tp_serving.py's
MAX_BATCH = 8


def _engine(model: torch.nn.Module, x: np.ndarray):
    from quant_tpu_torch.serving.engine import InferenceEngine
    return InferenceEngine(model, input_shape=x.shape[1:],
                           max_batch=MAX_BATCH, device='cpu')


def _serve(rank: int, case: str, tree: dict, x: np.ndarray,
           mesh: object) -> dict:
    with tail_calls() as tails:
        out = _serve_rank(rank, case, tree, x, mesh)
    out['tails'] = tails[0]
    return out


def _serve_rank(rank: int, case: str, tree: dict, x: np.ndarray,
                mesh: object) -> dict:
    from quant_tpu_torch.parallel import shard_model
    engine = _engine(shard_model(_port_model(case, tree), mesh), x)
    out: dict = {'leader': engine.leader}
    if rank == 0:
        engine.warmup([MAX_BATCH])
        engine.start()
        try:
            out['predict'] = engine.predict(x)
            futs = [engine.submit(row) for row in x]
            out['queued'] = np.stack([f.result(timeout=60) for f in futs])
            out['requests'] = engine.stats['requests']
        finally:
            engine.stop()
        return out
    engine.start()
    refused = []
    for call in (lambda: engine.predict(x), lambda: engine.submit(x[0])):
        try:
            call()
        except RuntimeError:
            refused.append(True)
    out['refused'] = len(refused) == 2
    engine.stop(timeout=120)
    out['stopped'] = not engine._thread.is_alive()
    return out


def _worker() -> None:
    """One rank: python -c '...' <rank> <world> <port> <out> <inputs>."""
    import sys
    rank, world, port = (int(a) for a in sys.argv[1:4])
    out, inputs = sys.argv[4], sys.argv[5]
    from quant_tpu_torch.parallel import make_mesh, multihost
    multihost.initialize(f'127.0.0.1:{port}', world, rank, device='cpu')
    mesh = make_mesh(model=2, device_type='cpu')
    data = torch.load(inputs, weights_only=False)
    torch.save({case: _serve(rank, case, data['trees'][case],
                             data['x'][case], mesh)
                for case in SERVE_CASES}, out)


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('tp_serving')
    cases = {case: jax_forward_case(case) for case in SERVE_CASES}
    inputs = tmp / 'inputs.pt'
    torch.save({'trees': {c: v[0] for c, v in cases.items()},
                'x': {c: v[1] for c, v in cases.items()}}, inputs)
    ranks = run_world(tmp, 2, inputs, 'test_torch_port_tp_serving')
    return cases, ranks


@pytest.mark.parametrize('case', SERVE_CASES)
def test_tp_engine_equals_unsharded_engine(served, case):
    cases, ranks = served
    tree, x, jax_sharded = cases[case]
    engine = _engine(_port_model(case, tree), x)
    want = engine.predict(x)
    got = ranks[0][case]
    np.testing.assert_allclose(got['predict'], want, **ENGINE_TOL)
    np.testing.assert_allclose(got['queued'], want, **ENGINE_TOL)
    assert got['requests'] == x.shape[0]
    tol = FOLDED_TOL if case in FOLDED else FORWARD_TOL
    np.testing.assert_allclose(got['predict'], jax_sharded, **tol)


@pytest.mark.parametrize('case', SERVE_CASES)
def test_tp_forward_takes_no_tail(served, case):
    """A sharded conv serves its slice of the channels: its block's tail
    stays with the eager ops (no binary conv is handed a tail on either
    rank)."""
    _, ranks = served
    assert [r[case]['tails'] for r in ranks] == [0, 0]


@pytest.mark.parametrize('case', SERVE_CASES)
def test_follower_refuses_requests_and_stops_with_the_leader(served, case):
    _, ranks = served
    assert ranks[0][case]['leader'] and not ranks[1][case]['leader']
    assert ranks[1][case]['refused'] and ranks[1][case]['stopped']

