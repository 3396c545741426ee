"""Data parallel over processes in the port (parallel/, train/engine.py
mesh=, train/task.py's multi-process branches), on the CPU over gloo.

Two processes each run one rank. Cases:

* the 2-process run of tests/parallel/_mp_train_worker.py's config
  (classification_task, LeNet-5 ls-1, synthetic data): both ranks
  report the same global metrics, equal to a single-process run of the
  port fed the same logical batch stream (the ranks' shards in rank
  order);
* one DP train step of a LeNet-5 (BatchNorm) and of a small XNOR ResNet
  (BatchNorm and EMA activation scales), the ResNet also with each block
  rematerialized (remat: the backward recomputes each block, with its
  statistics over both ranks' rows again), with a mesh, each rank on
  half of one seeded batch: the averaged gradients, the updated
  parameters, the BN running statistics and the EMA equal one
  single-process step of the port, and one step of the JAX package's
  make_train_step (one program over the global batch), on the whole
  batch;
* the same step with train-mode statistics left local (what DDP over
  the port's modules as they are would compute) differs from the
  single-process step, so the comparison above can fail.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
PROCESS_TIMEOUT = 120
# The ranks against each other: the same all-reduced numbers.
RANKS_RTOL = 1e-6
# DP against one process on the same logical batches. The global batch's
# sums are taken as two partial sums (BN statistics, gradients, the
# EMA's batch mean), a different float32 order; one step moves leaves by
# a few ulps.
STEP_TOL = dict(rtol=2e-5, atol=2e-6)
# The run of four SGD steps of the ls-1 LeNet-5: those ulps reach tied
# max-pool windows after its binary conv, which route the gradient to
# another position, so the runs part by a little. Measured on the CPU:
# one process alone moves its loss by up to 3e-4 relative with the
# thread count (1, 2 or 8 threads), and the ranks' run sits up to 5.3e-4
# from it; the accuracies move by one example of a set. JAX's own
# 2-process test allows 1e-3 on the loss.
RUN_RTOL = 1e-3
RUN_ACC_EXAMPLES = 1
# Local statistics move BN's running mean by a batch-mean difference
# (O(0.1) on four rows): far beyond STEP_TOL.
LOCAL_MIN_DIFF = 1e-3


def mp_config(root: str) -> dict:
    """tests/parallel/_mp_train_worker.py's config, on the CPU."""
    return {
        'seed': 0,
        'experiment_name': 'mp',
        'device': 'cpu',
        'environment': {'platform': 'local', 'nchips': 0},
        'data': {'dataset': 'synthetic', 'train_batch_size': 16,
                 'test_batch_size': 16, 'train_size': 64, 'test_size': 32,
                 'image_shape': (28, 28, 1), 'seed': 3},
        'model': {'architecture': 'lenet5', 'loss': 'nll_loss',
                  'arch_config': {'conv1_filters': 4, 'conv2_filters': 4,
                                  'x_quant': 'ls-1', 'w_quant': 'ls-1',
                                  'clamp': {'kind': 'identity'},
                                  'output_classes': 10}},
        'optimization': {'epochs': 1,
                         'optimizer': {'algorithm': 'sgd', 'lr': 0.1},
                         'lr_scheduler': {'scheduler': 'step_lr',
                                          'step_size': 1, 'gamma': 1.0}},
        'log': {'level': 'WARNING', 'interval': 100,
                'root_experiments_dir': root, 'save_model_freq': 100},
    }


OPT_CONFIG = {'epochs': 1, 'optimizer': {'algorithm': 'sgd', 'lr': 0.1},
              'lr_scheduler': {'scheduler': 'step_lr', 'step_size': 1,
                               'gamma': 1.0}}
# id: (probes.models family, x_quant, w_quant, loss, input shape,
# constructor keywords). The LeNet-5's conv2 takes float activations: a
# 2x2 max pool follows it, and on binary activations its windows hold
# tied integer dots, whose gradient an ulp of BN statistics routes to
# another position (the train-step trap of
# tests/test_torch_port_train_step.py).
STEP_CASES = {'lenet': ('lenet', 'fp', 'ls-1', 'nll_loss', (28, 28, 1), {}),
              'xnor_resnet': ('xnor', 'ls-1', 'ls-1', 'cross_entropy',
                              (32, 32, 3), {}),
              'xnor_resnet_remat': ('xnor', 'ls-1', 'ls-1', 'cross_entropy',
                                    (32, 32, 3), {'remat': True})}
STEP_BATCH = 8


def _step_model(case: str) -> tuple[torch.nn.Module, object]:
    """The case's seeded model (probes.models.small_config, trained-like
    state from seed_state) and its train state under SGD."""
    from quant_tpu_torch import train as T
    from quant_tpu_torch.probes.models import build, seed_state, small_config
    family, xq, wq, _, _, kw = STEP_CASES[case]
    gen = torch.Generator().manual_seed(0)
    model = build(family, small_config(family, xq, wq), device='cpu',
                  generator=gen, **kw)
    seed_state(model, gen)
    tx, _ = T.make_optimizer(OPT_CONFIG, 1, 1)
    return model, T.TrainState.create(model, tx)


def _step_batch(case: str) -> tuple[torch.Tensor, torch.Tensor]:
    shape = STEP_CASES[case][4]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((STEP_BATCH,) + shape).astype(np.float32)
    y = rng.integers(0, 10, STEP_BATCH)
    return torch.from_numpy(x), torch.from_numpy(y)


def _grad_tree(model: torch.nn.Module) -> dict:
    """The parameters' gradients as the JAX params tree (0 where none)."""
    from quant_tpu_torch.utils.jax_import import to_jax_variables
    saved = [(p, p.data) for p in model.parameters()]
    try:
        for p in model.parameters():
            p.data = (p.grad if p.grad is not None
                      else torch.zeros_like(p.data))
        return to_jax_variables(model)['params']
    finally:
        for p, data in saved:
            p.data = data


def one_step(case: str, rows: slice, mesh: object = None) -> dict:
    """One train step of the case on rows of its batch: the gradients
    (as the JAX params tree), the model's variable tree after the step,
    the loss and metrics."""
    from quant_tpu_torch import train as T
    from quant_tpu_torch.train.metrics import init_metric_state
    from quant_tpu_torch.utils.jax_import import to_jax_variables
    model, state = _step_model(case)
    x, y = _step_batch(case)
    step = T.make_train_step(T.get_loss_fn(STEP_CASES[case][3]), mesh=mesh)
    state, metric_state, loss = step(state, x[rows], y[rows],
                                     init_metric_state())
    metrics = T.MetricAccumulator(state=metric_state).compute()
    return dict(grads=_grad_tree(model), tree=to_jax_variables(model),
                loss=float(loss), metrics=metrics)


def jax_step(case: str) -> dict:
    """One step of the JAX package's make_train_step on the whole batch,
    from the port's initial variables (one_step's dict)."""
    import jax
    import jax.numpy as jnp
    from quant_tpu.nn import QLeNet5, QResNet
    from quant_tpu.train import engine as jengine
    from quant_tpu.train import losses as jlosses
    from quant_tpu.train import metrics as jmetrics
    from quant_tpu.train import optim as joptim
    from quant_tpu.train import state as jstate
    from quant_tpu_torch.probes.models import small_config
    from quant_tpu_torch.utils.jax_import import to_jax_variables
    family, xq, wq, loss_name, _, kw = STEP_CASES[case]
    jm = (QLeNet5 if family == 'lenet' else QResNet)(
        **small_config(family, xq, wq), **kw)
    variables = to_jax_variables(_step_model(case)[0])
    x, y = (jnp.asarray(a.numpy()) for a in _step_batch(case))
    jloss = jlosses.get_loss_fn(loss_name)

    def loss_for(params: dict) -> jax.Array:
        out, _ = jm.apply({**variables, 'params': params}, x, True,
                          mutable=['batch_stats', 'quant_state'])
        return jloss(out, y)

    grads = jax.jit(jax.grad(loss_for))(variables['params'])
    tx, _ = joptim.make_optimizer(OPT_CONFIG, 1, 1)
    jst = jstate.TrainState.create(jm.apply, variables, tx)
    jst, metric_state, loss = jengine.make_train_step(jloss, donate=False)(
        jst, x, y, jmetrics.init_metric_state())
    tree = {'params': jst.params, 'batch_stats': jst.batch_stats,
            'quant_state': jst.quant_state}
    metrics = jmetrics.MetricAccumulator(state=metric_state).compute()
    return dict(grads=jax.tree_util.tree_map(np.asarray, grads),
                tree=jax.tree_util.tree_map(np.asarray, tree),
                loss=float(loss), metrics=metrics)


def _worker() -> None:
    """One rank: python -c '...' <rank> <world> <port> <out> <kind>."""
    rank, world, port = (int(a) for a in sys.argv[1:4])
    out, kind = sys.argv[4], sys.argv[5]
    from quant_tpu_torch.parallel import make_mesh, multihost
    multihost.initialize(f'127.0.0.1:{port}', world, rank, device='cpu')
    if kind == 'task':
        from quant_tpu_torch.train.task import classification_task
        train_m, test_m = classification_task(mp_config(str(Path(out).parent)),
                                              Path(out).parent)
        Path(out).write_text(json.dumps({'train': train_m, 'test': test_m}))
        return
    from quant_tpu_torch.train import engine
    mesh = make_mesh(device_type='cpu')
    per = STEP_BATCH // world
    rows = slice(rank * per, (rank + 1) * per)
    results = {}
    for case in STEP_CASES:
        results[case] = one_step(case, rows, mesh)
        # Statistics left local: what each rank computes on its own.
        with _local_statistics(engine):
            results[case + '_local'] = one_step(case, rows, mesh)
    torch.save(results, out)


@contextlib.contextmanager
def _local_statistics(engine):
    saved = engine.global_stats.over
    engine.global_stats.over = lambda group: contextlib.nullcontext()
    try:
        yield
    finally:
        engine.global_stats.over = saved


def _run_world(tmp: Path, kind: str) -> list[Path]:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    outs = [tmp / f'{kind}{r}.out' for r in range(WORLD)]
    code = 'from tests.test_torch_port_dp import _worker; _worker()'
    procs = [subprocess.Popen(
        [sys.executable, '-c', code, str(r), str(WORLD), str(port),
         str(outs[r]), kind], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1'))
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROCESS_TIMEOUT)[0].decode(
                errors='replace'))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f'rank failed:\n{log[-3000:]}'
    return outs


@pytest.fixture(scope='module')
def task_results(tmp_path_factory):
    outs = _run_world(tmp_path_factory.mktemp('dp_task'), 'task')
    return [json.loads(o.read_text()) for o in outs]


@pytest.fixture(scope='module')
def step_results(tmp_path_factory):
    outs = _run_world(tmp_path_factory.mktemp('dp_step'), 'step')
    return [torch.load(o, weights_only=False) for o in outs]


def _leaves(tree: dict, prefix: str = '') -> dict:
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f'{prefix}/{k}'))
    return out


def test_task_ranks_agree(task_results):
    r0, r1 = task_results
    assert r0['train'] and r0['test']
    for part in ('train', 'test'):
        for k in r0[part][0]:
            np.testing.assert_allclose(r0[part][0][k], r1[part][0][k],
                                       rtol=RANKS_RTOL, err_msg=k)


def test_task_matches_single_process_on_same_batches(task_results):
    """The port's single-process run on the same logical batch stream:
    rank 0's shard rows, then rank 1's, every step."""
    from quant_tpu_torch import train as T
    from quant_tpu_torch.data.loaders import SyntheticDataLoader
    from quant_tpu_torch.parallel.multihost import shard_loader_for_host
    from quant_tpu_torch.train.task import init_model_variables

    cfg = mp_config('unused')
    data_cfg = {k: v for k, v in cfg['data'].items() if k != 'dataset'}
    dl = SyntheticDataLoader(**data_cfg)
    shards = [shard_loader_for_host(dl.get_train_loader(), pi, WORLD)
              for pi in range(WORLD)]
    logical = [(np.concatenate([b[0] for b in step]),
                np.concatenate([b[1] for b in step]))
               for step in zip(*shards)]
    model = init_model_variables('lenet5', cfg['model']['arch_config'],
                                 cfg['seed'], 'cpu')
    tx, _ = T.make_optimizer(cfg['optimization'], 1, len(logical))
    state = T.TrainState.create(model, tx)
    step = T.make_train_step(T.get_loss_fn('nll_loss'))
    state, train_m = T.train_epoch(step, state, logical, epoch=1,
                                   log_interval=100)
    test_m = T.evaluate(T.make_eval_step(T.get_loss_fn('nll_loss')), state,
                        dl.get_test_loader())
    got = task_results[0]
    for part, want, n in (('train', train_m, cfg['data']['train_size']),
                          ('test', test_m, cfg['data']['test_size'])):
        np.testing.assert_allclose(got[part][0]['Loss'], want['Loss'],
                                   rtol=RUN_RTOL)
        for k in ('Top-1 Accuracy', 'Top-5 Accuracy'):
            np.testing.assert_allclose(got[part][0][k], want[k], rtol=0,
                                       atol=RUN_ACC_EXAMPLES / n, err_msg=k)


@pytest.mark.parametrize('case', list(STEP_CASES))
def test_dp_step_equals_single_process_step(step_results, case):
    """Each rank's step against the port's single-process step and JAX's
    step, both on the whole batch."""
    for ref, want in (('port', one_step(case, slice(None))),
                      ('jax', jax_step(case))):
        for rank in range(WORLD):
            got = step_results[rank][case]
            where = f'{ref}, rank {rank}'
            for part in ('grads', 'tree'):
                got_l, want_l = _leaves(got[part]), _leaves(want[part])
                assert set(got_l) == set(want_l), where
                for path, leaf in want_l.items():
                    np.testing.assert_allclose(
                        got_l[path], leaf, **STEP_TOL,
                        err_msg=f'{where} {part} {path}')
            np.testing.assert_allclose(got['loss'], want['loss'], **STEP_TOL,
                                       err_msg=where)
            for k, v in want['metrics'].items():
                np.testing.assert_allclose(got['metrics'][k], v, **STEP_TOL,
                                           err_msg=f'{where} {k}')


@pytest.mark.parametrize('case', list(STEP_CASES))
def test_local_statistics_would_differ(step_results, case):
    """Each rank's own BN statistics (and EMA batch mean) give another
    model: the running statistics move beyond STEP_TOL."""
    want = _leaves(one_step(case, slice(None))['tree'])
    got = _leaves(step_results[0][case + '_local']['tree'])
    worst = max(float(np.abs(got[p] - want[p]).max())
                for p in want if p.startswith('/batch_stats'))
    assert worst > LOCAL_MIN_DIFF
    # The global-statistics step of the same rank stays within STEP_TOL.
    ok = _leaves(step_results[0][case]['tree'])
    assert max(float(np.abs(ok[p] - want[p]).max())
               for p in want if p.startswith('/batch_stats')) < LOCAL_MIN_DIFF
