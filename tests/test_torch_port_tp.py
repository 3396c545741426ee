"""Tensor parallelism in the port (parallel/sharding.py, tp_overlap.py,
the sharded layers, make_train_step over a ('data', 'model') mesh,
train/task.py at environment.tensor_parallel) against the JAX package,
on the CPU over gloo.

Two worlds are spawned once for the file, as tests/test_torch_port_dp.py
spawns its worlds: 2 ranks (mesh data 1 x model 2) and 4 ranks (mesh
2 x 2, and 1 x 4 for the ring). JAX runs on the 8 virtual CPU devices of
tests/conftest.py. Cases:

* `shard_model_variables`' placements, as PartitionSpec entries, equal
  JAX's leaf for leaf on the same trees (params, quant_state,
  packed_params, folded and not);
* the ring GEMMs (`tp_binary_matmul_overlapped`,
  `tp_packed_matmul_overlapped`) equal JAX's at P = 2 and 4, gathered and
  scattered, bit for bit;
* the TP packed forwards of JAX's three cases (tests/parallel/
  test_tp_packed.py: LeNet-5 ls-1 x ls-2, the bottleneck family, the
  threshold-folded XNOR family) and of the bottleneck with its BN folded
  into the epilogue (b_fold, replicated by JAX's rules, sliced with O by
  the port) and stripped, each rank's logits against JAX's sharded
  forward at JAX's tolerances. The trees are the port's, seeded
  (probes.models.seed_state), exported and folded, and handed to JAX;
* one TP train step of the DP test's cases (mesh 1 x 2, and 2 x 2 with
  the batch over 'data') against one process of the port on the whole
  batch, and LeNet-5's and the XNOR ResNet's against JAX's TP step,
  within the DP step's 2e-5;
  the same step with the library all-gather, whose backward sums the
  group's gradients, lands beyond 1e-3;
* the ranks of one 'model' group read the same rows of a dataset, the
  'data' coordinates disjoint ones;
* classification_task at tensor_parallel 2 within JAX's rtol 2e-3 of
  tp = 1 (test_tp_task.py's config), restored at tp = 2, its checkpoint
  restored at tp = 1 and a tp = 1 checkpoint restored at tp = 2.
"""

import copy
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
import torch

from tests.test_torch_port_dp import (
    OPT_CONFIG, STEP_BATCH, STEP_CASES, STEP_TOL, _leaves, _step_batch,
    one_step,
)

REPO = Path(__file__).resolve().parents[1]
PROCESS_TIMEOUT = 150
# JAX's own tolerances for its sharded forwards against the unsharded
# ones (test_tp_packed.py); the folded chain is 2e-4.
FORWARD_TOL = dict(rtol=1e-4, atol=1e-4)
FOLDED_TOL = dict(rtol=2e-4, atol=2e-4)
# The summing backward gives P x the sharded leaves' gradients.
SUMMING_MIN_DIFF = 1e-3
# test_tp_task.py: tp = 2 against tp = 1, reductions reassociated.
TASK_RTOL = 2e-3
RING_SHAPE = (16, 64, 8)  # (M, K, N) per rank of the ring: x P for K, N
_CLAMP = {'kind': 'symmetric', 'alpha': 2.0}
_LAYER = {'x_quant': 'ls-1', 'w_quant': 'ls-1', 'clamp': _CLAMP}
_STEM = {'n_in_channels': 8, 'kernel_size': 3, 'stride': 1, 'padding': 1,
         'bias': False, 'maxpool': {'type': 'identity'}}
# JAX's three TP forward cases and the epilogue fold: (family,
# constructor keywords, input).
FORWARD_CASES = {
    'lenet': ('lenet', dict(conv1_filters=4, conv2_filters=16,
                            x_quant='ls-1', w_quant='ls-2', clamp=_CLAMP),
              (8, 28, 28, 1)),
    'bottleneck': ('resnet', dict(
        block='regular_bottleneck', layer0=_STEM, layer1=_LAYER,
        layer2=_LAYER, layer3=_LAYER, layer4=None, nonlins=['relu', 'relu'],
        num_blocks=[1, 1, 1], output_classes=10), (8, 16, 16, 3)),
    'xnor_folded': ('resnet', dict(
        block='xnor', layer0=_STEM,
        layer1={**_LAYER, 'double_shortcut': True},
        layer2={**_LAYER, 'double_shortcut': True},
        layer3={**_LAYER, 'double_shortcut': True}, layer4=None,
        nonlins=['prelu', 'prelu'], num_blocks=[1, 1, 1], output_classes=16,
        moving_average_mode='eval_only'), (8, 16, 16, 3)),
}
FORWARD_CASES['bottleneck_folded'] = FORWARD_CASES['bottleneck']
FOLDED = ('xnor_folded', 'bottleneck_folded')


def task_config(root: str, name: str, tensor_parallel: int) -> dict:
    """tests/parallel/test_tp_task.py's config, on the CPU, with SGD
    momentum: its checkpoints carry moments to gather and place."""
    return {
        'seed': 11, 'experiment_name': name, 'device': 'cpu',
        'environment': {'tensor_parallel': tensor_parallel},
        'data': {'dataset': 'synthetic', 'train_batch_size': 16,
                 'test_batch_size': 16, 'train_size': 64, 'test_size': 32},
        'model': {'architecture': 'lenet5', 'loss': 'nll_loss',
                  'arch_config': {'conv1_filters': 4, 'conv2_filters': 8,
                                  'x_quant': 'ls-1', 'w_quant': 'ls-1'}},
        'optimization': {'epochs': 1,
                         'optimizer': {'algorithm': 'sgd', 'lr': 0.05,
                                       'momentum': 0.9},
                         'lr_scheduler': {'scheduler': 'step_lr',
                                          'step_size': 1, 'gamma': 1.0}},
        'log': {'level': 'WARNING', 'interval': 10, 'save_model_freq': 1,
                'tensorboard': False, 'root_experiments_dir': root},
    }


# ------------------------------------------------------------ the JAX side


def forward_tree(case: str) -> dict:
    """The case's packed model as the port seeds, exports and (for the
    FOLDED cases) folds and strips it: the JAX variable tree."""
    from quant_tpu_torch.nn import export
    from quant_tpu_torch.probes.models import seed_state
    from quant_tpu_torch.utils.jax_import import to_jax_variables
    gen = torch.Generator().manual_seed(0)
    model = _port_model(case, None, gen)
    seed_state(model, gen)
    export.export_packed_variables(model)
    if case in FOLDED:
        if not export.fold_for_serving(model)[1]:
            raise AssertionError(f'{case}: no fold applied')
        export.strip_for_deployment(model)
    return to_jax_variables(model)


def jax_forward_case(case: str) -> tuple[dict, np.ndarray, np.ndarray]:
    """(forward_tree(case), a seeded input, JAX's forward with the tree
    sharded over a data 4 x model 2 mesh, as test_tp_packed.py runs it)."""
    import jax
    import jax.numpy as jnp
    from quant_tpu.nn import QLeNet5, QResNet
    from quant_tpu.parallel import make_mesh, shard_model_variables
    from quant_tpu.parallel.sharding import batch_sharding
    family, kw, shape = FORWARD_CASES[case]
    model = (QLeNet5 if family == 'lenet' else QResNet)(
        **copy.deepcopy(kw), inference_mode='packed', bn_fold=case in FOLDED)
    tree = forward_tree(case)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    mesh = make_mesh(data=4, model=2)
    shardings = shard_model_variables(tree, mesh, tensor_parallel=True)
    sharded = jax.tree.map(jax.device_put, tree, shardings,
                           is_leaf=lambda v: hasattr(v, 'shape'))
    out = jax.jit(lambda v, xb: model.apply(v, xb, False))(
        sharded, jax.device_put(jnp.asarray(x), batch_sharding(mesh)))
    return tree, x, np.asarray(out)


def jax_specs(tree: dict) -> dict:
    """JAX's PartitionSpec of each leaf, padded with None to its rank."""
    import jax
    from quant_tpu.parallel import make_mesh, shard_model_variables
    sh = shard_model_variables(tree, make_mesh(model=2), tensor_parallel=True)
    return jax.tree_util.tree_map(
        lambda s, leaf: tuple(s.spec) + (None,) * (
            np.ndim(leaf) - len(s.spec)), sh, tree)


def ring_operands(p: int) -> dict:
    """Seeded {-1,+1} X (M, K), W (K, N) and their packed words."""
    from quant_tpu_torch.ops.binary_gemm import pack_for_xnor
    m, k, n = RING_SHAPE[0], RING_SHAPE[1] * p, RING_SHAPE[2] * p
    rng = np.random.default_rng(p)
    x = np.where(rng.standard_normal((m, k)) >= 0, 1.0, -1.0).astype(
        np.float32)
    w = np.where(rng.standard_normal((k, n)) >= 0, 1.0, -1.0).astype(
        np.float32)
    xp, wp = pack_for_xnor(torch.from_numpy(x), torch.from_numpy(w))
    return dict(x=x, w=w, xp=xp.numpy(), wp=wp.numpy(), k=k)


def jax_rings(p: int) -> dict:
    """JAX's ring GEMMs on ring_operands(p), gathered and scattered (the
    scattered result as the logical array), and JAX's packing."""
    import jax
    import jax.numpy as jnp
    from quant_tpu.ops.binary_gemm import pack_for_xnor
    from quant_tpu.parallel import make_mesh
    from quant_tpu.parallel.tp_overlap import (
        tp_binary_matmul_overlapped, tp_packed_matmul_overlapped,
    )
    ops = ring_operands(p)
    mesh = make_mesh(data=1, model=p, devices=jax.devices()[:p])
    x, w = jnp.asarray(ops['x']), jnp.asarray(ops['w'])
    xp, wp = pack_for_xnor(x, w)
    out = {'xp': np.asarray(xp), 'wp': np.asarray(wp)}
    for gather in (True, False):
        out[f'dense_{gather}'] = np.asarray(tp_binary_matmul_overlapped(
            x, w, mesh, gather_output=gather))
        out[f'packed_{gather}'] = np.asarray(tp_packed_matmul_overlapped(
            xp, wp, k_total=ops['k'], mesh=mesh, gather_output=gather))
    return out


def jax_tp_step(case: str) -> dict:
    """One step of JAX's make_train_step with the variables sharded over
    a data 1 x model 2 mesh (test_tp_task.py's placement) on the whole
    batch, from the port's initial variables: the tree after the step
    and the loss, as the DP test's jax_step gives them."""
    import jax
    import jax.numpy as jnp
    from quant_tpu.nn import QLeNet5, QResNet
    from quant_tpu.parallel import make_mesh, shard_model_variables
    from quant_tpu.train import engine as jengine
    from quant_tpu.train import losses as jlosses
    from quant_tpu.train import metrics as jmetrics
    from quant_tpu.train import optim as joptim
    from quant_tpu.train import state as jstate
    from quant_tpu_torch.probes.models import small_config
    from quant_tpu_torch.utils.jax_import import to_jax_variables
    from tests.test_torch_port_dp import _step_model
    family, xq, wq, loss_name, _, kw = STEP_CASES[case]
    jm = (QLeNet5 if family == 'lenet' else QResNet)(
        **small_config(family, xq, wq), **kw)
    variables = to_jax_variables(_step_model(case)[0])
    mesh = make_mesh(data=1, model=2)
    variables = jax.tree.map(
        jax.device_put, variables,
        shard_model_variables(variables, mesh, tensor_parallel=True),
        is_leaf=lambda v: hasattr(v, 'shape'))
    x, y = (jnp.asarray(a.numpy()) for a in _step_batch(case))
    jloss = jlosses.get_loss_fn(loss_name)
    tx, _ = joptim.make_optimizer(OPT_CONFIG, 1, 1)
    jst = jstate.TrainState.create(jm.apply, variables, tx)
    jst, _, loss = jengine.make_train_step(jloss, mesh=mesh, donate=False)(
        jst, x, y, jmetrics.init_metric_state())
    tree = {'params': jst.params, 'batch_stats': jst.batch_stats,
            'quant_state': jst.quant_state}
    return dict(tree=jax.tree_util.tree_map(np.asarray, tree),
                loss=float(loss))


# ---------------------------------------------------------- the port side


def _port_model(case: str, tree: Optional[dict],
                generator: Optional[torch.Generator] = None
                ) -> torch.nn.Module:
    """The case's packed port model on the CPU, loaded from `tree` when
    one is given."""
    from quant_tpu_torch.nn import QLeNet5, QResNet
    from quant_tpu_torch.utils.jax_import import from_jax_variables
    family, kw, _ = FORWARD_CASES[case]
    cls = QLeNet5 if family == 'lenet' else QResNet
    model = cls(**copy.deepcopy(kw), inference_mode='packed', device='cpu',
                bn_fold=case in FOLDED, generator=generator)
    return model if tree is None else from_jax_variables(model, tree)


def _tp_model(case: str, mesh: object) -> tuple:
    """The DP test's step model (same seed, same state), sharded before
    its optimizer is built."""
    from quant_tpu_torch import train as T
    from quant_tpu_torch.parallel.sharding import shard_model
    from quant_tpu_torch.probes.models import build, seed_state, small_config
    family, xq, wq, _, _, kw = STEP_CASES[case]
    gen = torch.Generator().manual_seed(0)
    model = build(family, small_config(family, xq, wq), device='cpu',
                  generator=gen, **kw)
    seed_state(model, gen)
    shard_model(model, mesh)
    tx, _ = T.make_optimizer(OPT_CONFIG, 1, 1)
    return model, T.TrainState.create(model, tx)


def tp_step(case: str, mesh: object, rows: slice) -> dict:
    """One TP train step of a DP test case on rows of its batch: the
    gathered gradients and tree after the step, the loss and metrics
    (one_step's dict)."""
    from quant_tpu_torch import train as T
    from quant_tpu_torch.parallel.sharding import gather_model_variables
    from quant_tpu_torch.train.metrics import init_metric_state
    model, state = _tp_model(case, mesh)
    x, y = _step_batch(case)
    step = T.make_train_step(T.get_loss_fn(STEP_CASES[case][3]), mesh=mesh)
    state, metric_state, loss = step(state, x[rows], y[rows],
                                     init_metric_state())
    tree = gather_model_variables(model)
    saved = [(p, p.data) for p in model.parameters()]
    try:
        for p in model.parameters():
            p.data = (p.grad if p.grad is not None
                      else torch.zeros_like(p.data))
        grads = gather_model_variables(model)['params']
    finally:
        for p, data in saved:
            p.data = data
    return dict(grads=grads, tree=tree, loss=float(loss),
                metrics=T.MetricAccumulator(state=metric_state).compute())


def _library_gather(x: torch.Tensor, tp: object) -> torch.Tensor:
    """The library's all-gather: its backward sums the group's
    gradients."""
    import torch.distributed.nn.functional as DF
    return torch.cat(DF.all_gather(x.contiguous(), group=tp.group), dim=-1)


def _spec_tree(tree: dict, mesh: object) -> dict:
    from quant_tpu_torch.parallel.sharding import (
        _map_tree, partition_spec, shard_model_variables,
    )
    placements = shard_model_variables(tree, mesh, tensor_parallel=True)
    return _map_tree(
        lambda coll, path, leaf: partition_spec(
            _lookup(placements[coll], path), np.ndim(leaf), mesh), tree)


def _lookup(tree: dict, path: tuple) -> object:
    for key in path:
        tree = tree[key]
    return tree


def _ring_results(p: int, mesh: object, index: int) -> dict:
    """This rank's ring GEMMs on its K-shard of ring_operands(p)."""
    from quant_tpu_torch.parallel import (
        tp_binary_matmul_overlapped, tp_packed_matmul_overlapped,
    )
    ops = ring_operands(p)
    kl, wl = ops['x'].shape[1] // p, ops['xp'].shape[1] // p
    x = torch.from_numpy(ops['x'][:, index * kl:(index + 1) * kl])
    w = torch.from_numpy(ops['w'][index * kl:(index + 1) * kl])
    xp = torch.from_numpy(ops['xp'][:, index * wl:(index + 1) * wl])
    wp = torch.from_numpy(ops['wp'][index * wl:(index + 1) * wl])
    out = {}
    for gather in (True, False):
        out[f'dense_{gather}'] = tp_binary_matmul_overlapped(
            x, w, mesh, gather_output=gather).numpy()
        out[f'packed_{gather}'] = tp_packed_matmul_overlapped(
            xp, wp, ops['k'], mesh, gather_output=gather).numpy()
    return out


def _world2(rank: int, inputs: dict, root: str) -> dict:
    from quant_tpu_torch import nn as qnn
    from quant_tpu_torch.parallel import make_mesh, shard_model
    from quant_tpu_torch.train.task import classification_task
    from quant_tpu_torch.parallel.sharding import gather, place
    mesh = make_mesh(model=2, device_type='cpu')
    out: dict = {'specs': {}, 'forward': {}, 'steps': {}, 'placed': {}}
    for case, tree in inputs['trees'].items():
        out['specs'][case] = _spec_tree(tree, mesh)
        local = place(tree, mesh)
        out['placed'][case] = (local, gather(local, mesh))
        model = shard_model(_port_model(case, tree), mesh)
        with torch.no_grad():
            out['forward'][case] = model(
                torch.from_numpy(inputs['x'][case])).numpy()
    out['ring'] = _ring_results(2, mesh, rank)
    for case in STEP_CASES:
        out['steps'][case] = tp_step(case, mesh, slice(None))
    saved = qnn.layers.gather_channels
    qnn.layers.gather_channels = _library_gather
    try:
        out['steps']['lenet_summing'] = tp_step('lenet', mesh, slice(None))
    finally:
        qnn.layers.gather_channels = saved
    runs = {}
    for name, restore in (('tp2', None), ('tp2_restored', 'tp2'),
                          ('tp1_at_tp2', 'tp1')):
        runs[name] = classification_task(
            task_config(root, name, 2), Path(root),
            restore_experiment=Path(root) / restore if restore else None)
    out['task'] = runs
    return out


def _world4(rank: int) -> dict:
    from quant_tpu_torch.data.loaders import SyntheticDataLoader
    from quant_tpu_torch.parallel import make_mesh
    from quant_tpu_torch.parallel.mesh import axis_index
    from quant_tpu_torch.parallel.multihost import shard_loader_for_host
    mesh = make_mesh(data=2, model=2, device_type='cpu')
    ring_mesh = make_mesh(data=1, model=4, device_type='cpu')
    d = axis_index(mesh, 'data')
    out: dict = {'coords': (d, axis_index(mesh, 'model')), 'steps': {}}
    out['ring'] = _ring_results(4, ring_mesh, axis_index(ring_mesh, 'model'))
    per = STEP_BATCH // 2
    for case in STEP_CASES:
        out['steps'][case] = tp_step(case, mesh, slice(d * per,
                                                        (d + 1) * per))
    data = SyntheticDataLoader(train_batch_size=8, test_batch_size=6,
                               train_size=32, test_size=10,
                               image_shape=(4, 4, 1), seed=3)
    out['rows'] = {
        part: [np.asarray(t).tolist() for _, t in shard_loader_for_host(
            loader, pad=part == 'test', mesh=mesh)]
        for part, loader in (('train', data.get_train_loader()),
                             ('test', data.get_test_loader()))}
    return out


def _worker() -> None:
    """One rank: python -c '...' <rank> <world> <port> <out> <inputs>."""
    rank, world, port = (int(a) for a in sys.argv[1:4])
    out, inputs = sys.argv[4], sys.argv[5]
    from quant_tpu_torch.parallel import multihost
    multihost.initialize(f'127.0.0.1:{port}', world, rank, device='cpu')
    if world == 2:
        result = _world2(rank, torch.load(inputs, weights_only=False),
                         str(Path(out).parent))
    else:
        result = _world4(rank)
    torch.save(result, out)


def run_world(tmp: Path, world: int, inputs: Path, module: str) -> list:
    """Spawn `world` ranks of `module`'s _worker; their results."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    outs = [tmp / f'rank{r}.pt' for r in range(world)]
    code = f'from tests.{module} import _worker; _worker()'
    procs = [subprocess.Popen(
        [sys.executable, '-c', code, str(r), str(world), str(port),
         str(outs[r]), str(inputs)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1'))
        for r in range(world)]
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
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope='module')
def jax_side():
    cases = {case: jax_forward_case(case) for case in FORWARD_CASES}
    return dict(cases=cases, rings={p: jax_rings(p) for p in (2, 4)})


@pytest.fixture(scope='module')
def tp1_run(tmp_path_factory):
    """The tp = 1 run in this process (its checkpoint restores at tp = 2
    in the world)."""
    from quant_tpu_torch.train.task import classification_task
    root = tmp_path_factory.mktemp('tp_task')
    metrics = classification_task(task_config(str(root), 'tp1', 1), root)
    return root, metrics


@pytest.fixture(scope='module')
def world2(jax_side, tp1_run):
    root, _ = tp1_run
    inputs = root / 'inputs.pt'
    torch.save({'trees': {c: v[0] for c, v in jax_side['cases'].items()},
                'x': {c: v[1] for c, v in jax_side['cases'].items()}},
               inputs)
    return run_world(root, 2, inputs, 'test_torch_port_tp')


@pytest.fixture(scope='module')
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('tp_world4')
    return run_world(tmp, 4, tmp / 'unused', 'test_torch_port_tp')


def test_placements_match_jax_leaf_for_leaf(jax_side, world2):
    for case, (tree, _, _) in jax_side['cases'].items():
        want = _leaves_of(jax_specs(tree))
        got = _leaves_of(world2[0]['specs'][case])
        assert got == want, case
        sharded = {k for k, v in got.items() if 'model' in v}
        assert any('w_packed' in k for k in sharded), case
        assert not any(k.split('/')[-1] in ('x_thresh', 'x_flip', 'x_va',
                                            'b_fold') for k in sharded)
    assert any('b_fold' in k for k in _leaves_of(
        world2[0]['specs']['bottleneck_folded']))


def test_place_and_gather_round_trip(jax_side, world2):
    """Each rank's placed leaves are its contiguous half of the sharded
    axis (the whole leaf where JAX replicates it), and gather rebuilds
    the tree on every rank."""
    for case, (tree, _, _) in jax_side['cases'].items():
        specs = _leaves_of(jax_specs(tree))
        want = _leaves(tree)
        for rank, r in enumerate(world2):
            local, full = (_leaves(t) for t in r['placed'][case])
            for path, leaf in want.items():
                np.testing.assert_array_equal(full[path], leaf)
                axis = [i for i, a in enumerate(specs[path]) if a == 'model']
                if not axis:
                    np.testing.assert_array_equal(local[path], leaf)
                    continue
                half = np.split(leaf, 2, axis=axis[0])[rank]
                assert local[path].flags['C_CONTIGUOUS'], path
                np.testing.assert_array_equal(local[path], half)


def _leaves_of(tree: dict, prefix: str = '') -> dict:
    if not isinstance(tree, dict):
        return {prefix: tuple(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_leaves_of(v, f'{prefix}/{k}'))
    return out


@pytest.mark.parametrize('p', [2, 4])
def test_rings_equal_jax_bit_for_bit(jax_side, world2, world4, p):
    want = jax_side['rings'][p]
    ops = ring_operands(p)
    np.testing.assert_array_equal(ops['xp'], want['xp'])
    np.testing.assert_array_equal(ops['wp'], want['wp'])
    dense = ops['x'] @ ops['w']
    np.testing.assert_array_equal(want['packed_True'], dense)
    nb = dense.shape[1] // p
    ranks = world2 if p == 2 else world4
    for rank, r in enumerate(ranks):
        for form in ('dense', 'packed'):
            np.testing.assert_array_equal(r['ring'][f'{form}_True'],
                                          want[f'{form}_True'])
            block = want[f'{form}_False'][:, rank * nb:(rank + 1) * nb]
            np.testing.assert_array_equal(r['ring'][f'{form}_False'], block)


@pytest.mark.parametrize('case', list(FORWARD_CASES))
def test_tp_forward_matches_jax_sharded(jax_side, world2, case):
    want = jax_side['cases'][case][2]
    tol = FOLDED_TOL if case in FOLDED else FORWARD_TOL
    for r in world2:
        np.testing.assert_allclose(r['forward'][case], want, **tol)


def _check_step(got: dict, want: dict, where: str) -> None:
    for part in ('grads', 'tree'):
        if part not in want:
            continue
        got_l, want_l = _leaves(got[part]), _leaves(want[part])
        assert set(got_l) == set(want_l), where
        for path, leaf in want_l.items():
            np.testing.assert_allclose(got_l[path], leaf, **STEP_TOL,
                                       err_msg=f'{where} {part} {path}')
    np.testing.assert_allclose(got['loss'], want['loss'], **STEP_TOL,
                               err_msg=where)
    for k, v in want.get('metrics', {}).items():
        np.testing.assert_allclose(got['metrics'][k], v, **STEP_TOL,
                                   err_msg=f'{where} {k}')


@pytest.mark.parametrize('case', list(STEP_CASES))
def test_tp_step_equals_single_process_step(world2, world4, case):
    """Mesh 1 x 2 on the whole batch and 2 x 2 on its halves, each rank
    against the port's single-process step on the whole batch."""
    want = one_step(case, slice(None))
    for mesh, ranks in (('1x2', world2), ('2x2', world4)):
        for rank, r in enumerate(ranks):
            _check_step(r['steps'][case], want, f'{mesh} rank {rank}')


@pytest.mark.parametrize('case', ['lenet', 'xnor_resnet'])
def test_tp_step_equals_jax_tp_step(world2, case):
    want = jax_tp_step(case)
    for rank, r in enumerate(world2):
        _check_step(r['steps'][case], want, f'jax, rank {rank}')


def test_summing_backward_would_differ(world2):
    """The library all-gather's backward sums the group's gradients: the
    sharded leaves' gradients come out doubled, far past the step's
    tolerance; the port's gather stays within it."""
    want = _leaves(one_step('lenet', slice(None))['grads'])
    for name, within in (('lenet_summing', False), ('lenet', True)):
        got = _leaves(world2[0]['steps'][name]['grads'])
        worst = max(float(np.abs(got[p] - want[p]).max()) for p in want)
        assert (worst < SUMMING_MIN_DIFF) == within, (name, worst)


def test_model_group_reads_the_same_rows(world4):
    by_coord = {r['coords']: r['rows'] for r in world4}
    assert sorted(by_coord) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for part in ('train', 'test'):
        for d in (0, 1):
            assert by_coord[(d, 0)][part] == by_coord[(d, 1)][part], part
        assert by_coord[(0, 0)][part] != by_coord[(1, 0)][part], part
    # The data coordinates share the batches out: 8 rows in 2 x 4.
    assert all(len(t) == 4 for t in by_coord[(0, 0)]['train'])


def test_task_tp2_matches_tp1_and_restores(tp1_run, world2):
    from quant_tpu_torch.train.task import classification_task
    root, (m1_train, m1_test) = tp1_run
    for rank, r in enumerate(world2):
        m2_train, m2_test = r['task']['tp2']
        np.testing.assert_allclose(m2_train[0]['Loss'], m1_train[0]['Loss'],
                                   rtol=TASK_RTOL, err_msg=f'rank {rank}')
        np.testing.assert_allclose(m2_test[0]['Loss'], m1_test[0]['Loss'],
                                   rtol=TASK_RTOL, err_msg=f'rank {rank}')
        # Resumed runs continue from the restored state: the first
        # epoch's loss falls below the from-scratch first epoch's.
        for restored in ('tp2_restored', 'tp1_at_tp2'):
            resumed = r['task'][restored][0][0]['Loss']
            assert np.isfinite(resumed)
            assert resumed <= m2_train[0]['Loss'] + 1e-3, restored
    # The tp = 2 checkpoint restores at tp = 1, in this process.
    resumed, _ = classification_task(
        task_config(str(root), 'tp2_at_tp1', 1), root,
        restore_experiment=root / 'tp2')
    np.testing.assert_allclose(
        resumed[0]['Loss'], world2[0]['task']['tp2_restored'][0][0]['Loss'],
        rtol=TASK_RTOL)


def test_checkpoint_layout_is_unsharded(tp1_run, world2):
    """The tp = 2 run's checkpoint holds the tp = 1 run's leaf shapes,
    the optimizer's moments included."""
    from quant_tpu_torch.utils.checkpoints import (
        get_path_to_checkpoint, restore_checkpoint,
    )
    root, _ = tp1_run
    one, two = (restore_checkpoint(get_path_to_checkpoint(root / name))
                for name in ('tp1', 'tp2'))
    for col in ('params', 'batch_stats', 'quant_state'):
        shapes = [{k: tuple(v.shape) for k, v in _leaves(c[col]).items()}
                  for c in (one, two)]
        assert shapes[0] == shapes[1], col
    for idx, st in one['opt_state']['state'].items():
        for k, v in st.items():
            assert tuple(v.shape) == tuple(two['opt_state']['state'][idx][
                k].shape), (idx, k)
