"""QAT training under 'space' in the port (parallel/spatial.py's train
form, global_stats over the bands, the banded QuantConv2d train form,
make_train_step over a mesh with a 'space' axis, evaluate, the banded
loaders) against the JAX package, on the CPU over gloo.

Two worlds are spawned once for the file, as tests/test_torch_port_tp.py
spawns its worlds: 2 ranks over mesh ('space',) and 4 over ('data' 2,
'space' 2). JAX runs in this process on the virtual CPU devices of
tests/conftest.py: its make_train_step (mesh None, jitted) on a batch
placed by `spatial_sharding`, which GSPMD partitions forward and
backward, its optimizer recording the gradients it is given. The
variables are the port's seeded models (probes.models.seed_state: BN
affines and statistics, weight scales, EMA scales as training leaves
them) as JAX trees (to_jax_variables), each rank's model loaded from the
tree by from_jax_variables; inputs come from a numpy seed. Each rank
steps on its band (local_band). Cases:

* a small XNOR ResNet (probes.models.small_config, width 8, one block a
  stage) with float activations into ls-1 weights at 64 px, where every
  block bands over 2 ranks, and at 56 px, where the map is gathered
  before layer2: loss, gradients, parameters, batch_stats and quant
  state against JAX's and the port's single-process step;
* the ls-1 x ls-1 XNOR ResNet with a banded KD teacher (a regular fp
  ResNet in train mode): against JAX's KD step and one process's;
* JAX's `_flagship(tiny=True)` (ls-2 activations, lloyd solves, bf16
  chain) against one process's at a bf16 tolerance (one process's
  flagship step against JAX's op-by-op step:
  tests/test_torch_port_spatial_train_bf16.py);
* LeNet-5, whose VALID conv1 gathers first: equal to one process's;
* a ('data' 2, 'space' 2) mesh at 128 px, the batch split over 'data':
  against JAX's placed step and one process's;
* the controls (a summing backward at the average pool, no 'space' sum
  of the banded parameters, band-local statistics, a remat step's
  recomputation without the banded state), each beyond 1e-3 of the
  gradient's largest;
* `evaluate` through the banded loaders against the unsharded model's;
* the port's one-process float32 step at 128 px and batch 8 against its
  float64 step (`python -m tests.test_torch_port_spatial_train` prints
  the witness of why JAX's float32 step differs there).
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import SPACE_CONTROL_OPTIONS, SPACE_CONTROLS, space_control
from tests.test_torch_port_dp import OPT_CONFIG, _grad_tree, _leaves
from tests.test_torch_port_tp import run_world

MODULE = 'test_torch_port_spatial_train'
BATCH = 4
# float32 against one process (the port's or JAX's): the band's sums are
# reduced in two parts, another float32 order. Loss relative, every
# gradient within GRAD_TOL of the largest gradient element, the new
# parameters, batch_stats and quant_state within STATE_TOL.
LOSS_RTOL = 2e-5
GRAD_TOL = 1e-5
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
# The bf16 chain of the flagship against one process: the bands' bf16
# weight gradients are rounded before their sum over 'space', the whole
# map's once (measured: 6.5e-3 of the largest gradient, the stem's
# kernel; the loss equal; batch_stats 2.4e-7).
BF16_GRAD_TOL = 2e-2
BF16_STATE_TOL = dict(rtol=1e-3, atol=1e-3)
# Each control moves a gradient by more than this share of the largest
# gradient element.
CONTROL_MIN_DIFF = 1e-3
_CLAMP = {'kind': 'symmetric', 'alpha': 2.0}
# __graft_entry__._flagship(tiny=True)'s constructor keywords.
FLAGSHIP_TINY = dict(
    block='xnor',
    layer0={'n_in_channels': 16, 'kernel_size': 7, 'stride': 2,
            'padding': 3, 'bias': False,
            'maxpool': {'type': 'maxpool2d', 'kernel_size': 3, 'stride': 2,
                        'padding': 1}},
    **{f'layer{i}': {'x_quant': 'ls-2', 'w_quant': 'ls-1', 'clamp': _CLAMP,
                     'double_shortcut': True} for i in range(1, 5)},
    nonlins=['prelu', 'prelu'], num_blocks=[2, 2, 2, 2], output_classes=16,
    solver_mode='lloyd', train_dtype='bfloat16')
KD = dict(temperature=1.0, teacher_correction=False)
# id: (model, x_quant, w_quant, px, teacher). 'small' is small_config's
# XNOR ResNet, 'lenet' its LeNet-5 (28 px), 'bottleneck' its
# regular_bottleneck ResNet in the CIFAR-100 recipe's shape
# (examples/cifar100/cifar100_resnet50_ls2_tpu.yaml: 3x3/s1 stem,
# identity pool, ReLU).
CASES = {
    'fp_ls1_64': ('small', 'fp', 'ls-1', 64, False),
    'fp_ls1_56': ('small', 'fp', 'ls-1', 56, False),
    'ls1_kd': ('small', 'ls-1', 'ls-1', 64, True),
    'flagship': ('flagship', 'ls-2', 'ls-1', 64, False),
    'lenet': ('lenet', 'fp', 'ls-1', 28, False),
    'fp_ls1_128': ('small', 'fp', 'ls-1', 128, False),
    'bottleneck_32': ('bottleneck', 'fp', 'ls-1', 32, False),
}
# The ('data' 2, 'space' 2) case, at 128 px on BATCH images (2 a 'data'
# coordinate): JAX's GSPMD on the CPU miscomputes a 3x3/s2 conv of a
# 4-row map split over 'space' when the batch is split over 'data' too
# (layer4's first conv at 64 px: 53 off in a conv output, 0.17% of the
# loss; at 80 and 96 px, whose bands reach odd row counts, 30% of the
# largest gradient), while its 'space'-only and 'data'-only placements
# equal its unsharded step. At 128 px every map keeps 4 rows or more a
# band. On 8 images JAX's float32 batch statistics put one BN output of
# layer1's first block across the clamp at -2 (`witness`): the port's
# float32 step sides with its float64 step there (WITNESS_ROWS).
DATA_SPACE = 'fp_ls1_128'
WITNESS_ROWS = 2 * BATCH
# The cases only tests/test_torch_port_spatial_remat.py steps.
REMAT_ONLY = ('bottleneck_32',)
SPACE_ONLY = [c for c in CASES if c not in (DATA_SPACE, *REMAT_ONLY)]
# The modules with parameters that run on bands at 2 bands: at 64 px all
# but the head; at 56 px the stem and layer1 (layer2's stride-2 conv
# sees 7 rows a band).
BANDED_56 = ('conv1', 'bn1', 'layer1_block0.')


# ------------------------------------------------------------ the models


def _family(case: str) -> str:
    kind = CASES[case][0]
    return 'lenet' if kind == 'lenet' else 'xnor'


def model_kwargs(case: str) -> dict:
    """The case's constructor keywords (the port's and JAX's)."""
    from quant_tpu_torch.probes.models import small_config
    kind, xq, wq, _, _ = CASES[case]
    if kind == 'flagship':
        return copy.deepcopy(FLAGSHIP_TINY)
    if kind == 'bottleneck':
        cfg = small_config('regular_bottleneck', xq, wq)
        cfg['layer0'].update(kernel_size=3, stride=1, padding=1,
                             maxpool={'type': 'identity'})
        cfg['nonlins'] = ['relu', 'relu']
        return cfg
    return small_config('lenet' if kind == 'lenet' else 'xnor', xq, wq)


def teacher_kwargs() -> dict:
    from quant_tpu_torch.probes.models import small_config
    return small_config('regular', 'fp', 'fp')


def inputs(case: str) -> tuple[np.ndarray, np.ndarray]:
    """Seeded (images, labels) of the case: WITNESS_ROWS rows (the
    steps take the first BATCH)."""
    kind, _, _, px, _ = CASES[case]
    c = 1 if kind == 'lenet' else 3
    rng = np.random.default_rng(px + 3)
    x = rng.standard_normal((WITNESS_ROWS, px, px, c)).astype(np.float32)
    classes = 16 if kind == 'flagship' else 10
    return x, rng.integers(0, classes, WITNESS_ROWS)


def seeded_tree(kwargs: dict, family: str, seed: int) -> dict:
    """A seeded port model (probes.models.seed_state) as a JAX tree."""
    from quant_tpu_torch.nn import QLeNet5, QResNet
    from quant_tpu_torch.probes.models import seed_state
    from quant_tpu_torch.utils.jax_import import to_jax_variables
    gen = torch.Generator().manual_seed(seed)
    cls = QLeNet5 if family == 'lenet' else QResNet
    model = cls(**copy.deepcopy(kwargs), device='cpu', generator=gen)
    seed_state(model, gen)
    return to_jax_variables(model)


def port_model(kwargs: dict, family: str, tree: dict,
               **extra: object) -> torch.nn.Module:
    from quant_tpu_torch.nn import QLeNet5, QResNet
    from quant_tpu_torch.utils.jax_import import from_jax_variables
    cls = QLeNet5 if family == 'lenet' else QResNet
    return from_jax_variables(cls(**copy.deepcopy(kwargs), device='cpu',
                                  **extra), tree)


# ---------------------------------------------------------- the port side


def port_step(case: str, trees: dict, mesh: object = None,
              rows: slice = slice(0, BATCH), batch_axis: object = None,
              **extra: object) -> dict:
    """One step of the case on rows of its batch; with a mesh, the model
    (and teacher) banded and this rank's band of them. The gradients and
    variables (JAX trees), loss, metrics, and for a banded model the
    collectives (forward and backward, and those of remat's
    recomputation apart) and the modules that ran on bands."""
    from quant_tpu_torch import train as T
    from quant_tpu_torch.parallel import band_model, local_band
    from quant_tpu_torch.train.kd import make_teacher_apply
    from quant_tpu_torch.train.metrics import init_metric_state
    from quant_tpu_torch.utils.jax_import import to_jax_variables
    family = _family(case)
    model = port_model(model_kwargs(case), family, trees[case], **extra)
    teacher_apply = None
    loss_fn = T.get_loss_fn('nll_loss' if family == 'lenet'
                            else 'cross_entropy')
    if CASES[case][4]:
        teacher = port_model(teacher_kwargs(), 'regular', trees['teacher'])
        if mesh is not None:
            band_model(teacher, mesh)
        teacher_apply = make_teacher_apply(teacher, train_mode=True)
        loss_fn = _kd_loss
    if mesh is not None:
        band_model(model, mesh)
    x, y = (torch.from_numpy(a) for a in inputs(case))
    x, y = x[rows], y[rows]
    if mesh is not None:
        x = local_band(x, mesh, batch_axis=batch_axis)
        if batch_axis is not None:
            from quant_tpu_torch.parallel.mesh import axis_index
            half = y.shape[0] // 2
            j = axis_index(mesh, batch_axis)
            y = y[j * half:(j + 1) * half]
    tx, _ = T.make_optimizer(OPT_CONFIG, 1, 1)
    state = T.TrainState.create(model, tx)
    step = T.make_train_step(loss_fn, teacher_apply, mesh=mesh)
    state, metric_state, loss = step(state, x, y, init_metric_state())
    out = dict(grads=_grad_tree(model), tree=to_jax_variables(model),
               loss=float(loss),
               metrics=T.MetricAccumulator(state=metric_state).compute())
    space = getattr(model, 'space', None)
    if space is not None:
        out['collectives'] = copy.deepcopy(space.collectives)
        out['recomputed'] = copy.deepcopy(space.recomputed)
        out['banded'] = [name for name, m in model.named_modules()
                         if id(m) in space.ran_banded]
    return out


def plain_grads(case: str, tree: dict, rows: slice,
                dtype: torch.dtype) -> tuple[float, dict]:
    """The loss and parameter gradients (leaves) of the case's unsharded
    model in train mode, in `dtype`, on rows of its batch (no teacher)."""
    from quant_tpu_torch import train as T
    model = port_model(model_kwargs(case), _family(case), tree).to(dtype)
    model.train()
    x, y = (torch.from_numpy(a[rows]) for a in inputs(case))
    loss = T.get_loss_fn('cross_entropy')(model(x.to(dtype)), y)
    loss.backward()
    return loss.item(), {k: v.astype(np.float64) for k, v in
                         _leaves(_grad_tree(model)).items()}


def _kd_loss(out: torch.Tensor, t_out: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
    from quant_tpu_torch.train.kd import kd_criterion
    return kd_criterion(out, t_out, target, **KD)


def _evaluate(case: str, trees: dict, mesh: object) -> dict:
    """evaluate of the case's model (eval mode, packed convs) on the
    first 8 images through shard_loader_for_host (banded with a mesh)."""
    from quant_tpu_torch import train as T
    from quant_tpu_torch.data.loaders import BatchIterable
    from quant_tpu_torch.parallel import band_model
    from quant_tpu_torch.parallel.multihost import shard_loader_for_host
    model = port_model(model_kwargs(case), 'xnor', trees[case])
    x, y = inputs(case)
    loader = BatchIterable(x, y, 4, shuffle=False)
    if mesh is not None:
        band_model(model, mesh)
        loader = shard_loader_for_host(loader, pad=True, mesh=mesh)
    tx, _ = T.make_optimizer(OPT_CONFIG, 1, 1)
    loss = T.get_loss_fn('cross_entropy')
    return T.evaluate(T.make_eval_step(loss, mesh=mesh),
                      T.TrainState.create(model, tx), loader)


def _world2(rank: int, trees: dict) -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    from quant_tpu_torch.data.loaders import BatchIterable
    from quant_tpu_torch.parallel.multihost import shard_loader_for_host
    mesh = DeviceMesh('cpu', torch.arange(2), mesh_dim_names=('space',))
    out: dict = {'steps': {}, 'controls': {}, 'single': {}}
    for case in SPACE_ONLY:
        out['steps'][case] = port_step(case, trees, mesh)
    for name in SPACE_CONTROLS:
        with space_control(name):
            out['controls'][name] = port_step(
                'fp_ls1_64', trees, mesh, **SPACE_CONTROL_OPTIONS.get(name,
                                                                      {}))
    out['evaluate'] = _evaluate('fp_ls1_64', trees, mesh)
    x, y = inputs('fp_ls1_64')
    out['loader'] = [(np.asarray(d), np.asarray(t)) for d, t in
                     shard_loader_for_host(BatchIterable(x, y, 4,
                                                         shuffle=False),
                                           mesh=mesh)]
    if rank == 0:  # one process's step, at this process's thread count
        for case in SPACE_ONLY:
            out['single'][case] = port_step(case, trees)
        out['single']['evaluate'] = _evaluate('fp_ls1_64', trees, None)
    return out


def _world4(rank: int, trees: dict) -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh('cpu', torch.arange(4).reshape(2, 2),
                      mesh_dim_names=('data', 'space'))
    out = {'step': port_step(DATA_SPACE, trees, mesh, batch_axis='data')}
    if rank == 0:
        out['single'] = port_step(DATA_SPACE, trees)
    return out


def _worker() -> None:
    """One rank: python -c '...' <rank> <world> <port> <out> <inputs>."""
    rank, world, port = (int(a) for a in sys.argv[1:4])
    from quant_tpu_torch.parallel import multihost
    multihost.initialize(f'127.0.0.1:{port}', world, rank, device='cpu')
    trees = torch.load(sys.argv[5], weights_only=False)
    result = _world2(rank, trees) if world == 2 else _world4(rank, trees)
    torch.save(result, sys.argv[4])


# ------------------------------------------------------------ the JAX side


def recording(tx: object) -> object:
    """An optax transformation that updates as `tx` does and keeps the
    gradients it was given in its state."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params: dict) -> tuple:
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads: dict, state: tuple, params: object = None) -> tuple:
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def jax_step(case: str, trees: dict, mesh_shape: tuple,
             n: int = BATCH, **extra: object) -> dict:
    """JAX's make_train_step (mesh None, jitted) on the case's first n
    rows placed by spatial_sharding over a ('data', 'space') mesh of
    mesh_shape (the batch over 'data'), the model built with the case's
    keywords and `extra` (e.g. remat=True): the gradients its optimizer
    was given, the tree after the step and the loss."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from quant_tpu.nn import QLeNet5, QResNet
    from quant_tpu.parallel.spatial import spatial_sharding
    from quant_tpu.train import engine as jengine
    from quant_tpu.train import kd as jkd
    from quant_tpu.train import losses as jlosses
    from quant_tpu.train import metrics as jmetrics
    from quant_tpu.train import optim as joptim
    from quant_tpu.train import state as jstate
    family = _family(case)
    jm = (QLeNet5 if family == 'lenet' else QResNet)(**model_kwargs(case),
                                                     **extra)
    variables = trees[case]
    d, p = mesh_shape
    mesh = Mesh(np.asarray(jax.devices()[:d * p]).reshape(d, p),
                ('data', 'space'))
    x, y = inputs(case)
    xs = jax.device_put(jnp.asarray(x[:n]), spatial_sharding(
        mesh, batch_axis='data'))
    ys = jnp.asarray(y[:n])
    loss_fn = jlosses.get_loss_fn('cross_entropy')
    teacher_apply = None
    if CASES[case][4]:
        jt = QResNet(**teacher_kwargs())

        def teacher_apply(data: jax.Array) -> jax.Array:
            out, _ = jt.apply(trees['teacher'], data, True,
                              mutable=['batch_stats', 'quant_state'])
            return jax.lax.stop_gradient(out)

        def loss_fn(out: jax.Array, t_out: jax.Array,
                    target: jax.Array) -> jax.Array:
            return jkd.kd_criterion(out, t_out, target, **KD)

    tx, _ = joptim.make_optimizer(OPT_CONFIG, 1, 1)
    jst = jstate.TrainState.create(jm.apply, variables, recording(tx))
    jst, _, loss = jengine.make_train_step(
        loss_fn, teacher_apply, donate=False)(
        jst, xs, ys, jmetrics.init_metric_state())
    tree = {'params': jst.params, 'batch_stats': jst.batch_stats,
            'quant_state': jst.quant_state}
    return dict(grads=jax.tree_util.tree_map(np.asarray, jst.opt_state[1]),
                tree=jax.tree_util.tree_map(np.asarray, tree),
                loss=float(loss))


@pytest.fixture(scope='module')
def trees(tmp_path_factory) -> tuple[dict, Path]:
    """The initial variables of every case (and the KD teacher), and the
    file the worlds read them from."""
    tmp = tmp_path_factory.mktemp('space_train')
    out = {case: seeded_tree(model_kwargs(case), _family(case), seed)
           for seed, case in enumerate(CASES)}
    out['teacher'] = seeded_tree(teacher_kwargs(), 'regular', 99)
    path = tmp / 'trees.pt'
    torch.save(out, path)
    return out, path


@pytest.fixture(scope='module')
def world2(trees, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('space_world2')
    return run_world(tmp, 2, trees[1], MODULE)


@pytest.fixture(scope='module')
def world4(trees, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('space_world4')
    return run_world(tmp, 4, trees[1], MODULE)


@pytest.fixture(scope='module')
def jax_steps(trees):
    out = {case: jax_step(case, trees[0], (1, 2))
           for case in SPACE_ONLY if case not in ('lenet', 'flagship')}
    out['data_space'] = jax_step(DATA_SPACE, trees[0], (2, 2))
    return out


# ------------------------------------------------------------ the checks


def _worst(got: dict, want: dict) -> float:
    """The largest gradient difference, as a share of the largest
    gradient element."""
    largest = max(float(np.abs(w).max(initial=0.0)) for w in want.values())
    return max(float(np.abs(got[p] - w).max(initial=0.0))
               for p, w in want.items()) / largest


def check_step(got: dict, want: dict, where: str) -> None:
    """A float32 step against one process's (module constants)."""
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_RTOL,
                               err_msg=where)
    g, w = _leaves(got['grads']), _leaves(want['grads'])
    assert set(g) == set(w), where
    largest = max(float(np.abs(leaf).max(initial=0.0)) for leaf in w.values())
    for path, leaf in w.items():
        err = float(np.abs(g[path] - leaf).max(initial=0.0))
        assert err <= GRAD_TOL * largest, (where, path, err, largest)
    g, w = _leaves(got['tree']), _leaves(want['tree'])
    assert set(g) == set(w), where
    for path, leaf in w.items():
        np.testing.assert_allclose(g[path], leaf, **STATE_TOL,
                                   err_msg=f'{where} {path}')


def check_bf16(got: dict, want: dict, where: str) -> None:
    """The flagship's bf16 step against one process's (BF16_*)."""
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_RTOL,
                               err_msg=where)
    g, w = _leaves(got['grads']), _leaves(want['grads'])
    assert _worst(g, w) <= BF16_GRAD_TOL, where
    g, w = _leaves(got['tree']), _leaves(want['tree'])
    for path, leaf in w.items():
        np.testing.assert_allclose(g[path], leaf, **BF16_STATE_TOL,
                                   err_msg=f'{where} {path}')


@pytest.mark.parametrize('case', ['fp_ls1_64', 'fp_ls1_56'])
def test_float_activation_step_matches_jax_and_one_process(
        world2, jax_steps, case):
    for rank, r in enumerate(world2):
        check_step(r['steps'][case], jax_steps[case], f'jax, rank {rank}')
        check_step(r['steps'][case], world2[0]['single'][case],
                   f'one process, rank {rank}')


def test_data_space_step_matches_jax_and_one_process(world4, jax_steps):
    """Mesh ('data' 2, 'space' 2), each rank on its band of its half of
    the batch, against the step on the whole batch."""
    single = world4[0]['single']
    for rank, r in enumerate(world4):
        check_step(r['step'], jax_steps['data_space'], f'jax, rank {rank}')
        check_step(r['step'], single, f'one process, rank {rank}')
    assert 'layer4_block0.conv1' in world4[0]['step']['banded']


def test_kd_step_with_a_banded_teacher_matches_jax(world2, jax_steps):
    """The ls-1 x ls-1 student with the KD teacher banded like it (BN
    train statistics over 'space', the pool on bands under no gradient):
    JAX's KD step on the placed batch, and one process's."""
    single = world2[0]['single']['ls1_kd']
    for rank, r in enumerate(world2):
        check_step(r['steps']['ls1_kd'], jax_steps['ls1_kd'],
                   f'jax, rank {rank}')
        check_step(r['steps']['ls1_kd'], single, f'one process, rank {rank}')


def test_flagship_tiny_step_matches_jax_in_bf16(world2):
    """JAX's _flagship(tiny=True): ls-2 activations with lloyd solves on
    the gathered sample, the bf16 chain, against one process's step;
    tests/test_torch_port_spatial_train_bf16.py holds that step to JAX's
    op-by-op step (JAX's jitted bf16 chain is another program)."""
    import __graft_entry__
    from quant_tpu.nn import QResNet
    assert QResNet(**FLAGSHIP_TINY) == __graft_entry__._flagship(tiny=True)
    single = world2[0]['single']['flagship']
    for rank, r in enumerate(world2):
        check_bf16(r['steps']['flagship'], single, f'one process, {rank}')


def test_lenet_runs_whole_and_equals_one_process(world2):
    """LeNet-5's VALID conv1 gathers the bands first: nothing runs on
    bands, nothing is summed over 'space', and each rank's step is one
    process's, bit for bit (the same ops on the same images)."""
    want = world2[0]['single']['lenet']
    for r in world2:
        got = r['steps']['lenet']
        assert got['banded'] == []
        assert got['loss'] == want['loss']
        for part in ('grads', 'tree'):
            g, w = _leaves(got[part]), _leaves(want[part])
            for path, leaf in w.items():
                np.testing.assert_array_equal(g[path], leaf, err_msg=path)


@pytest.mark.parametrize('case', [c for c in SPACE_ONLY if c != 'lenet'])
def test_ranks_hold_equal_variables_after_a_step(world2, case):
    a, b = (_leaves(r['steps'][case]['tree']) for r in world2)
    for path, leaf in a.items():
        np.testing.assert_array_equal(b[path], leaf, err_msg=path)
    assert world2[0]['steps'][case]['loss'] == world2[1]['steps'][case][
        'loss']


@pytest.mark.parametrize('case', ['fp_ls1_64', 'fp_ls1_56'])
def test_modules_that_ran_on_bands(world2, case):
    """At 64 px every module with parameters but the head runs on bands;
    at 56 px the stem and layer1 (the map is gathered before layer2)."""
    got = world2[0]['steps'][case]['banded']
    assert got == world2[1]['steps'][case]['banded']
    assert 'fc' not in got and 'conv1' in got
    if case == 'fp_ls1_64':
        assert any(n.startswith('layer4_block0.') for n in got)
    else:
        assert all(n.startswith(BANDED_56) for n in got), got
        assert any(n.startswith('layer1_block0.') for n in got)
    kinds = world2[0]['steps'][case]['collectives']
    for kind in ('halo', 'statistics', 'gradient sum'):
        assert kinds.get(kind, [0])[0] > 0, (kind, kinds)
    # The map is gathered (56 px) or the average pool reduces the bands.
    assert ('gather' in kinds) == (case == 'fp_ls1_56')
    assert ('average pool' in kinds) == (case == 'fp_ls1_64')


@pytest.mark.parametrize('name', SPACE_CONTROLS)
def test_controls_differ(world2, name):
    """Each rule replaced by its plausible wrong form moves a gradient
    beyond CONTROL_MIN_DIFF of the largest; the port's step stays within
    GRAD_TOL."""
    want = _leaves(world2[0]['single']['fp_ls1_64']['grads'])
    got = _leaves(world2[0]['controls'][name]['grads'])
    assert _worst(got, want) > CONTROL_MIN_DIFF
    ok = _leaves(world2[0]['steps']['fp_ls1_64']['grads'])
    assert _worst(ok, want) <= GRAD_TOL


def test_float32_step_sides_with_float64(trees):
    """The port's one-process float32 step of the ('data', 'space') case's
    model at 128 px on WITNESS_ROWS images against its float64 step:
    LOSS_RTOL, every gradient within GRAD_TOL of the largest. JAX's
    float32 step is not (witness)."""
    rows = slice(0, WITNESS_ROWS)
    tree = trees[0][DATA_SPACE]
    loss32, got = plain_grads(DATA_SPACE, tree, rows, torch.float32)
    loss64, want = plain_grads(DATA_SPACE, tree, rows, torch.float64)
    np.testing.assert_allclose(loss32, loss64, rtol=LOSS_RTOL)
    assert _worst(got, want) <= GRAD_TOL


def witness() -> dict:
    """Why JAX's float32 step of the ('data', 'space') case's model at
    128 px on WITNESS_ROWS images differs from the port's: the gradients'
    largest difference (a share of the largest) of the port's float32
    step and of JAX's (unsharded, and placed over ('data' 2, 'space' 2))
    against the port's float64 step; the BN outputs of layer1's first
    block that fall on the other side of the clamp's -alpha..alpha in
    JAX than in float64 (float64, port float32, JAX float32); and the
    float32 batch variance's error of such a channel, torch's and XLA's
    mean over its 8192 values against float64's."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from quant_tpu.nn import QResNet
    case, rows = DATA_SPACE, slice(0, WITNESS_ROWS)
    tree = seeded_tree(model_kwargs(case), 'xnor', list(CASES).index(case))
    trees = {case: tree}
    _, p32 = plain_grads(case, tree, rows, torch.float32)
    _, p64 = plain_grads(case, tree, rows, torch.float64)
    out = {'port float32': _worst(p32, p64)}
    for name, shape in (('jax unsharded', (1, 1)), ('jax placed', (2, 2))):
        got = _leaves(jax_step(case, trees, shape, WITNESS_ROWS)['grads'])
        out[name] = _worst(got, p64)
    x = inputs(case)[0][rows]
    seen: dict = {}

    def capture(nxt, args, kwargs, ctx):
        y = nxt(*args, **kwargs)
        if (ctx.method_name == '__call__'
                and ctx.module.path == ('layer1_block0', 'bn1')):
            seen['in'], seen['out'] = args[0], y
        return y
    with fnn.intercept_methods(capture):
        QResNet(**model_kwargs(case)).apply(
            tree, jnp.asarray(x), True, mutable=['batch_stats',
                                                 'quant_state'])
    jax_in, jax_out = np.asarray(seen['in']), np.asarray(seen['out'])
    port: dict = {}
    for dtype in (torch.float32, torch.float64):
        model = port_model(model_kwargs(case), 'xnor', tree).to(dtype)
        model.train()
        hook = model.layer1_block0.bn1.register_forward_hook(
            lambda m, a, y, dtype=dtype: port.__setitem__(
                dtype, y.detach().numpy()))
        model(torch.from_numpy(x).to(dtype))
        hook.remove()
    alpha = _CLAMP['alpha']
    inside64 = np.abs(port[torch.float64]) <= alpha
    crossed = np.argwhere(inside64 != (np.abs(jax_out) <= alpha))
    out['crossed'] = [(tuple(int(i) for i in at),
                       float(port[torch.float64][tuple(at)]),
                       float(port[torch.float32][tuple(at)]),
                       float(jax_out[tuple(at)])) for at in crossed]
    for channel in sorted({int(at[-1]) for at in crossed}):
        v = np.array(jax_in[..., channel])
        exact = v.astype(np.float64).var()
        t = torch.from_numpy(v)
        t_var = float((t * t).mean() - t.mean() ** 2)
        j_var = float(jax.jit(lambda a: jnp.mean(a * a) - jnp.mean(a) ** 2)(
            jnp.asarray(v)))
        out[f'variance of channel {channel}'] = dict(
            float64=exact, torch_err=t_var - exact, xla_err=j_var - exact)
    return out


def test_evaluate_under_space_equals_unsharded(world2):
    want = world2[0]['single']['evaluate']
    for r in world2:
        for k, v in want.items():
            np.testing.assert_allclose(r['evaluate'][k], v, rtol=1e-6,
                                       err_msg=k)


def test_space_ranks_read_the_same_rows_and_take_their_band(world2):
    x, y = inputs('fp_ls1_64')
    for rank, r in enumerate(world2):
        assert len(r['loader']) == 2
        for i, (data, target) in enumerate(r['loader']):
            np.testing.assert_array_equal(target, y[4 * i:4 * (i + 1)])
            np.testing.assert_array_equal(
                data, x[4 * i:4 * (i + 1), 32 * rank:32 * (rank + 1)])
            assert data.flags['C_CONTIGUOUS']


if __name__ == '__main__':
    import importlib
    importlib.import_module('tests.conftest')  # JAX on 8 CPU devices
    for key, value in witness().items():
        print(f'{key}: {value}')
