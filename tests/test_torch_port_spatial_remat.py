"""`remat` under 'space' in the port (nn.resnet.remat_block recomputing a
banded block in the backward pass under parallel.spatial.recompute)
against the JAX package, on the CPU over gloo.

The models, seeded trees, inputs and tolerances are
tests/test_torch_port_spatial_train.py's. Two worlds are spawned once
for the file (run_world of tests/test_torch_port_tp.py, with its
PROCESS_TIMEOUT, so a deadlock fails a test instead of hanging the
suite): 2 ranks over mesh ('space',) and 4 over ('data' 2, 'space' 2).
JAX's side is its make_train_step on a batch placed by
`spatial_sharding`, the model built with `remat=True` (`nn.remat` of
each block, which GSPMD partitions like the rest of the step). Cases:

* the small XNOR ResNet with float activations into ls-1 weights at 64
  px (every block on bands) with remat: against JAX's placed remat step,
  and equal bit for bit to the port's banded step without remat;
* the ls-1 x ls-1 student with remat and its banded KD teacher, against
  JAX's KD step with remat;
* the flagship (ls-2, lloyd, bf16) with remat: equal bit for bit to the
  banded step without remat, within the bf16 tolerance of one process's
  remat step;
* a small regular_bottleneck ResNet in the CIFAR-100 recipe's shape
  (3x3/s1 stem, identity pool, 32 px, one block a stage), float
  activations into ls-1 weights, float32, with remat: against JAX's;
* the ('data' 2, 'space' 2) case at 128 px on 4 images with remat,
  against JAX's placed remat step;
* the remat_unbanded control (the recomputation on its bands without
  the statistics' 'space' state): beyond 1e-3 of the largest gradient;
  and without any of the banded state the recomputation fails torch's
  checkpoint check (a halo conv's saved input changes shape), on every
  rank alike;
* the recomputation's collectives, counted on each rank by kind: equal
  across ranks, and the step's other collectives those of the step
  without remat.
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import SPACE_CONTROL_OPTIONS, space_control
from tests.test_torch_port_dp import _leaves
from tests.test_torch_port_spatial_train import (
    CASES, CONTROL_MIN_DIFF, DATA_SPACE, GRAD_TOL,
    _family, _worst, check_bf16, check_step, jax_step, model_kwargs,
    port_step, seeded_tree, teacher_kwargs,
)
from tests.test_torch_port_tp import run_world

MODULE = 'test_torch_port_spatial_remat'
CONTROL = 'remat_unbanded'
# The 'space' cases stepped with remat; against JAX's placed remat step
# (float32) or one process's remat step (the flagship's bf16 chain).
REMAT_CASES = ('fp_ls1_64', 'ls1_kd', 'flagship', 'bottleneck_32')
JAX_CASES = ('fp_ls1_64', 'ls1_kd', 'bottleneck_32')
# The cases also stepped banded without remat, for the bit-for-bit check.
EXACT_CASES = ('fp_ls1_64', 'flagship')
TREE_CASES = (*REMAT_CASES, DATA_SPACE)


def _world2(rank: int, trees: dict) -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh('cpu', torch.arange(2), mesh_dim_names=('space',))
    out: dict = {'remat': {}, 'plain': {}}
    for case in REMAT_CASES:
        out['remat'][case] = port_step(case, trees, mesh, remat=True)
    for case in EXACT_CASES:
        out['plain'][case] = port_step(case, trees, mesh)
    with space_control(CONTROL):
        out['control'] = port_step('fp_ls1_64', trees, mesh,
                                   **SPACE_CONTROL_OPTIONS[CONTROL])
    if rank == 0:  # one process's remat step of the bf16 chain
        out['single'] = port_step('flagship', trees, remat=True)
    out['unrestored'] = _unrestored(trees, mesh)
    return out


def _unrestored(trees: dict, mesh: object) -> str:
    """The error of a banded remat step whose recomputation takes none of
    the banded state (spatial.recompute left out), '' if none."""
    from torch.utils.checkpoint import CheckpointError
    from quant_tpu_torch.parallel import spatial
    saved = spatial.recompute
    spatial.recompute = lambda space, banded: contextlib.nullcontext()
    try:
        port_step('fp_ls1_64', trees, mesh, remat=True)
    except CheckpointError as e:
        return str(e)
    finally:
        spatial.recompute = saved
    return ''


def _world4(rank: int, trees: dict) -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh('cpu', torch.arange(4).reshape(2, 2),
                      mesh_dim_names=('data', 'space'))
    return {'step': port_step(DATA_SPACE, trees, mesh, batch_axis='data',
                              remat=True)}


def _worker() -> None:
    """One rank: python -c '...' <rank> <world> <port> <out> <inputs>."""
    rank, world, port = (int(a) for a in sys.argv[1:4])
    from quant_tpu_torch.parallel import multihost
    multihost.initialize(f'127.0.0.1:{port}', world, rank, device='cpu')
    trees = torch.load(sys.argv[5], weights_only=False)
    result = _world2(rank, trees) if world == 2 else _world4(rank, trees)
    torch.save(result, sys.argv[4])


@pytest.fixture(scope='module')
def trees(tmp_path_factory) -> tuple[dict, Path]:
    """The cases' initial variables (each seeded as in
    tests/test_torch_port_spatial_train.py) and the KD teacher's, and
    the file the worlds read them from."""
    seeds = {case: seed for seed, case in enumerate(CASES)}
    out = {case: seeded_tree(model_kwargs(case), _family(case), seeds[case])
           for case in TREE_CASES}
    out['teacher'] = seeded_tree(teacher_kwargs(), 'regular', 99)
    path = tmp_path_factory.mktemp('space_remat') / 'trees.pt'
    torch.save(out, path)
    return out, path


@pytest.fixture(scope='module')
def world2(trees, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp('remat_world2'), 2, trees[1],
                     MODULE)


@pytest.fixture(scope='module')
def world4(trees, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp('remat_world4'), 4, trees[1],
                     MODULE)


@pytest.fixture(scope='module')
def jax_steps(trees):
    out = {case: jax_step(case, trees[0], (1, 2), remat=True)
           for case in JAX_CASES}
    out[DATA_SPACE] = jax_step(DATA_SPACE, trees[0], (2, 2), remat=True)
    return out


def _assert_equal(got: dict, want: dict, where: str) -> None:
    """Loss, gradients and variables bit for bit."""
    assert got['loss'] == want['loss'], where
    for part in ('grads', 'tree'):
        g, w = _leaves(got[part]), _leaves(want[part])
        assert set(g) == set(w), where
        for path, leaf in w.items():
            np.testing.assert_array_equal(g[path], leaf,
                                          err_msg=f'{where} {path}')


@pytest.mark.parametrize('case', ['fp_ls1_64', 'bottleneck_32'])
def test_float_activation_remat_step_matches_jax(world2, jax_steps, case):
    """The XNOR and regular_bottleneck families (float activations into
    ls-1 weights, float32) with remat, every block on bands: JAX's placed
    remat step at LOSS_RTOL / GRAD_TOL / STATE_TOL on every rank."""
    for rank, r in enumerate(world2):
        check_step(r['remat'][case], jax_steps[case], f'jax, rank {rank}')
    assert 'layer4_block0.conv1' in world2[0]['remat'][case]['banded']


def test_kd_remat_step_with_a_banded_teacher_matches_jax(world2, jax_steps):
    """The ls-1 x ls-1 student with remat, the KD teacher banded and not
    rematerialized (it runs without a gradient): JAX's KD remat step."""
    for rank, r in enumerate(world2):
        check_step(r['remat']['ls1_kd'], jax_steps['ls1_kd'],
                   f'jax, rank {rank}')


@pytest.mark.parametrize('case', EXACT_CASES)
def test_remat_step_equals_the_banded_step_bit_for_bit(world2, case):
    """The recomputation runs the same ops on the same bands as the
    forward: the loss, every gradient and the new variables equal the
    banded step without remat, bit for bit, on each rank; the same
    modules ran on bands."""
    for rank, r in enumerate(world2):
        _assert_equal(r['remat'][case], r['plain'][case], f'rank {rank}')
        assert r['remat'][case]['banded'] == r['plain'][case]['banded']


def test_flagship_remat_step_within_bf16_of_one_process(world2):
    """The flagship's bf16 chain (ls-2 lloyd solves on the gathered
    sample) with remat against one process's remat step: BF16_GRAD_TOL
    (tests/test_torch_port_spatial_train_bf16.py holds one process's step
    to JAX's op-by-op step)."""
    single = world2[0]['single']
    for rank, r in enumerate(world2):
        check_bf16(r['remat']['flagship'], single, f'one process, {rank}')


def test_data_space_remat_step_matches_jax(world4, jax_steps):
    """Mesh ('data' 2, 'space' 2) at 128 px on BATCH images with remat:
    each rank's step is JAX's placed remat step."""
    for rank, r in enumerate(world4):
        check_step(r['step'], jax_steps[DATA_SPACE], f'jax, rank {rank}')
    assert 'layer4_block0.conv1' in world4[0]['step']['banded']
    assert world4[0]['step']['recomputed']['halo'][0] > 0


@pytest.mark.parametrize('case', REMAT_CASES)
def test_ranks_hold_equal_variables_after_a_remat_step(world2, case):
    a, b = (r['remat'][case] for r in world2)
    assert a['loss'] == b['loss']
    ta, tb = _leaves(a['tree']), _leaves(b['tree'])
    for path, leaf in ta.items():
        np.testing.assert_array_equal(tb[path], leaf, err_msg=path)


def test_remat_unbanded_control_differs(world2, jax_steps):
    """The recomputation on its bands without the statistics' 'space'
    state (band-local statistics in the recomputation alone, the forward
    sound) moves a gradient beyond CONTROL_MIN_DIFF of the largest; the
    port's remat step stays within GRAD_TOL of JAX's."""
    want = _leaves(jax_steps['fp_ls1_64']['grads'])
    for r in world2:
        assert _worst(_leaves(r['control']['grads']), want) > CONTROL_MIN_DIFF
        assert _worst(_leaves(r['remat']['fp_ls1_64']['grads']),
                      want) <= GRAD_TOL


@pytest.mark.parametrize('case', REMAT_CASES)
def test_recomputed_collectives_equal_across_ranks(world2, case):
    """Each rank counts the collectives of its recomputation by kind:
    every rank took part in the same number of each (a rank that stopped
    early or skipped one would deadlock gloo or pair the wrong messages);
    the halos, statistics and, for binary activations, the solves are
    re-issued; the forward's and backward's collectives are the step's
    without remat."""
    recs = [r['remat'][case]['recomputed'] for r in world2]
    counts = [{kind: n for kind, (n, _) in rec.items()} for rec in recs]
    assert counts[0] == counts[1]
    want = {'halo', 'statistics'} | (
        {'solves'} if CASES[case][1] != 'fp' else set())
    assert set(counts[0]) == want, counts[0]
    if case in EXACT_CASES:
        for r in world2:
            assert r['remat'][case]['collectives'] == r['plain'][case][
                'collectives']
            assert r['plain'][case]['recomputed'] == {}


def test_recompute_puts_the_backward_state_back():
    """spatial.recompute enters the block's banded state and the 'space'
    statistics, and puts back what it found, also when the body raises;
    collectives inside are counted apart."""
    import types
    from quant_tpu_torch.parallel import global_stats, spatial
    space = spatial.SpatialParallel.__new__(spatial.SpatialParallel)
    space.banded, space.recomputing = False, False
    space.collectives, space.recomputed = {}, {}
    space.group = types.SimpleNamespace()
    with pytest.raises(RuntimeError):
        with spatial.recompute(space, True):
            assert space.banded and global_stats.current_space() is space
            assert global_stats.groups() == (space.group,)
            space.tally('halo', torch.zeros(3))
            raise RuntimeError('stopped')
    assert not space.banded and not space.recomputing
    assert global_stats.current_space() is None
    assert space.recomputed == {'halo': [1, 12]} and space.collectives == {}


def test_recomputation_without_the_banded_state_fails_loudly(world2):
    """Recomputed with none of the banded state (no halos, band-local
    statistics and solves), a halo conv's saved input has fewer rows than
    the forward's: torch's checkpoint refuses the recomputed tensors on
    every rank alike, before a gradient is formed."""
    for r in world2:
        assert 'different metadata' in r['unrestored'], r['unrestored']


def test_train_profile_build_overrides_the_config_options():
    """train_profile.build's overrides replace the configuration's student
    options (the banded profile's --remat); the rest stays the recipe's."""
    from quant_tpu_torch.probes import models, train_profile

    def make(family: str):
        return lambda xq, wq, **kw: models.build(
            family, models.small_config(family, xq, wq), **kw)
    for remat in (True, False):
        student, teacher = train_profile.build(
            'ls2_ls1_kd_tpu', 0, 'cpu', make('xnor'), make('regular'),
            remat=remat)
        assert student.remat is remat
        assert student.train_dtype == teacher.train_dtype == torch.bfloat16
        assert student.layer1_block0.conv1.x_quantizer.solver_mode == 'lloyd'
