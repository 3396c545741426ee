"""Pipeline parallelism in the port (parallel/pipeline.py) against the
JAX package, on the CPU over gloo.

One world of 4 ranks is spawned once for the file, as
tests/test_torch_port_tp.py spawns its worlds, over the meshes ('pipe'
4) and ('data' 2, 'pipe' 2); JAX runs in this process on the virtual CPU
devices of tests/conftest.py. Against JAX's `pipeline_apply` (jitted)
and the sequential composition, JAX's cases of
tests/parallel/test_pipeline.py:

* the forward of the tanh MLP stages (S = 4, M = 6);
* M in {1, 2, 7} at S = 2;
* the stacked parameters' gradients against `jax.grad` through JAX's
  pipeline (the reverse schedule; S = 4, M = 5), every rank holding the
  whole gradient, and the microbatches' gradient;
* the summing backward of the replicating all-reduce (the control)
  lands beyond 1e-3;
* the quantized stage (ls-1 activations and weights, a 3x3 conv, x +
  tanh);
* the 'leading dim' errors (k x S, S / k, ragged);
* dp x pp: each 'data' coordinate pipelines its own microbatch rows;
* packed XnorBasicBlock stages (torch.func.functional_call over each
  block's parameters and buffers) equal to the blocks in sequence.
"""

import sys

import numpy as np
import pytest
import torch

from tests.test_torch_port_tp import run_world

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)        # JAX's forward tolerance
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)   # JAX's gradient tolerance
SUMMING_MIN_DIFF = 1e-3
MANY = (1, 2, 7)


def _stages(seed: int, s: int, d: int) -> dict:
    """JAX's _random_stages as numpy: {'w': (s, d, d), 'b': (s, d)}."""
    rng = np.random.default_rng(seed)
    return {'w': (rng.standard_normal((s, d, d)) / np.sqrt(d)).astype(
                np.float32),
            'b': (rng.standard_normal((s, d)) * 0.1).astype(np.float32)}


def _mb(seed: int, shape: tuple) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _quant_inputs() -> tuple:
    rng = np.random.default_rng(21)
    w = (rng.standard_normal((4, 3, 3, 4, 4)) * 0.2).astype(np.float32)
    return w, rng.standard_normal((4, 2, 8, 8, 4)).astype(np.float32)


# ---------------------------------------------------------- the world


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ p['w'] + p['b'])


def _quant_stage(p: dict, x: torch.Tensor) -> torch.Tensor:
    from quant_tpu_torch.ops.conv import conv2d
    from quant_tpu_torch.ops.quantize import quantizer_ls_1
    n, c = x.shape[0], x.shape[-1]
    xq = quantizer_ls_1(x.reshape(n, -1))[1].reshape(x.shape)
    wq = quantizer_ls_1(p['w'].reshape(c, -1))[1].reshape(p['w'].shape)
    return x + torch.tanh(conv2d(xq, wq, stride=1, padding=1))


def _tensors(tree: dict, grad: bool = False) -> dict:
    return {k: torch.tensor(v, requires_grad=grad) for k, v in tree.items()}


def _grads(mesh, summing: bool = False) -> dict:
    from quant_tpu_torch.parallel import pipeline, pipeline_apply
    params = _tensors(_stages(3, 4, 8), grad=True)
    mb = torch.tensor(_mb(4, (5, 3, 8)), requires_grad=True)

    def all_reduced(g: torch.Tensor, pipe: object) -> torch.Tensor:
        g = g.clone()
        torch.distributed.all_reduce(g, group=pipe.group)
        return g

    saved = pipeline._replicated_grad
    if summing:
        pipeline._replicated_grad = all_reduced
    try:
        (pipeline_apply(_mlp, params, mb, mesh=mesh) ** 2).sum().backward()
    finally:
        pipeline._replicated_grad = saved
    return {**{k: v.grad.numpy() for k, v in params.items()},
            'mb': mb.grad.numpy()}


def _packed_blocks(stages: int) -> tuple:
    """A small XNOR ResNet's layer1 of `stages` blocks (packed,
    threshold-folded, stripped) and a seeded layer1 input."""
    from quant_tpu_torch.probes import models

    def make(x_quant: str, w_quant: str, **kw) -> torch.nn.Module:
        config = models.small_config('xnor', x_quant, w_quant)
        return models.build('xnor', {**config,
                                     'num_blocks': [stages, 1, 1, 1]}, **kw)
    model = models.seeded_model(make, 'ls-1', 'ls-1', 'cpu', seed=6)
    blocks = [b for n, b in model.blocks() if n.startswith('layer1_')]
    x = torch.from_numpy(_mb(7, (4, 2, 8, 8, 8))).to(torch.bfloat16)
    return blocks, x, model.bn_fold


def _packed(mesh, stages: int) -> dict:
    from chip_smoke import tail_calls
    from quant_tpu_torch import _build
    from quant_tpu_torch.parallel import pipeline_apply, stack_stage_params
    blocks, x, fold = _packed_blocks(stages)
    params = stack_stage_params([
        {k: v.detach() for k, v in (*b.named_parameters(),
                                     *b.named_buffers())} for b in blocks])

    def stage(p: dict, xb: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(blocks[0], p,
                                          (xb, torch.bfloat16, fold))
    before = _build.launch_counts()
    with tail_calls() as tails, torch.no_grad():
        out = pipeline_apply(stage, params, x, mesh=mesh)
    return dict(out=out.float().numpy(),
                launched=_build.launch_counts() != before, tails=tails[0])


def _world4(rank: int) -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    from quant_tpu_torch.parallel import pipeline_apply
    pipe4 = DeviceMesh('cpu', torch.arange(WORLD), mesh_dim_names=('pipe',))
    dp_pp = DeviceMesh('cpu', torch.arange(WORLD).reshape(2, 2),
                       mesh_dim_names=('data', 'pipe'))
    out: dict = {'many': {}, 'errors': []}
    with torch.no_grad():
        out['forward'] = pipeline_apply(
            _mlp, _tensors(_stages(1, 4, 8)), torch.from_numpy(
                _mb(2, (6, 3, 8))), mesh=pipe4).numpy()
        for m in MANY:
            out['many'][m] = pipeline_apply(
                _mlp, _tensors(_stages(5, 2, 4)),
                torch.from_numpy(_mb(m, (m, 2, 4))), mesh=dp_pp).numpy()
        w, mb = _quant_inputs()
        out['quant'] = pipeline_apply(
            _quant_stage, {'w': torch.from_numpy(w)}, torch.from_numpy(mb),
            mesh=pipe4).numpy()
        out['dp_pp'] = pipeline_apply(
            _mlp, _tensors(_stages(8, 2, 8)),
            torch.from_numpy(_mb(9, (6, 4, 8))), mesh=dp_pp,
            batch_axis='data').numpy()
        mb4 = torch.from_numpy(_mb(10, (4, 2, 4)))
        for bad in (_tensors(_stages(11, 4, 4)), _tensors(_stages(11, 1, 4)),
                    {'w': torch.zeros(2, 4, 4), 'b': torch.zeros(3, 4)}):
            try:
                pipeline_apply(_mlp, bad, mb4, mesh=dp_pp)
                out['errors'].append(None)
            except ValueError as e:
                out['errors'].append(str(e))
    out['grads'] = _grads(pipe4)
    out['summing'] = _grads(pipe4, summing=True)
    out['packed'] = _packed(pipe4, WORLD)
    return out


def _worker() -> None:
    """One rank: python -c '...' <rank> <world> <port> <out> <inputs>."""
    rank, world, port = (int(a) for a in sys.argv[1:4])
    from quant_tpu_torch.parallel import multihost
    multihost.initialize(f'127.0.0.1:{port}', world, rank, device='cpu')
    torch.save(_world4(rank), sys.argv[4])


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('pipe_world')
    return run_world(tmp, WORLD, tmp / 'unused', 'test_torch_port_pipeline')


# ---------------------------------------------------------- the JAX side


def _jax_mlp(params, x):
    import jax.numpy as jnp
    return jnp.tanh(x @ params['w'] + params['b'])


def _jax_sequential(stage_fn, stacked, x):
    import jax
    s = jax.tree.leaves(stacked)[0].shape[0]
    for i in range(s):
        x = stage_fn(jax.tree.map(lambda v: v[i], stacked), x)
    return x


@pytest.fixture(scope='module')
def jax_side():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from quant_tpu.ops.quantize import quantizer_ls_1
    from quant_tpu.parallel.pipeline import pipeline_apply
    devs = np.asarray(jax.devices()[:WORLD])
    pipe4, pipe2 = Mesh(devs, ('pipe',)), Mesh(devs[:2], ('pipe',))
    dp_pp = Mesh(devs.reshape(2, 2), ('data', 'pipe'))

    def seq(stage_fn, stacked, mb):
        return np.asarray(jax.vmap(
            lambda x: _jax_sequential(stage_fn, stacked, x))(mb))

    def tree(t: dict) -> dict:
        return {k: jnp.asarray(v) for k, v in t.items()}

    out: dict = {'many': {}, 'many_seq': {}}
    st, mb = tree(_stages(1, 4, 8)), jnp.asarray(_mb(2, (6, 3, 8)))
    out['forward'] = np.asarray(pipeline_apply(_jax_mlp, st, mb, mesh=pipe4))
    out['forward_seq'] = seq(_jax_mlp, st, mb)
    for m in MANY:
        st, mb = tree(_stages(5, 2, 4)), jnp.asarray(_mb(m, (m, 2, 4)))
        out['many'][m] = np.asarray(pipeline_apply(_jax_mlp, st, mb,
                                                   mesh=pipe2))
        out['many_seq'][m] = seq(_jax_mlp, st, mb)

    def quant_stage(params, x):
        n, c = x.shape[0], x.shape[-1]
        _, xq = quantizer_ls_1(x.reshape(n, -1))
        _, wq = quantizer_ls_1(params['w'].reshape(c, -1))
        y = jax.lax.conv_general_dilated(
            xq.reshape(x.shape), wq.reshape(params['w'].shape), (1, 1),
            ((1, 1), (1, 1)), dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
        return x + jnp.tanh(y)

    w, mb = _quant_inputs()
    out['quant'] = np.asarray(pipeline_apply(
        quant_stage, {'w': jnp.asarray(w)}, jnp.asarray(mb), mesh=pipe4))
    out['quant_seq'] = seq(quant_stage, {'w': jnp.asarray(w)},
                           jnp.asarray(mb))
    st, mb = tree(_stages(8, 2, 8)), jnp.asarray(_mb(9, (6, 4, 8)))
    out['dp_pp'] = np.asarray(jax.jit(lambda p, x: pipeline_apply(
        _jax_mlp, p, x, mesh=dp_pp, axis='pipe', batch_axis='data'))(st, mb))
    st, mb = tree(_stages(3, 4, 8)), jnp.asarray(_mb(4, (5, 3, 8)))

    def loss(p, x):
        return jnp.sum(pipeline_apply(_jax_mlp, p, x, mesh=pipe4) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(st, mb)
    out['grads'] = {**{k: np.asarray(v) for k, v in gp.items()},
                    'mb': np.asarray(gx)}
    return out


# ------------------------------------------------------------ the cases


def test_forward_matches_jax_and_sequential(world, jax_side):
    np.testing.assert_allclose(jax_side['forward'], jax_side['forward_seq'],
                               **TOL)
    for r in world:
        np.testing.assert_allclose(r['forward'], jax_side['forward'], **TOL)


@pytest.mark.parametrize('m', MANY)
def test_single_microbatch_and_many(world, jax_side, m):
    for r in world:
        np.testing.assert_allclose(r['many'][m], jax_side['many'][m], **TOL)
        np.testing.assert_allclose(r['many'][m], jax_side['many_seq'][m],
                                   **TOL)


@pytest.mark.parametrize('leaf', ['w', 'b', 'mb'])
def test_gradient_matches_jax_grad(world, jax_side, leaf):
    """Every rank holds the whole gradient of the stacked leaves (and of
    the microbatches), JAX's jax.grad through its pipeline."""
    for r in world:
        np.testing.assert_allclose(r['grads'][leaf],
                                   jax_side['grads'][leaf], **GRAD_TOL)


def test_summing_backward_control_differs(world, jax_side):
    """The replicating all-reduce with a summing backward gives the last
    stage S times its outputs' cotangent, and so every stage S times its
    gradient: beyond 1e-3 of JAX's."""
    for r in world:
        diff = np.abs(r['summing']['w'] - jax_side['grads']['w']).max()
        assert diff > SUMMING_MIN_DIFF
        np.testing.assert_allclose(r['summing']['w'],
                                   WORLD * jax_side['grads']['w'],
                                   **GRAD_TOL)


def test_quantized_stage(world, jax_side):
    np.testing.assert_allclose(jax_side['quant'], jax_side['quant_seq'],
                               **TOL)
    for r in world:
        np.testing.assert_allclose(r['quant'], jax_side['quant'], **TOL)


@pytest.mark.parametrize('i', [0, 1, 2])
def test_stage_count_mismatch_raises(world, i):
    for r in world:
        assert r['errors'][i] is not None and 'leading dim' in r['errors'][i]


def test_composes_with_data_axis(world, jax_side):
    """dp x pp: rank (d, p) pipelines rows d of every microbatch."""
    for rank, r in enumerate(world):
        d = rank // 2
        np.testing.assert_allclose(
            r['dp_pp'], np.split(jax_side['dp_pp'], 2, axis=1)[d], **TOL)


def test_packed_block_stages_equal_sequential(world):
    blocks, x, fold = _packed_blocks(WORLD)
    with torch.no_grad():
        want = []
        for xb in x:
            for b in blocks:
                xb = b(xb, torch.bfloat16, fold)
            want.append(xb)
    want = torch.stack(want).float().numpy()
    for r in world:
        np.testing.assert_array_equal(r['packed']['out'], want)
        assert not r['packed']['launched']  # CPU: the plain twins
        # Each stage's served block hands both convs their tails, on the
        # microbatches its rank computes.
        assert r['packed']['tails'] == 2 * x.shape[0]


def test_stack_stage_params_refuses_mixed_trees():
    from quant_tpu_torch.parallel import stack_stage_params
    with pytest.raises(ValueError, match='structure'):
        stack_stage_params([{'w': torch.zeros(2)}, {'v': torch.zeros(2)}])
