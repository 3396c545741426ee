"""Grouped and dilated convs, BatchNorm's momentum, WeightQuantizer and the
torch-default initializers of the port, against the JAX package's on
the CPU (numpy-seeded inputs; JAX's weights carried to the port by
utils.jax_import.from_jax_variables).

Tolerances: float32 convs and their gradients within 1e-5 of the
largest value (two frameworks' sums in another order); the weight
scales' float32 solves within SOLVE_TOL and BatchNorm in float32 within
F32_TOL (as test_torch_port_train_ops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.nn import export as jexport
from quant_tpu.nn import layers as jlayers
from quant_tpu.ops.conv import conv2d as jconv2d
from quant_tpu_torch.nn import (
    BatchNorm, Conv, QuantConv2d, WeightQuantizer,
)
from quant_tpu_torch.nn import export as texport
from quant_tpu_torch.nn import layers as tlayers
from quant_tpu_torch.ops import binary_infer as BI
from quant_tpu_torch.ops.conv import conv2d
from quant_tpu_torch.parallel import band_model, shard_model
from quant_tpu_torch.utils.jax_import import (
    from_jax_variables, to_jax_variables,
)

F32_REL = 1e-5
SOLVE_TOL = dict(rtol=1e-5, atol=1e-6)
F32_TOL = dict(rtol=1e-6, atol=1e-6)
C = 8  # in and out channels: groups 2 and C (depthwise)


def close(got, want, rel: float = F32_REL) -> None:
    """got within rel of want's largest magnitude, element by element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# (groups, dilation, kernel, stride, padding); the strided 1x1 cases
# take the CPU's NCHW backward (ops.conv._StridedPointwiseCPU).
CONV_CASES = [(2, 1, 3, 1, 1), (2, 2, 3, 1, 2), (C, 1, 3, 2, 1),
              (C, 2, 3, 1, 2), (2, 1, 1, 2, 0), (C, 1, 1, 2, 0)]


@pytest.mark.parametrize('groups,dilation,k,stride,pad', CONV_CASES)
def test_conv2d_groups_and_dilation(groups, dilation, k, stride, pad):
    """ops.conv2d's output and its gradients in x and w against
    quant_tpu.ops.conv.conv2d (float32, 1e-5 of the largest value);
    batch 4, 8 channels, 16x16: the shape where oneDNN's NHWC backward
    of a strided 1x1 conv crashed."""
    rng = np.random.default_rng(groups * 100 + dilation * 10 + k)
    x = rng.standard_normal((4, 16, 16, C)).astype(np.float32)
    w = rng.standard_normal((k, k, C // groups, 2 * C)).astype(np.float32)
    b = rng.standard_normal((2 * C,)).astype(np.float32)

    def jfn(a, kern):
        return jconv2d(a, kern, stride=stride, padding=pad,
                       dilation=dilation, groups=groups, bias=jnp.asarray(b))

    jy, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(jy.shape).astype(np.float32)
    jgx, jgw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = conv2d(tx, tw, stride=stride, padding=pad, dilation=dilation,
               groups=groups, bias=torch.from_numpy(b))
    y.backward(torch.from_numpy(g))
    close(y.detach().numpy(), jy)
    close(tx.grad.numpy(), jgx)
    close(tw.grad.numpy(), jgw)


@pytest.mark.parametrize('groups', [2, C])
def test_grouped_conv_layer(groups):
    """nn.Conv(groups=...): JAX's kernel (3, 3, C // groups, 2C) and bias
    carried over; output and gradients against JAX's."""
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    jm = jlayers.Conv(features=2 * C, kernel_size=3, padding=1,
                      groups=groups)
    v = jm.init(jax.random.key(groups), jnp.asarray(x))
    assert v['params']['kernel'].shape == (3, 3, C // groups, 2 * C)
    port = from_jax_variables(Conv(C, 2 * C, 3, padding=1, groups=groups),
                              _np(v))
    jy, vjp = jax.vjp(lambda p, a: jm.apply({'params': p}, a),
                      v['params'], jnp.asarray(x))
    g = rng.standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    y = port(tx)
    y.backward(torch.from_numpy(g))
    close(y.detach().numpy(), jy)
    close(tx.grad.numpy(), jgx)
    close(port.kernel.grad.numpy(), jgp['kernel'])
    close(port.bias.grad.numpy(), jgp['bias'])


GROUPED_CASES = [('ls-1', 'fp', 2), ('ls-1', 'ls-1', 2), ('ls-1', 'ls-2', 2),
                 ('fp', 'ls-1', C), ('ls-1', 'ls-1', C), ('ls-1', 'ls-2', C)]


def _no_packed_path(monkeypatch) -> None:
    def refuse(*args, **kwargs):
        raise AssertionError('a grouped conv took the packed path')
    monkeypatch.setattr(BI, 'quant_conv2d_infer', refuse)
    monkeypatch.setattr(BI, 'fp_activation_conv_infer', refuse)


@pytest.mark.parametrize('x_quant,w_quant,groups', GROUPED_CASES)
def test_grouped_quant_conv_against_jax(x_quant, w_quant, groups,
                                        monkeypatch):
    """A grouped QuantConv2d under inference_mode='packed': the train
    forward, the gradients (x, kernel, bias) and the cached weight
    scales against JAX's jax.vjp of its train apply; then the eval
    forward, which serves the dense conv (the packed path raises here),
    against JAX's eval apply; then export, fold and strip of JAX's
    trained state: the same tree as JAX's (no packed_params), no fold,
    and strip refused alike;
    a tree stripped of the kernel fails on both sides."""
    _no_packed_path(monkeypatch)
    rng = np.random.default_rng(len(x_quant) * 10 + groups)
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    jm = jlayers.QuantConv2d(features=C, kernel_size=3, padding=1,
                             x_quant=x_quant, w_quant=w_quant, groups=groups,
                             inference_mode='packed')
    v = jm.init(jax.random.key(groups), jnp.asarray(x), False)
    port = from_jax_variables(
        QuantConv2d(C, C, 3, x_quant=x_quant, w_quant=w_quant, padding=1,
                    groups=groups, inference_mode='packed'), _np(v))
    assert port.kernel.shape == (3, 3, C // groups, C) and not port.packed

    def train(p, a):
        return jm.apply({**v, 'params': p}, a, True, mutable=['quant_state'])

    jy, vjp, mut = jax.vjp(train, v['params'], jnp.asarray(x), has_aux=True)
    g = rng.standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(g))
    port.train()
    tx = torch.from_numpy(x).requires_grad_()
    y = port(tx)
    y.backward(torch.from_numpy(g))
    close(y.detach().numpy(), jy)
    close(tx.grad.numpy(), jgx)
    close(port.kernel.grad.numpy(), jgp['kernel'])
    close(port.bias.grad.numpy(), jgp['bias'])
    if w_quant == 'fp':
        assert port.w_vs is None and not mut.get('quant_state')
    else:
        np.testing.assert_allclose(
            port.w_vs.numpy(), mut['quant_state']['w_quantizer']['vs'],
            **SOLVE_TOL)

    trained = _np({**v, **mut})
    port.eval()
    with torch.no_grad():
        y = port(torch.from_numpy(x))
    close(y.numpy(), jm.apply(trained, jnp.asarray(x), False))

    exported = _np(jexport.export_packed_variables(jm, trained,
                                                   jnp.asarray(x)))
    assert 'packed_params' not in exported
    # The export of one state: JAX's trained tree on both sides.
    from_jax_variables(port, trained)
    texport.export_packed_variables(port)
    got = to_jax_variables(port)
    assert jax.tree.structure(got) == jax.tree.structure(exported)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(exported)):
        np.testing.assert_array_equal(a, b)
    assert jexport.fold_for_serving(jm, exported)[2] is False
    assert texport.fold_for_serving(port) == (port, False)
    for strip, what in ((jexport.strip_for_deployment, exported),
                        (texport.strip_for_deployment, port)):
        with pytest.raises(ValueError, match='needs packed_params'):
            strip(what)

    stripped = dict(exported, params={
        k: a for k, a in exported['params'].items() if k != 'kernel'})
    stripped.pop('quant_state', None)
    with pytest.raises(Exception, match='kernel'):
        jm.apply(stripped, jnp.asarray(x), False)
    bare = from_jax_variables(
        QuantConv2d(C, C, 3, x_quant=x_quant, w_quant=w_quant, padding=1,
                    groups=groups), stripped)
    assert bare.kernel is None
    with pytest.raises(ValueError, match='grouped conv serves the dense'):
        bare(torch.from_numpy(x))


def test_batchnorm_momentum_over_two_steps():
    """BatchNorm(momentum=0.01): output and running statistics after two
    train forwards equal JAX's BatchNorm(momentum=0.01) (torch's
    convention: the new statistics' weight), float32 within F32_TOL."""
    rng = np.random.default_rng(11)
    xs = [(rng.standard_normal((3, 4, 4, 5)) * s + s).astype(np.float32)
          for s in (1.0, 2.0)]
    bn = BatchNorm(5, momentum=0.01).train()
    jbn = jlayers.BatchNorm(momentum=0.01)
    v = jbn.init(jax.random.key(0), jnp.asarray(xs[0]), False)
    for x in xs:
        jy, mut = jbn.apply(v, jnp.asarray(x), True, mutable=['batch_stats'])
        v = {**v, **mut}
        np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(jy), **F32_TOL)
    stats = _np(v['batch_stats']['bn'])
    np.testing.assert_allclose(bn.running_mean.numpy(), stats['mean'],
                               **F32_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), stats['var'],
                               **F32_TOL)
    # Two steps at 0.01 move the statistics 1.99% of the way; at the
    # default 0.1 they would move 19%.
    assert np.abs(stats['mean']).max() < 0.1
    assert BatchNorm(5).momentum == 0.1


SCHEMES = ['fp', 'ls-1', 'ls-2', 'ls-T', 'gf-2', 'gf-3']


@pytest.mark.parametrize('scheme', SCHEMES)
def test_weight_quantizer_train_then_eval(scheme):
    """WeightQuantizer: a train forward solves the scales and caches them
    in `vs`; an eval forward of other weights quantizes with the cache;
    w_q and vs against JAX's WeightQuantizer with a mutable
    quant_state (float32 solves, SOLVE_TOL). fp passes w through, with
    no scales and no state."""
    rng = np.random.default_rng(len(scheme))
    w1, w2 = (rng.standard_normal((6, 27)).astype(np.float32)
              for _ in range(2))
    jq = jlayers.WeightQuantizer(scheme=scheme, size=6)
    v = jq.init(jax.random.key(0), jnp.asarray(w1), False)
    (jw1, jvs), mut = jq.apply(v, jnp.asarray(w1), True, return_scales=True,
                               mutable=['quant_state'])
    jw2, jvs2 = jq.apply({**v, **mut}, jnp.asarray(w2), False,
                         return_scales=True)
    q = WeightQuantizer(scheme, 6)
    tw1, tvs = q(torch.from_numpy(w1), True, return_scales=True)
    tw2, tvs2 = q(torch.from_numpy(w2), False, return_scales=True)
    if scheme == 'fp':
        assert q.vs is None and tvs is None and tvs2 is None
        assert jvs is None and not mut.get('quant_state')
        np.testing.assert_array_equal(tw2.numpy(), w2)
        return
    assert q.vs.shape == (len(jvs), 6) == mut['quant_state']['vs'].shape
    for got, want in ((tvs, jvs), (q.vs, mut['quant_state']['vs']),
                      (tvs2, jvs2), (tw1, jw1), (tw2, jw2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **SOLVE_TOL)
    np.testing.assert_array_equal(q(torch.from_numpy(w2), False).numpy(),
                                  tw2.numpy())


@pytest.mark.parametrize('shape', [(3, 3, 4, 8), (3, 3, 2, 8), (16, 10)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_torch_default_initializers(shape, dtype):
    """torch_conv_kernel_init and torch_bias_init: shape, dtype, and every
    value within 1/sqrt(fan_in) (fan_in the product of all axes but the
    last), in both packages; the RNGs differ, so values are not
    compared."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    fan_in = int(np.prod(shape[:-1]))
    # A bf16 draw may round up onto the next value past the bound.
    bound = fan_in ** -0.5 * (1 + (2 ** -7 if dtype == torch.bfloat16
                                   else 0))
    gen = torch.Generator().manual_seed(0)
    pairs = [
        (tlayers.torch_conv_kernel_init(dtype)(shape, gen),
         jlayers.torch_conv_kernel_init(jdt)(jax.random.key(0), shape)),
        (tlayers.torch_bias_init(fan_in, dtype)(shape[-1:], gen),
         jlayers.torch_bias_init(fan_in, jdt)(jax.random.key(1),
                                              shape[-1:]))]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        assert got.dtype == dtype and want.dtype == jdt
        for values in (got.float().numpy(), np.asarray(want, np.float32)):
            assert np.abs(values).max() <= bound
            assert np.abs(values).max() > 0.5 * bound


class _Axis:
    def size(self) -> int:
        return 2


class _Mesh:
    """A mesh of two ranks on each axis, for the refusals (raised before
    any process group is read)."""
    mesh_dim_names = ('model', 'space')

    def __getitem__(self, axis: str) -> _Axis:
        return _Axis()


@pytest.mark.parametrize('place', [shard_model, band_model])
def test_parallel_placements_refuse_grouped_convs(place):
    """shard_model and band_model raise ValueError naming a grouped conv
    (they have no rule for its slice; JAX's sharded and banded convs take
    no groups) rather than compute a wrong one."""
    model = torch.nn.Sequential(Conv(C, C, 3, padding=1),
                                QuantConv2d(C, C, 3, padding=1, groups=2))
    with pytest.raises(ValueError, match='1 has groups=2'):
        place(model, _Mesh())
    assert place(model, None) is model
