"""Parity of the port's train-mode ops and training pieces with JAX.

The value paths (the straight-through binarize, every scheme's
quantizer, the symmetric clamp, PReLU, BatchNorm) run in float64 on both
sides, torch.float64 against JAX under a scoped jax.enable_x64, and
their outputs and gradients must agree to 1e-12 relative. The scale
solves stay float32 on both sides by design (quantize.py `_rows32`,
optimal.py): the solved scales are held to SOLVE_TOL, and then both
sides quantize with JAX's scales, so that an ulp in a scale cannot flip
a sign. The float32 and bf16 forms, the activation quantizer's EMA, the
losses, KD, metrics, optimizers, schedules and parameter groups are held
to the float32 (or bf16) rounding of their own ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from quant_tpu.nn import layers as jlayers
from quant_tpu.ops import quantize as jquantize
from quant_tpu.ops.ste import binarize as jbinarize
from quant_tpu.train import groups as jgroups
from quant_tpu.train import kd as jkd
from quant_tpu.train import losses as jlosses
from quant_tpu.train import metrics as jmetrics
from quant_tpu.train import optim as joptim
from quant_tpu_torch import train as T
from quant_tpu_torch.nn.layers import (
    ActivationQuantizer, BatchNorm, PReLU, state_unchanged,
)
from quant_tpu_torch.ops import quantize as tquantize
from quant_tpu_torch.ops.ste import binarize
from quant_tpu_torch.probes.models import build, small_config
from quant_tpu_torch.train import groups as tgroups
from quant_tpu_torch.train import metrics as tmetrics
from quant_tpu_torch.utils.jax_import import to_jax_variables

EXACT = dict(rtol=1e-12, atol=0)
# float32 solves of the same float32 rows: opt_v1's sums and sorts run
# in another order on each side (test_torch_port_optimal's V1_TOL).
SOLVE_TOL = dict(rtol=1e-5, atol=1e-6)
F32_TOL = dict(rtol=1e-6, atol=1e-6)
# Activations quantized with solved scales (float32): one scale an ulp
# apart moves x_q by that ulp.
EMA_TOL = dict(rtol=1e-5, atol=1e-6)
# Optimizer updates: torch.optim and optax round their elementwise ops
# in another order (fused add with alpha, lerp), a few float32 ulps.
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
# One bf16 ulp is 2^-8 relative.
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _f64(rng: np.random.Generator, shape: tuple, scale: float = 1.0
         ) -> np.ndarray:
    return rng.standard_normal(shape) * scale


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


SPECIALS = [0.0, 1.0, -1.0, float('nan'), np.nextafter(1.0, 2.0),
            np.nextafter(-1.0, -2.0), float('inf'), float('-inf'), -0.0]
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_binarize_forward_and_gradient(dtype):
    """sign(0) = +1, sign(NaN) = +1; the gradient passes on the closed
    window |x| <= 1 (both 1 and -1 pass, the next value out does not,
    NaN does not), as JAX's custom_vjp."""
    rng = np.random.default_rng(0)
    x = np.concatenate([SPECIALS, _f64(rng, (55,), 1.5)])
    g = _f64(rng, x.shape)
    t = torch.tensor(x, dtype=dtype, requires_grad=True)
    y = binarize(t)
    y.backward(torch.tensor(g, dtype=dtype))
    with jax.enable_x64(True):
        jx = jnp.asarray(_np(t), JDT[dtype])
        jy, vjp = jax.vjp(jbinarize, jx)
        jg = vjp(jnp.asarray(g, JDT[dtype]))[0]
        want_y = np.asarray(jy.astype(jnp.float64))
        want_g = np.asarray(jg.astype(jnp.float64))
    np.testing.assert_array_equal(_np(y), want_y)
    np.testing.assert_array_equal(_np(t.grad), want_g)
    passes = _np(t.grad)[:len(SPECIALS)] != 0
    if dtype == torch.float64:  # 1 + ulp does not round back onto 1
        assert passes.tolist() == [True, True, True, False, False, False,
                                   False, False, True]
    # Where autograd records nothing it is the plain sign.
    with torch.no_grad():
        assert binarize(t).grad_fn is None


QUANT_CASES = ([('ls-1', 'exact'), ('gf-2', 'exact'), ('gf-3', 'exact')]
               + [(s, m) for s in ('ls-2', 'ls-T')
                  for m in ('exact', 'reference', 'lloyd')])


@pytest.mark.parametrize('scheme,mode', QUANT_CASES)
def test_train_quantizer_gradient_float64(scheme, mode):
    """Each scheme's train quantizer on (6, 3, 3, 5) float64 rows (0 and
    +-1 planted): the float32 solves agree (SOLVE_TOL); with JAX's scales
    fed to both, x_q and the straight-through gradient of sum(x_q * g)
    agree to 1e-12 relative."""
    rng = np.random.default_rng(1)
    x = _f64(rng, (6, 3, 3, 5), 0.8)
    x.reshape(-1)[:6] = [0.0, 1.0, -1.0, 0.0, 1.0, -1.0]
    g = _f64(rng, x.shape)
    with jax.enable_x64(True):
        jvs, _ = jlayers._quantize_with_scheme(scheme, jnp.asarray(x), None,
                                               3, mode)

        def value(a: jax.Array) -> jax.Array:
            return jlayers._quantize_with_scheme(scheme, a, jvs, 3, mode)[1]

        jq, vjp = jax.vjp(value, jnp.asarray(x))
        jg, jvs = np.asarray(vjp(jnp.asarray(g))[0]), np.asarray(jvs)
        jq = np.asarray(jq)
    tvs, _ = tquantize.quantize_with_scheme(
        scheme, torch.tensor(x, requires_grad=True), None, 3, mode)
    # The solves (opt_v1 for ls-2 and ls-T) are detached: no gradient.
    assert not tvs.requires_grad
    assert tvs.dtype == torch.float32 and jvs.dtype == np.float32
    np.testing.assert_allclose(tvs.numpy(), jvs, **SOLVE_TOL)
    t = torch.tensor(x, requires_grad=True)
    _, tq = tquantize.quantize_with_scheme(scheme, t, torch.tensor(jvs),
                                           3, mode)
    tq.backward(torch.tensor(g))
    assert tq.dtype == torch.float64
    np.testing.assert_allclose(tq.detach().numpy(), jq, **EXACT)
    np.testing.assert_allclose(t.grad.numpy(), jg, **EXACT)
    assert np.abs(jg).sum() > 0


def test_clamp_and_prelu_gradients_at_their_kinks():
    """jnp.clip's gradient is 0.5 at +-alpha (torch.clamp's would be 1);
    PReLU's is 1 at x = 0 and a elsewhere below (F.prelu's would be a at
    0). Float64, values planted at the kinks."""
    rng = np.random.default_rng(2)
    x = np.concatenate([[2.0, -2.0, 0.0, -0.0, 2.5, -3.0],
                        _f64(rng, (30,), 2.0)])
    g = _f64(rng, x.shape)
    t = torch.tensor(x, requires_grad=True)
    y = tquantize.clamp_symmetric(t, 2.0)
    y.backward(torch.tensor(g))
    with jax.enable_x64(True):
        jy, vjp = jax.vjp(lambda a: jquantize.clamp_symmetric(a, 2.0),
                          jnp.asarray(x))
        jg = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **EXACT)
    np.testing.assert_allclose(t.grad.numpy(), jg, **EXACT)
    np.testing.assert_allclose(t.grad.numpy()[:2], 0.5 * g[:2], **EXACT)

    prelu = PReLU().double()
    t = torch.tensor(x, requires_grad=True)
    prelu(t).backward(torch.tensor(g))
    jp = jlayers.PReLU()
    with jax.enable_x64(True):
        params = {'params': {'negative_slope': jnp.asarray(0.25,
                                                           jnp.float64)}}
        jy, vjp = jax.vjp(lambda p, a: jp.apply(p, a), params,
                          jnp.asarray(x))
        jgp, jgx = vjp(jnp.asarray(g))
        jgs = float(jgp['params']['negative_slope'])
        jgx = np.asarray(jgx)
    np.testing.assert_allclose(t.grad.numpy(), jgx, **EXACT)
    assert t.grad.numpy()[2] == g[2] and t.grad.numpy()[3] == g[3]
    np.testing.assert_allclose(prelu.negative_slope.grad.item(), jgs,
                               **EXACT)


def _jax_bn(affine: bool, eps: float, c: int, dtype: object,
            stats: tuple) -> tuple:
    bn = jlayers.BatchNorm(epsilon=eps, affine=affine)
    v = {'batch_stats': {'bn': {'mean': stats[0], 'var': stats[1]}}}
    if affine:
        v['params'] = {'bn': {'scale': stats[2], 'bias': stats[3]}}
    return bn.clone(dtype=dtype), v


def _bn_stats(rng: np.random.Generator, c: int) -> list:
    return [rng.uniform(-0.5, 0.5, c), rng.uniform(0.2, 2.0, c),
            rng.uniform(-1.5, 1.5, c), rng.uniform(-0.8, 0.8, c)]


@pytest.mark.parametrize('affine,eps', [(True, 1e-5), (False, 1e-4)])
def test_batchnorm_train_float64(affine, eps):
    """Train BN on the batch's fast variance: output, gradients (x,
    scale, bias) and the new running statistics (0.9 old + 0.1 batch,
    biased variance) agree to 1e-12 relative; LeNet's affine-free BN at
    eps 1e-4. A channel of zeros is planted (variance 0: max(0, .)
    splits its gradient, as jnp.maximum's tie)."""
    rng = np.random.default_rng(3)
    c = 6
    x = _f64(rng, (4, 5, 5, c), 1.3) + 0.4
    x[..., 0] = 0.0
    g = _f64(rng, x.shape)
    stats = _bn_stats(rng, c)
    bn = BatchNorm(c, eps, affine=affine).double().train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor(stats[0]))
        bn.running_var.copy_(torch.tensor(stats[1]))
        if affine:
            bn.weight.copy_(torch.tensor(stats[2]))
            bn.bias.copy_(torch.tensor(stats[3]))
    t = torch.tensor(x, requires_grad=True)
    y = bn(t)
    y.backward(torch.tensor(g))
    with jax.enable_x64(True):
        jbn, v = _jax_bn(affine, eps, c, None,
                         [jnp.asarray(s) for s in stats])

        def run(params: dict, a: jax.Array) -> tuple:
            out, mut = jbn.apply({**v, **params}, a, True,
                                 mutable=['batch_stats'])
            return out, mut['batch_stats']['bn']

        params = {'params': v['params']} if affine else {}
        (jy, new), vjp = jax.vjp(run, params, jnp.asarray(x))
        jgp, jgx = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, new)))
        jy, jgx = np.asarray(jy), np.asarray(jgx)
        new = jax.tree.map(np.asarray, new)
        jgp = jax.tree.map(np.asarray, jgp)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.detach().numpy(), jy, **EXACT)
    np.testing.assert_allclose(t.grad.numpy(), jgx, **EXACT)
    np.testing.assert_allclose(bn.running_mean.numpy(), new['mean'], **EXACT)
    np.testing.assert_allclose(bn.running_var.numpy(), new['var'], **EXACT)
    if affine:
        np.testing.assert_allclose(bn.weight.grad.numpy(),
                                   jgp['params']['bn']['scale'], **EXACT)
        np.testing.assert_allclose(bn.bias.grad.numpy(),
                                   jgp['params']['bn']['bias'], **EXACT)


@pytest.mark.parametrize('affine,dtype', [(True, None), (False, None),
                                          (True, torch.bfloat16)])
def test_batchnorm_train_float32_and_bf16(affine, dtype):
    """float32 parameters and statistics: a float32 input (F32_TOL), and
    a bf16 input with dtype bf16 (train_dtype's chain: reductions in
    float32, output bf16, BF16_TOL) or, affine-free, dtype None: the
    output takes x's dtype (flax's canonicalize_dtype), here float32."""
    rng = np.random.default_rng(4)
    c = 5
    x = (_f64(rng, (3, 4, 4, c), 2.0) + 0.7).astype(np.float32)
    stats = [s.astype(np.float32) for s in _bn_stats(rng, c)]
    bn = BatchNorm(c, affine=affine).train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats[0]))
        bn.running_var.copy_(torch.from_numpy(stats[1]))
        if affine:
            bn.weight.copy_(torch.from_numpy(stats[2]))
            bn.bias.copy_(torch.from_numpy(stats[3]))
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype is not None:
        tx, jx = tx.to(dtype), jx.astype(jnp.bfloat16)
    y = bn(tx, dtype)
    jbn, v = _jax_bn(affine, 1e-5, c, None if dtype is None else
                     jnp.bfloat16, [jnp.asarray(s) for s in stats])
    jy, mut = jbn.apply(v, jx, True, mutable=['batch_stats'])
    assert str(y.dtype).split('.')[-1] == str(jy.dtype)
    np.testing.assert_allclose(_np(y), np.asarray(jy.astype(jnp.float32)),
                               **(BF16_TOL if dtype else F32_TOL))
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               mut['batch_stats']['bn']['mean'], **F32_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               mut['batch_stats']['bn']['var'], **F32_TOL)


@pytest.mark.parametrize('mode', ['off', 'eval_only', 'train_and_eval'])
@pytest.mark.parametrize('scheme', ['ls-1', 'ls-2'])
def test_activation_quantizer_train_modes(scheme, mode):
    """Three train forwards of one quantizer at momentum 0.9: x_q (the
    batch's scales; with 'train_and_eval' the blended EMA's), the EMA
    (the first batch copied, later ones blended) and its count, against
    JAX's apply with a mutable quant_state; then an eval forward reads
    the EMA (or solves, 'off')."""
    rng = np.random.default_rng(5)
    xs = [(_f64(rng, (3, 4, 4, 5), s)).astype(np.float32)
          for s in (1.0, 2.0, 0.5, 1.5)]
    quant = ActivationQuantizer(scheme, mode, moving_average_momentum=0.9)
    quant.train()
    jq = jlayers.ActivationQuantizer(scheme, mode,
                                     moving_average_momentum=0.9)
    state = jq.init(jax.random.key(0), jnp.asarray(xs[0]), False)
    step = jax.jit(lambda s, a: jq.apply(s, a, True, return_scales=True,
                                         mutable=['quant_state']))
    for x in xs[:3]:
        (jx_q, jvs), state = step(state, jnp.asarray(x))
        t_vs = quant(torch.from_numpy(x))
        np.testing.assert_allclose(t_vs.numpy(), np.asarray(jvs), **EMA_TOL)
        tx_q = tquantize.quantize_with_scheme(scheme, torch.from_numpy(x),
                                              t_vs)[1]
        np.testing.assert_allclose(tx_q.numpy(), np.asarray(jx_q),
                                   **EMA_TOL)
    if mode == 'off':
        assert quant.ema is None and not state.get('quant_state')
    else:
        np.testing.assert_allclose(quant.ema.numpy(), np.asarray(
            state['quant_state']['ema']), **EMA_TOL)
        assert int(quant.ema_count) == 3
        assert int(state['quant_state']['ema_count']) == 3
    quant.eval()
    jx_q = jq.apply(state, jnp.asarray(xs[3]), False)
    np.testing.assert_allclose(quant.quantize(torch.from_numpy(xs[3]))
                               .numpy(), np.asarray(jx_q), **EMA_TOL)


def test_state_unchanged_restores_every_buffer():
    """Train forwards inside state_unchanged write nothing that stays."""
    bn = BatchNorm(3).train()
    quant = ActivationQuantizer('ls-1', 'eval_only').train()
    before = [b.clone() for b in [*bn.buffers(), *quant.buffers()]]
    with state_unchanged(bn), state_unchanged(quant):
        x = torch.randn(2, 4, 4, 3)
        bn(x)
        quant(x)
        assert not torch.equal(bn.running_mean, before[0])
    after = [*bn.buffers(), *quant.buffers()]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def _logits(rng: np.random.Generator, n: int = 6, c: int = 10
            ) -> tuple[np.ndarray, np.ndarray]:
    return (_f64(rng, (n, c), 2.0).astype(np.float32),
            rng.integers(0, c, n))


@pytest.mark.parametrize('name', ['cross_entropy', 'nll_loss', 'kl_div'])
def test_losses_and_per_sample_forms(name):
    rng = np.random.default_rng(6)
    out, target = _logits(rng)
    if name != 'cross_entropy':
        out = np.asarray(jax.nn.log_softmax(out))
    if name == 'kl_div':
        target = np.asarray(jax.nn.softmax(_logits(rng)[0]))
    tf, jf = T.get_loss_fn(name), jlosses.get_loss_fn(name)
    args = (torch.tensor(out), torch.tensor(target))
    jargs = (jnp.asarray(out), jnp.asarray(target))
    np.testing.assert_allclose(tf(*args).item(), float(jf(*jargs)),
                               **F32_TOL)
    np.testing.assert_allclose(tf.per_sample(*args).numpy(),
                               np.asarray(jf.per_sample(*jargs)), **F32_TOL)
    with pytest.raises(ValueError, match='not supported'):
        T.get_loss_fn('hinge')


@pytest.mark.parametrize('correction,fixed', [(True, False), (False, False),
                                              (True, True)])
@pytest.mark.parametrize('temperature', [1.0, 4.0])
def test_kd_criterion(correction, fixed, temperature):
    """Pure KD unless the fix is asked for: the reference's correction
    mask compares the teacher with itself."""
    rng = np.random.default_rng(7)
    s, target = _logits(rng)
    t = _logits(rng)[0]
    kw = dict(temperature=temperature, teacher_correction=correction,
              fixed_teacher_correction=fixed)
    ts = torch.from_numpy(s).requires_grad_()
    got = T.kd_criterion(ts, torch.from_numpy(t), torch.from_numpy(target),
                         **kw)
    got.backward()
    want, jg = jax.value_and_grad(lambda a: jkd.kd_criterion(
        a, jnp.asarray(t), jnp.asarray(target), **kw))(jnp.asarray(s))
    np.testing.assert_allclose(got.item(), float(want), **F32_TOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg), **F32_TOL)


def test_metric_updates_and_names():
    """Batch-mean and masked updates (rows with target -1 left out),
    argmax's first maximum, top-5 membership, the reference's names."""
    rng = np.random.default_rng(8)
    out, target = _logits(rng, 8)
    out[0, :] = 1.0  # a tie: the first maximum is class 0
    target[0] = 0
    loss = float(np.mean(out[:, 0]))
    masked_t = target.copy()
    masked_t[-2:] = -1
    per = out[:, 1]
    tstate = tmetrics.update_metric_state(
        tmetrics.init_metric_state(), torch.tensor(loss),
        torch.from_numpy(out), torch.from_numpy(target))
    tstate = tmetrics.update_metric_state_masked(
        tstate, torch.from_numpy(per), torch.from_numpy(out),
        torch.from_numpy(masked_t))
    jstate = jmetrics.update_metric_state(
        jmetrics.init_metric_state(), jnp.asarray(loss), jnp.asarray(out),
        jnp.asarray(target))
    jstate = jmetrics.update_metric_state_masked(
        jstate, jnp.asarray(per), jnp.asarray(out), jnp.asarray(masked_t))
    got = T.MetricAccumulator(state=tstate).compute()
    want = jmetrics.MetricAccumulator(state=jstate).compute()
    assert list(got) == list(want) == ['Loss', 'Top-1 Accuracy',
                                       'Top-5 Accuracy']
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **F32_TOL)
    assert float(tstate['count']) == 14.0


SCHEDULES = [
    {'scheduler': 'linear_lr', 'min_lr': 2e-7},
    {'scheduler': 'step_lr', 'step_size': 2, 'gamma': 0.1},
    {'scheduler': 'multi_step_lr', 'milestones': [1, 3], 'gamma': 0.5},
    {'scheduler': 'lambda_lr', 'lr_lambda': 'lambda s: 1 / (1 + s)',
     'allow_eval': True},
]


@pytest.mark.parametrize('cfg', SCHEDULES,
                         ids=[c['scheduler'] for c in SCHEDULES])
def test_lr_schedules(cfg):
    """Epoch settings rescaled to steps (steps_per_epoch 5, 4 epochs);
    linear_lr keeps the reference's lr0 - s/total*(lr0 + min_lr)."""
    cfg = dict(cfg, lr=2e-4)
    got = T.make_lr_schedule(cfg, 4, 5)
    want = joptim.make_lr_schedule(cfg, 4, 5)
    for step in range(0, 30):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-15)
    if cfg['scheduler'] == 'lambda_lr':
        with pytest.raises(ValueError, match='allow_eval'):
            T.make_lr_schedule(dict(cfg, allow_eval=False), 4, 5)
    with pytest.raises(ValueError, match='not supported'):
        T.make_lr_schedule({'scheduler': 'cosine', 'lr': 1.0}, 4, 5)


class _Params(nn.Module):
    def __init__(self, arrays: dict):
        super().__init__()
        for name, a in arrays.items():
            setattr(self, name, nn.Parameter(torch.from_numpy(a.copy())))


LINEAR = {'scheduler': 'linear_lr', 'min_lr': 1e-4}
OPTIMIZERS = {
    'sgd': {'algorithm': 'sgd', 'lr': 0.1},
    'sgd_nesterov_wd': {'algorithm': 'sgd', 'lr': 0.1, 'momentum': 0.9,
                        'nesterov': True, 'weight_decay': 1e-4},
    'sgd_momentum': {'algorithm': 'sgd', 'lr': 0.1, 'momentum': 0.9},
    'adam': {'algorithm': 'adam', 'lr': 2e-3, 'weight_decay': 0},
    'adam_wd': {'algorithm': 'adam', 'lr': 2e-3, 'weight_decay': 1e-2,
                'betas': [0.8, 0.99], 'eps': 1e-6},
    'adadelta': {'algorithm': 'adadelta', 'lr': 1.0},
    'adam_groups': {'algorithm': 'adam', 'lr': 2e-3, 'weight_decay': 1e-2,
                    'param_groups': {'quantized': {'lr_scale': 2.0,
                                                   'weight_decay': 0.0},
                                     'fp': {'lr_scale': 0.5}}},
    'sgd_groups': {'algorithm': 'sgd', 'lr': 0.1, 'momentum': 0.9,
                   'weight_decay': 1e-3,
                   'param_groups': {'quantized': {'lr_scale': 3.0}}},
}


@pytest.mark.parametrize('name', list(OPTIMIZERS))
def test_optimizers_over_steps(name):
    """Five updates from the same gradients, under linear_lr (steps per
    epoch 3, 3 epochs): parameters after every step against optax's
    (param_groups: 'w' quantized, 'b' fp)."""
    rng = np.random.default_rng(9)
    arrays = {'w': _f64(rng, (4, 3)).astype(np.float32),
              'b': _f64(rng, (5,)).astype(np.float32)}
    labels = {'w': 'quantized', 'b': 'fp'}
    config = {'optimizer': OPTIMIZERS[name], 'lr_scheduler': LINEAR}
    grouped = 'param_groups' in OPTIMIZERS[name]
    spec, schedule = T.make_optimizer(config, 3, 3,
                                      labels if grouped else None)
    tx, _ = joptim.make_optimizer(config, 3, 3, labels if grouped else None)
    model = _Params(arrays)
    state = T.TrainState.create(model, spec)
    params = {k: jnp.asarray(v) for k, v in arrays.items()}
    opt_state = tx.init(params)
    for step in range(5):
        grads = {k: _f64(rng, v.shape).astype(np.float32)
                 for k, v in arrays.items()}
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        spec.set_lr(state.optimizer, step)
        state.optimizer.step()
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), **OPT_TOL)
    assert schedule(0) == pytest.approx(OPTIMIZERS[name]['lr'])


def test_optimizer_errors():
    with pytest.raises(ValueError, match='not supported'):
        T.make_optimizer({'optimizer': {'algorithm': 'lamb'}}, 1, 1)
    groups = {'optimizer': {'algorithm': 'sgd', 'param_groups': {
        'quantized': {'lr_scale': 2.0}}}}
    with pytest.raises(ValueError, match='param labels'):
        T.make_optimizer(groups, 1, 1)
    bad = {'optimizer': {'algorithm': 'sgd', 'param_groups': {
        'fp': {'momentum': 0.5}}}}
    with pytest.raises(ValueError, match='Unknown param_groups'):
        T.make_optimizer(bad, 1, 1, {})


@pytest.mark.parametrize('family,x_quant,w_quant', [
    ('xnor', 'ls-1', 'ls-1'), ('regular_bottleneck', 'ls-2', 'fp'),
    ('lenet', 'ls-2', 'ls-1')])
def test_quantized_param_labels(family, x_quant, w_quant):
    """Exactly the kernels of quantizing convs are 'quantized', as the
    JAX labels of the same tree; every other parameter is 'fp'."""
    model = build(family, small_config(family, x_quant, w_quant),
                  device='cpu', generator=torch.Generator().manual_seed(0))
    got = tgroups.quantized_param_labels(model)
    want = jgroups.quantized_param_labels(to_jax_variables(model))
    flat = {'.'.join(k.key for k in path): label for path, label in
            jax.tree_util.tree_leaves_with_path(want)}
    quantized = sorted(k for k, v in got.items() if v == 'quantized')
    assert quantized == sorted(k for k, v in flat.items()
                               if v == 'quantized')
    assert len(got) == len(flat)
    assert bool(quantized) == (w_quant != 'fp')
