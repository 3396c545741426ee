"""The port's train engine around the step: KD with a train-mode
teacher, remat, the stem pool under autograd,
evaluate and train_epoch, a JAX TrainState trained on in the port, and
serving after training (every module is built in eval mode).

Models are probes.models.small_config's (width 8, 32 px; LeNet-5 28
px) seeded by probes.models.seed_state, batch 4, unless a test says
otherwise.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.nn import QResNet as JQResNet
from quant_tpu.train import engine as jengine
from quant_tpu.train import kd as jkd
from quant_tpu.train import losses as jlosses
from quant_tpu.train import metrics as jmetrics
from quant_tpu.train import optim as joptim
from quant_tpu.train import state as jstate
from quant_tpu_torch import train as T
from quant_tpu_torch.nn import resnet as tresnet
from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1
from quant_tpu_torch.probes import models, train_profile
from quant_tpu_torch.serving.engine import InferenceEngine
from quant_tpu_torch.train.kd import make_teacher_apply
from quant_tpu_torch.train.metrics import init_metric_state
from quant_tpu_torch.utils.jax_import import (
    from_jax_variables, to_jax_variables,
)
from tests.test_torch_port_train_step import (
    LOSS_TOL, OPT, assert_grads_close, images, jax_grads,
    leaves, port_grads, seeded,
)

KD = dict(temperature=1.0, teacher_correction=False)


def test_kd_step_with_a_train_mode_teacher():
    """The recipes' KD: a frozen teacher (regular, fp x fp) in train
    mode (BN on the batch's statistics), pure KD at temperature 1. Loss
    and student gradients as JAX's step; the teacher's parameters and
    state unchanged, as JAX throws its mutated collections away."""
    student = seeded('xnor', 'ls-1', 'ls-1')
    teacher = seeded('regular', 'fp', 'fp', seed=1)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    x, y = images('xnor')
    variables = to_jax_variables(student)
    tvars = to_jax_variables(teacher)
    jt = JQResNet(**models.small_config('regular', 'fp', 'fp'))
    js = JQResNet(**models.small_config('xnor', 'ls-1', 'ls-1'))

    def jteacher(data: jax.Array) -> jax.Array:
        out, _ = jt.apply(tvars, data, True,
                          mutable=['batch_stats', 'quant_state'])
        return jax.lax.stop_gradient(out)

    def jloss(out: jax.Array, t_out: jax.Array,
              target: jax.Array) -> jax.Array:
        return jkd.kd_criterion(out, t_out, target, **KD)

    def loss_for(params: dict) -> jax.Array:
        out, _ = js.apply({**variables, 'params': params}, jnp.asarray(x),
                          True, mutable=['batch_stats', 'quant_state'])
        return jloss(out, jteacher(jnp.asarray(x)), jnp.asarray(y))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_for))(
        variables['params'])
    spec, _ = T.make_optimizer(OPT, 3, 4)
    state = T.TrainState.create(student, spec)
    step = T.make_train_step(
        functools.partial(T.kd_criterion, **KD),
        make_teacher_apply(teacher, train_mode=True))
    _, _, loss = step(state, torch.from_numpy(x), torch.from_numpy(y),
                      init_metric_state())
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    assert_grads_close(port_grads(student), want_grads)
    after = teacher.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert all(p.grad is None for p in teacher.parameters())
    # The eval-mode teacher of a recipe without train_mode.
    with torch.no_grad():
        want = teacher.eval()(torch.from_numpy(x))
    np.testing.assert_array_equal(make_teacher_apply(teacher)(
        torch.from_numpy(x)).numpy(), want.numpy())


@pytest.mark.parametrize('train_dtype', [None, torch.bfloat16])
def test_remat_is_exact(train_dtype):
    """remat on against off (ls-2 activations, 'train_and_eval', whose
    EMA a recomputation would blend again): one step each from the same
    state gives equal loss, gradients, parameters and state, bit for
    bit; each block's forward starts twice with remat (the recomputation
    stops once it has every saved tensor back)."""
    base = seeded('xnor', 'ls-2', 'ls-1',
                  moving_average_mode='train_and_eval')
    base.train_dtype = train_dtype
    x, y = images('xnor')
    runs = []
    for remat in (False, True):
        model = copy.deepcopy(base)
        model.remat = remat
        calls = []
        hooks = [blk.register_forward_pre_hook(lambda *a: calls.append(1))
                 for _, blk in model.blocks()]
        spec, _ = T.make_optimizer(OPT, 3, 4)
        state = T.TrainState.create(model, spec)
        step = T.make_train_step(T.get_loss_fn('cross_entropy'))
        _, _, loss = step(state, torch.from_numpy(x), torch.from_numpy(y),
                          init_metric_state())
        for h in hooks:
            h.remove()
        assert len(calls) == 4 * (2 if remat else 1)
        runs.append((loss, [p.grad for p in model.parameters()],
                     model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert any(not torch.equal(s0[k], v) for k, v in
               base.state_dict().items())


def test_stem_pool_never_launches_the_kernel_under_autograd(monkeypatch):
    """Train forwards with grad take the differentiable pool; the kernel
    (no backward) serves eval and no-grad forwards, and refuses a tensor
    whose gradient would be needed."""
    calls = []
    monkeypatch.setattr(tresnet, 'max_pool_3x3_s2_p1',
                        lambda x: calls.append(1) or max_pool_3x3_s2_p1(x))
    model = seeded('xnor', 'ls-1', 'ls-1')
    x = torch.from_numpy(images('xnor')[0])
    model.train()
    model(x).sum().backward()
    assert calls == [] and model.conv1.kernel.grad.abs().sum() > 0
    with torch.no_grad():
        model(x)
    model.eval()
    model(x)
    assert calls == [1, 1]
    with pytest.raises(RuntimeError, match='no backward'):
        max_pool_3x3_s2_p1(torch.zeros(1, 4, 4, 2, requires_grad=True))


def _loader(x: np.ndarray, y: np.ndarray, sizes: list[int]) -> list:
    edges = np.cumsum([0] + sizes)
    return [(x[a:b], y[a:b]) for a, b in zip(edges[:-1], edges[1:])]


def test_evaluate_with_padded_rows_matches_jax():
    """Batches of 5 and 3 padded to multiples of 4 with target -1 rows:
    the masked metrics cover exactly the 8 real images, as JAX's
    evaluate with pad_rows_to, and as the unpadded evaluation."""
    model = seeded('xnor', 'ls-1', 'ls-1', inference_mode='dense')
    x, y = images('xnor', n=8)
    loader = _loader(x, y, [5, 3])
    spec, _ = T.make_optimizer(OPT, 3, 4)
    state = T.TrainState.create(model, spec)
    step = T.make_eval_step(T.get_loss_fn('cross_entropy'))
    seen = []
    got = T.evaluate(step, state, loader, pad_rows_to=4,
                     hooks=[lambda epoch, global_step, metrics: seen.append(
                         (global_step, metrics['test'].compute()))])
    assert T.evaluate(step, state, loader) == pytest.approx(got, rel=1e-6)
    jm = JQResNet(**models.small_config('xnor', 'ls-1', 'ls-1'))
    tx, _ = joptim.make_optimizer(OPT, 3, 4)
    jst = jstate.TrainState.create(jm.apply, to_jax_variables(model), tx)
    want = jengine.evaluate(jengine.make_eval_step(jlosses.cross_entropy),
                            jst, loader, pad_rows_to=4)
    assert list(got) == list(want)
    np.testing.assert_allclose(got['Loss'], want['Loss'], rtol=1e-5)
    assert got['Top-1 Accuracy'] == want['Top-1 Accuracy']
    assert got['Top-5 Accuracy'] == want['Top-5 Accuracy']
    assert seen == [(2, got)]
    assert not model.training


def test_train_epoch_hooks_stop_and_lr():
    """train_epoch over numpy batches: the hooks of both protocols see
    each step's learning rate (the schedule at the step just taken) and
    the live metrics; `stop` ends the epoch before the third batch."""
    model = seeded('lenet', 'ls-2', 'ls-1')
    x, y = images('lenet', n=12)
    spec, schedule = T.make_optimizer(OPT, 3, 4)
    state = T.TrainState.create(model, spec)
    step = T.make_train_step(T.get_loss_fn('nll_loss'))
    new, old = [], []

    def new_hook(epoch: int, global_step: int, values_dict: dict,
                 log_interval: int, metrics: dict) -> None:
        new.append((global_step, values_dict['lr'],
                    metrics['train'].compute()['Loss']))

    def old_hook(epoch: int, global_step: int, values_dict: dict,
                 log_interval: int) -> None:
        old.append(global_step)

    state, computed = T.train_epoch(
        step, state, _loader(x, y, [4, 4, 4]), epoch=2,
        hooks=[new_hook, old_hook], lr_schedule=schedule,
        steps_per_epoch=4, stop=lambda: len(old) == 2)
    assert state.step == 2 and old == [5, 6]
    assert [lr for _, lr, _ in new] == [schedule(0), schedule(1)]
    want = joptim.make_lr_schedule(dict(OPT['lr_scheduler'], lr=0.05), 3, 4)
    assert [lr for _, lr, _ in new] == [float(want(0)), float(want(1))]
    assert np.isfinite(computed['Loss']) and computed['Loss'] == new[-1][2]
    assert model.training


def test_a_jax_train_state_trains_on_in_the_port():
    """JAX's own init and one JAX step; its params, batch_stats and
    quant_state load into the port as trainable parameters, and the next
    step on both sides agrees (loss, gradients, new state)."""
    cfg = models.small_config('xnor', 'ls-1', 'ls-1')
    jm = JQResNet(**cfg)
    x, y = images('xnor')
    variables = jax.jit(jm.init, static_argnums=2)(
        jax.random.key(3), jnp.asarray(x[:2]), True)
    tx, _ = joptim.make_optimizer(OPT, 3, 4)
    jst = jstate.TrainState.create(jm.apply, variables, tx)
    jstep = jengine.make_train_step(jlosses.cross_entropy, donate=False)
    metric = jmetrics.init_metric_state()
    jst, metric, _ = jstep(jst, jnp.asarray(x), jnp.asarray(y), metric)
    tree = jax.tree.map(np.array, {'params': jst.params,
                                   'batch_stats': jst.batch_stats,
                                   'quant_state': jst.quant_state})
    model = from_jax_variables(models.build('xnor', cfg, device='cpu'),
                               tree)
    assert all(p.requires_grad for p in model.parameters())
    back = to_jax_variables(model)
    for coll in tree:
        for name, leaf in leaves(tree[coll]).items():
            np.testing.assert_array_equal(leaves(back[coll])[name], leaf)
    want_loss, want_grads = jax_grads(jm, tree, jlosses.cross_entropy, x, y)
    spec, _ = T.make_optimizer(OPT, 3, 4)
    state = T.TrainState.create(model, spec)
    state.step = 1
    step = T.make_train_step(T.get_loss_fn('cross_entropy'))
    _, _, loss = step(state, torch.from_numpy(x), torch.from_numpy(y),
                      init_metric_state())
    np.testing.assert_allclose(loss.item(), want_loss, **LOSS_TOL)
    assert_grads_close(port_grads(model), want_grads)


SERVED = {
    'resnet18_xnor_ls1': (models.bench_resnet18, 'ls-1', 'ls-1',
                          dict(moving_average_mode='eval_only'), (64, 64, 3)),
    'resnet18_regular_ls1': (functools.partial(models.bench_resnet18,
                                               block='regular'),
                             'ls-1', 'ls-1',
                             dict(moving_average_mode='eval_only'),
                             (64, 64, 3)),
    'resnet50_ls2_ls1_off': (models.resnet50_cifar, 'ls-2', 'ls-1',
                             dict(moving_average_mode='off'), (32, 32, 3)),
    'lenet5_ls2_ls1': (models.lenet5, 'ls-2', 'ls-1',
                       dict(moving_average_mode='eval_only'), (28, 28, 1)),
}


@pytest.mark.parametrize('name', list(SERVED))
def test_models_serve_alike_after_a_train_step(name):
    """Every builder of probes.models returns an eval-mode model. After
    a train step and .eval(), the model prepares and serves (engine
    included) bit for bit as a freshly built one holding the same
    state."""
    make, x_quant, w_quant, kw, hwc = SERVED[name]
    model = models.seeded_model(make, x_quant, w_quant, 'cpu', 0,
                                prepare=False, **kw)
    assert not any(m.training for m in model.modules())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2,) + hwc).astype(np.float32)
    y = rng.integers(0, 10, 2)
    spec, _ = T.make_optimizer(OPT, 3, 4)
    step = T.make_train_step(T.get_loss_fn(
        'nll_loss' if name.startswith('lenet') else 'cross_entropy'))
    step(T.TrainState.create(model, spec), torch.from_numpy(x),
         torch.from_numpy(y), init_metric_state())
    assert all(m.training for m in model.modules())
    fresh = make(x_quant, w_quant, device='cpu', **kw)
    fresh.load_state_dict(model.state_dict())
    model.eval()
    for m in (model, fresh):
        models.prepare_for_serving(m)
    got = model(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  fresh(torch.from_numpy(x)).numpy())
    engine = InferenceEngine(model, hwc, max_batch=2, device='cpu')
    np.testing.assert_array_equal(engine.predict(x), got.numpy())


def test_train_profile_configs_and_kernel_classes():
    """The recipes' train configurations build eval-mode students with
    their options and teachers in their dtype; kernels sort into classes
    by name."""
    student, teacher = train_profile.build('ls2_ls1_kd_tpu', 0, 'cpu')
    assert not student.training and not teacher.training
    assert student.remat and student.train_dtype == torch.bfloat16
    assert teacher.train_dtype == teacher.eval_dtype == torch.bfloat16
    assert student.layer1_block0.conv1.solver_mode == 'lloyd'
    assert student.moving_average_mode == 'off'
    assert teacher.layer1_block0.conv1.w_quant == 'fp'
    names = {
        'sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32': 'conv',
        'cudnn::bn_fw_tr_1C11_kernel_NCHW': 'conv',
        'void at::native::vectorized_elementwise_kernel<4>': 'elementwise',
        'void at::native::reduce_kernel<512, 1>': 'reduction',
        'void at::native::(anonymous)::multi_tensor_apply_kernel': 'optimizer',
        'Memcpy DtoD (Device -> Device)': 'copy',
        'void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel': 'sort',
        'mystery': 'other'}
    for name, cls in names.items():
        assert train_profile.kernel_class(name) == cls, name
