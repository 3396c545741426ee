"""The port's checkpoints (utils/checkpoints.py): the torch.save form of
the JAX payload, the checkpoint_{epoch} naming and its selection rules,
atomic saves, and restoring into a model (train.task._restore_into),
strict and by path. The three restore modes run end to end in
tests/test_torch_port_task.py.
"""

import pickle

import numpy as np
import pytest
import torch

from quant_tpu_torch.probes.models import build, seed_state, small_config
from quant_tpu_torch.train import optim
from quant_tpu_torch.train.state import TrainState
from quant_tpu_torch.train.task import _restore_into
from quant_tpu_torch.utils import checkpoints as C
from quant_tpu_torch.utils.jax_import import to_jax_variables


class Opaque:
    """An object torch.load(weights_only=True) refuses."""


def lenet(seed=0, **kw):
    gen = torch.Generator().manual_seed(seed)
    model = build('lenet', {**small_config('lenet', 'ls-2', 'ls-1'), **kw},
                  device='cpu', generator=gen)
    seed_state(model, gen)
    return model


def tensors_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(tensors_equal, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_round_trip_of_a_train_payload(tmp_path):
    model = lenet()
    spec, _ = optim.make_optimizer(
        {'optimizer': {'algorithm': 'adam', 'lr': 1e-3}}, 2, 3)
    state = TrainState.create(model, spec)
    model.train()(torch.randn(2, 28, 28, 1)).sum().backward()
    state.optimizer.step()
    tree = to_jax_variables(model)
    payload = {'params': tree['params'], 'batch_stats': tree['batch_stats'],
               'quant_state': tree['quant_state'],
               'opt_state': state.optimizer.state_dict(), 'step': 5,
               'epoch': 2}
    path = C.save_checkpoint(tmp_path / 'checkpoints', payload, 2)
    assert path == tmp_path / 'checkpoints' / 'checkpoint_2'
    got = C.restore_checkpoint(path)
    assert got['step'] == 5 and got['epoch'] == 2
    assert tensors_equal(got['opt_state'], C.tree_to_tensors(
        state.optimizer.state_dict()))
    assert tensors_equal({k: got[k] for k in tree if k in got},
                         C.tree_to_tensors(tree))
    assert all(t.device.type == 'cpu' for t in
               got['params']['conv2'].values())
    # weights_only: a payload with an arbitrary object does not load.
    torch.save({'x': Opaque()}, tmp_path / 'checkpoint_9')
    with pytest.raises(pickle.UnpicklingError):
        C.restore_checkpoint(tmp_path / 'checkpoint_9')


def test_a_jax_tree_saves_as_a_port_checkpoint(tmp_path):
    tree = to_jax_variables(lenet(1))  # numpy arrays, as JAX's device_get
    C.save_checkpoint(tmp_path, tree, 0)
    model = _restore_into(lenet(2), C.restore_checkpoint(
        tmp_path / 'checkpoint_0'))
    assert tensors_equal(C.tree_to_tensors(to_jax_variables(model)),
                         C.tree_to_tensors(tree))


def test_an_interrupted_save_never_counts(tmp_path, monkeypatch):
    exp = tmp_path / 'exp'
    ckpts = exp / 'checkpoints'
    assert not C.has_finalized_checkpoint(exp)
    C.save_checkpoint(ckpts, {'epoch': 1}, 1)

    def killed(obj, f):
        with open(f, 'wb') as fh:
            fh.write(b'half')
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, 'save', killed)
    with pytest.raises(KeyboardInterrupt):
        C.save_checkpoint(ckpts, {'epoch': 3}, 3)
    assert sorted(p.name for p in ckpts.iterdir()) == ['checkpoint_1']
    (ckpts / '.checkpoint_5.x.tmp').write_bytes(b'left by a killed save')
    assert C.get_path_to_checkpoint(exp) == ckpts / 'checkpoint_1'
    only_tmp = tmp_path / 'other' / 'checkpoints'
    only_tmp.mkdir(parents=True)
    (only_tmp / '.checkpoint_2.y.tmp').write_bytes(b'')
    assert not C.has_finalized_checkpoint(only_tmp.parent)
    with pytest.raises(FileNotFoundError):
        C.get_path_to_checkpoint(only_tmp.parent)


def test_the_largest_epoch_is_picked(tmp_path):
    for epoch in (2, 10, 9):
        C.save_checkpoint(tmp_path / 'checkpoints', {'epoch': epoch}, epoch)
    assert C.has_finalized_checkpoint(tmp_path)
    assert C.get_path_to_checkpoint(tmp_path).name == 'checkpoint_10'
    assert C.get_path_to_checkpoint(tmp_path, 9).name == 'checkpoint_9'
    with pytest.raises(FileNotFoundError, match='checkpoint_4'):
        C.get_path_to_checkpoint(tmp_path, 4)
    # Saving an epoch again overwrites its one slot.
    C.save_checkpoint(tmp_path / 'checkpoints', {'epoch': 99}, 10)
    assert C.restore_checkpoint(C.get_path_to_checkpoint(tmp_path)) == {
        'epoch': 99}


def test_restore_strict_and_by_path():
    src = to_jax_variables(lenet(3))
    # Strict: another structure raises, naming the leaves.
    bad = {'params': dict(src['params'], extra={'kernel': np.zeros(2)})}
    with pytest.raises(ValueError, match='unexpected'):
        _restore_into(lenet(4), bad)
    # By path: a missing or reshaped leaf keeps the model's value.
    partial = {'params': {k: v for k, v in src['params'].items()
                          if k != 'fc2'}}
    partial['params']['fc1'] = dict(partial['params']['fc1'],
                                    bias=np.zeros(3, np.float32))
    fresh = lenet(4)
    before = to_jax_variables(fresh)['params']
    got = to_jax_variables(_restore_into(fresh, partial,
                                         strict_keys=False))['params']
    np.testing.assert_array_equal(got['fc2']['kernel'],
                                  before['fc2']['kernel'])
    np.testing.assert_array_equal(got['fc1']['bias'], before['fc1']['bias'])
    np.testing.assert_array_equal(got['fc1']['kernel'],
                                  src['params']['fc1']['kernel'])
    np.testing.assert_array_equal(got['conv2']['kernel'],
                                  src['params']['conv2']['kernel'])
