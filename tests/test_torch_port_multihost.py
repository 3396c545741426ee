"""The port's multi-process helpers (quant_tpu_torch/parallel/multihost.py,
mesh.py), mirroring tests/parallel/test_multihost.py case by case, with
the rank and world mocked, and the shard slices held to JAX's
host_shard and shard_loader_for_host on the same loader."""

from unittest import mock

import numpy as np
import pytest
import torch

from quant_tpu.data.loaders import BatchIterable as JBatchIterable
from quant_tpu.parallel import multihost as jmh
from quant_tpu_torch.data.loaders import BatchIterable
from quant_tpu_torch.parallel import make_mesh, multihost
from quant_tpu_torch.parallel.multihost import (
    collective_any, global_batch, host_shard, shard_loader_for_host,
)


def test_host_shard_partitions_dataset():
    n = 103
    pc = 4
    slices = [host_shard(n, pi, pc) for pi in range(pc)]
    assert slices[0][0] == 0
    assert slices[-1][1] == n
    covered = []
    for (a, b), (c, _) in zip(slices, slices[1:] + [(n, n)]):
        assert b == c
        covered.extend(range(a, b))
    assert covered == list(range(n))


def test_host_shard_uses_process_group_info():
    with mock.patch.object(multihost, 'rank', return_value=2), \
            mock.patch.object(multihost, 'world_size', return_value=8):
        assert host_shard(80) == (20, 30)


def test_host_shard_equal_mode_uniform_sizes():
    # equal=True: every process owns exactly n // pc rows (lockstep steps).
    n, pc = 103, 4
    slices = [host_shard(n, pi, pc, equal=True) for pi in range(pc)]
    assert [b - a for a, b in slices] == [25, 25, 25, 25]
    assert slices[-1][1] == 100  # remainder dropped


@pytest.mark.parametrize('n,pc', [(103, 4), (80, 8), (7, 2), (5, 5)])
@pytest.mark.parametrize('equal', [False, True])
def test_host_shard_equals_jax(n, pc, equal):
    for pi in range(pc):
        assert host_shard(n, pi, pc, equal=equal) == jmh.host_shard(
            n, pi, pc, equal=equal)


def test_shard_loader_for_host_disjoint_cover():
    """Each process's BatchIterable shard reads a disjoint slice; the
    union covers all but the dropped remainder, and every process yields
    the same number of equally-sized batches."""
    n, pc, bs = 130, 4, 32
    images = np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1)
    labels = np.arange(n)
    loader = BatchIterable(images, labels, bs, shuffle=False)
    shards = [shard_loader_for_host(loader, pi, pc) for pi in range(pc)]
    all_labels: list[int] = []
    batch_counts = []
    for sh in shards:
        batches = list(sh)
        batch_counts.append(len(batches))
        for x, y in batches:
            assert x.shape[0] == bs // pc
            all_labels.extend(int(v) for v in y)
    assert batch_counts == [batch_counts[0]] * pc
    assert len(all_labels) == len(set(all_labels))  # disjoint
    per = n // pc
    expected = set()
    for pi in range(pc):
        expected |= set(range(pi * per, pi * per + (per // (bs // pc))
                              * (bs // pc)))
    assert set(all_labels) == expected


@pytest.mark.parametrize('pad', [False, True])
def test_shard_loader_equals_jax_on_the_same_loader(pad):
    """The same arrays through both packages' sharding: the same rows,
    batch for batch, on every process (no shuffle: the two packages'
    shuffle backends differ)."""
    n, pc, bs = 33, 2, 16
    images = np.arange(n * 2, dtype=np.float32).reshape(n, 1, 1, 2)
    labels = np.arange(n)
    for pi in range(pc):
        got = list(shard_loader_for_host(
            BatchIterable(images, labels, bs, shuffle=False), pi, pc,
            pad=pad))
        want = list(jmh.shard_loader_for_host(
            JBatchIterable(images, labels, bs, shuffle=False), pi, pc,
            pad=pad))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_shard_loader_single_process_is_identity():
    images = np.zeros((8, 1, 1, 1), np.float32)
    loader = BatchIterable(images, np.arange(8), 4, shuffle=False)
    assert shard_loader_for_host(loader, 0, 1) is loader


class _Lazy:
    """A loader without in-memory arrays (e.g. the lazy ImageNet one)."""
    num_examples = 8

    def __init__(self):
        self.epochs = []

    def __len__(self):
        return 2

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        yield (np.arange(8).reshape(4, 2), np.arange(4))
        yield (np.arange(8, 16).reshape(4, 2), np.arange(4, 8))


def test_shard_loader_generic_wrapper_strides_rows():
    inner = _Lazy()
    s0 = shard_loader_for_host(inner, 0, 2)
    s1 = shard_loader_for_host(_Lazy(), 1, 2)
    rows0 = np.concatenate([y for _, y in s0])
    rows1 = np.concatenate([y for _, y in s1])
    np.testing.assert_array_equal(rows0, [0, 2, 4, 6])
    np.testing.assert_array_equal(rows1, [1, 3, 5, 7])
    assert s0.num_examples == 4
    s0.set_epoch(3)  # a restored run's epoch reaches the inner loader
    assert inner.epochs == [3]
    want = jmh.shard_loader_for_host(_Lazy(), 0, 2)
    np.testing.assert_array_equal(
        rows0, np.concatenate([y for _, y in want]))


def test_shard_loader_pad_covers_full_set_equal_shapes():
    """pad=True eval sharding: every process yields identically-shaped
    batches, the sentinel (-1) rows mark the padding, and the union of
    valid rows is exactly the full odd-sized set."""
    n, pc, bs = 33, 2, 16
    images = np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1)
    labels = np.arange(n)
    loader = BatchIterable(images, labels, bs, shuffle=False)
    per_host = [list(shard_loader_for_host(loader, pi, pc, pad=True))
                for pi in range(pc)]
    assert len(per_host[0]) == len(per_host[1])
    valid = []
    for batches in per_host:
        for b0, (x, y) in zip(per_host[0], batches):
            assert x.shape == b0[0].shape  # lockstep shapes
        for x, y in batches:
            valid.extend(int(v) for v in y if v >= 0)
    assert sorted(valid) == list(range(n))


def test_sharded_batches_ragged_tail_trim_and_pad():
    class Lazy:
        num_examples = 7

        def __len__(self):
            return 1

        def __iter__(self):
            yield (np.arange(14).reshape(7, 2).astype(np.float32),
                   np.arange(7))

    for pad in (False, True):
        (x0, y0), = list(shard_loader_for_host(Lazy(), 0, 2, pad=pad))
        (x1, y1), = list(shard_loader_for_host(Lazy(), 1, 2, pad=pad))
        assert x0.shape == x1.shape and y0.shape == y1.shape
        got = sorted(int(v) for v in np.concatenate([y0, y1]) if v >= 0)
        assert got == (list(range(7)) if pad else list(range(6)))


def test_masked_eval_equals_single_process_full_set():
    """evaluate() over 2-process padded shards (assembled in rank order)
    computes exactly the single-process full-set metrics."""
    from quant_tpu_torch import train as T

    rng = np.random.default_rng(0)
    n, ncls = 33, 5
    logits = rng.standard_normal((n, ncls)).astype(np.float32)
    labels = rng.integers(0, ncls, n)

    class Head(torch.nn.Module):
        """The first ncls inputs are the logits."""

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(()))

        def forward(self, x):
            return x.reshape(x.shape[0], -1)[:, :ncls]

    state = T.TrainState(model=Head(), optimizer=None, tx=None)
    eval_step = T.make_eval_step(T.get_loss_fn('cross_entropy'))
    images = logits.reshape(n, 1, 1, ncls)
    single = T.evaluate(eval_step, state,
                        BatchIterable(images, labels, 16, shuffle=False))
    loader = BatchIterable(images, labels, 16, shuffle=False)
    shards = [list(shard_loader_for_host(loader, pi, 2, pad=True))
              for pi in range(2)]
    assembled = [(np.concatenate([shards[0][b][0], shards[1][b][0]]),
                  np.concatenate([shards[0][b][1], shards[1][b][1]]))
                 for b in range(len(shards[0]))]
    sharded = T.evaluate(eval_step, state, assembled)
    for k in single:
        np.testing.assert_allclose(sharded[k], single[k], rtol=1e-6,
                                   err_msg=k)


def test_initialize_fails_hard_with_explicit_coordinator():
    with mock.patch.object(multihost, '_initialized', False), \
            mock.patch('torch.distributed.init_process_group',
                       side_effect=RuntimeError('no coordinator')):
        with pytest.raises(RuntimeError, match='coordinator'):
            multihost.initialize(coordinator_address='10.0.0.1:1234',
                                 num_processes=2, process_id=0,
                                 device='cpu')
        assert not multihost._initialized


def test_initialize_without_coordinator_stays_single(monkeypatch):
    for key in ('MASTER_ADDR', 'WORLD_SIZE', 'RANK'):
        monkeypatch.delenv(key, raising=False)
    with mock.patch.object(multihost, '_initialized', False), \
            mock.patch('torch.distributed.init_process_group') as init:
        multihost.initialize(device='cpu')
        assert multihost._initialized and not init.called
    assert multihost.world_size() == 1 and multihost.rank() == 0


@pytest.mark.parametrize('device,env,want', [
    ('cuda', None, 'nccl'), ('cpu', None, 'gloo'), ('cuda', 'gloo', 'gloo')])
def test_default_backend(monkeypatch, device, env, want):
    monkeypatch.delenv(multihost.BACKEND_ENV, raising=False)
    if env:
        monkeypatch.setenv(multihost.BACKEND_ENV, env)
    assert multihost.default_backend(device) == want


def test_global_batch_single_process_keeps_rows():
    local = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    arr = global_batch(local)
    assert isinstance(arr, torch.Tensor) and arr.device.type == 'cpu'
    np.testing.assert_array_equal(arr.numpy(), local)


def test_collective_any_single_process_is_local():
    assert collective_any(True) is True
    assert collective_any(False) is False


def test_collective_any_multiprocess_all_reduces_max():
    calls = []

    def fake_all_reduce(t, op):
        calls.append((int(t.item()), op))
        t.fill_(1)  # a peer raised the flag

    with mock.patch.object(multihost, 'world_size', return_value=2), \
            mock.patch('torch.distributed.get_backend',
                       return_value='gloo'), \
            mock.patch('torch.distributed.all_reduce', fake_all_reduce):
        assert collective_any(False) is True
    assert calls == [(0, torch.distributed.ReduceOp.MAX)]


def test_make_mesh_rejects_oversized_grid():
    with pytest.raises(ValueError, match='devices'):
        make_mesh(data=multihost.world_size() + 1, model=1,
                  device_type='cpu')


def test_make_mesh_refuses_a_model_axis_naming_part_2():
    """A 'model' axis is built (tests/test_torch_port_tp.py); one the
    ranks cannot fill is refused, since a rank cannot be dropped."""
    with pytest.raises(ValueError, match='needs 2 devices, have 1'):
        make_mesh(model=2, device_type='cpu')


def test_padded_shards_reject_float_targets():
    """pad=True marks pad rows with the integer sentinel -1; float
    targets fail loudly instead of being truncated to int."""
    class FloatTargets:
        num_examples = 3

        def __len__(self):
            return 1

        def __iter__(self):
            yield (np.zeros((3, 2), np.float32),
                   np.asarray([0.5, 1.5, 2.5], np.float32))

    sharded = shard_loader_for_host(FloatTargets(), 1, 2, pad=True)
    with pytest.raises(TypeError, match='integer classification'):
        list(sharded)
    trimmed = list(shard_loader_for_host(FloatTargets(), 0, 2, pad=False))
    assert trimmed[0][1].dtype == np.float32


def test_padded_shards_reject_unsigned_targets():
    """-1 wraps in unsigned dtypes, so pad rows would pass the metrics'
    target >= 0 mask as real examples: refuse."""
    class UnsignedTargets:
        num_examples = 3

        def __len__(self):
            return 1

        def __iter__(self):
            yield (np.zeros((3, 2), np.float32),
                   np.asarray([1, 2, 3], np.uint8))

    sharded = shard_loader_for_host(UnsignedTargets(), 1, 2, pad=True)
    with pytest.raises(TypeError, match='SIGNED'):
        list(sharded)
