"""float32 at full precision in the port's entry points
(device.full_precision): each entry point that runs a model runs with
TF32 off for float32 matmuls and cuDNN convs, the float32 the JAX
package computes, and puts the caller's flags back when it returns or
raises. The flags are process state that the CPU build sets too."""

from unittest import mock

import pytest
import torch

from quant_tpu_torch import examples
from quant_tpu_torch.device import full_precision, tf32_flags
from quant_tpu_torch.serving import prepare, worker
from quant_tpu_torch.train import task

CALLER = (True, True)
OFF = (False, False)


@pytest.fixture
def caller_flags():
    saved = tf32_flags()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = CALLER
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


class _Seen(Exception):
    """Raised by a patched inner call once it has read the flags."""


def _record_and_raise(seen: list):
    def inner(*args, **kwargs):
        seen.append(tf32_flags())
        raise _Seen()
    return inner


# (entry point, the inner name it calls first, its arguments)
ENTRY_POINTS = {
    'classification_task': (task.classification_task, (task, 'init_logging'),
                            ({'data': {}, 'model': {}, 'optimization': {},
                              'log': {}}, 'root')),
    'prepare_serving_artifact': (
        prepare.prepare_serving_artifact,
        (prepare, 'load_experiment_model'), ('exp',)),
    'prepare.main': (prepare.main, (prepare, 'prepare_serving_artifact'),
                     (['--experiment', 'exp', '--device', 'cpu'],)),
    'worker.main': (worker.main, (worker, 'build_engine_from_spec'),
                    (['--spec', __file__],)),
    'run_recipe': (examples.run_recipe, (examples, 'parse_config'),
                   ('recipe', None, ['--config', 'c.yaml'])),
}


@pytest.mark.parametrize('name', list(ENTRY_POINTS))
def test_entry_point_runs_with_tf32_off_and_restores(caller_flags, name):
    fn, (module, inner), args = ENTRY_POINTS[name]
    seen: list = []
    with mock.patch.object(module, inner, _record_and_raise(seen)), \
            mock.patch('json.loads', return_value={}), \
            pytest.raises(_Seen):
        fn(*args)
    assert seen == [OFF]
    assert tf32_flags() == CALLER


def test_build_engine_from_spec_prepares_with_tf32_off(caller_flags):
    """The whole build, returning normally: the seeded model is prepared
    with TF32 off, and the caller's flags are back after."""
    seen = []
    original = worker._seeded_model

    def seeded(kind, spec):
        seen.append(tf32_flags())
        return original(kind, spec)

    with mock.patch.object(worker, '_seeded_model', seeded):
        engine = worker.build_engine_from_spec(
            {'model': 'lenet_random', 'device': 'cpu', 'max_batch': 2})
    engine.stop()
    assert seen == [OFF]
    assert tf32_flags() == CALLER


def test_full_precision_nests_and_restores(caller_flags):
    with full_precision():
        assert tf32_flags() == OFF
        with full_precision():
            assert tf32_flags() == OFF
        assert tf32_flags() == OFF
    assert tf32_flags() == CALLER
