"""The port's config parsing against the JAX package's.

parse_config of quant_tpu_torch.config and quant_tpu.config give the
same dict on every recipe under examples/ and on each CLI combination
(the port adds config['device'], from its --device flag), raise the same
errors with the same messages, resume the same experiments under
--auto-resume and name an unnamed experiment alike. The port runs on
one card: nchips, tensor_parallel above 1 and multihost raise.
"""

import datetime
import glob

import pytest
import torch
import yaml

from quant_tpu.config import parser as jparser
from quant_tpu_torch.config import parser as tparser
from quant_tpu_torch.experiment import Experiment
from quant_tpu_torch.utils.checkpoints import save_checkpoint

RECIPES = sorted(glob.glob('examples/**/*.yaml', recursive=True))
MULTI_CHIP = 'examples/imagenet/imagenet_ls1_weight_ls2_activation_kd_tpu.yaml'


def both(argv):
    """(JAX's dict or exception, the port's), from one argv (JAX's
    without the port's --device flag)."""
    out = []
    for mod in (jparser, tparser):
        if mod is jparser and '--device' in argv:
            i = argv.index('--device')
            argv_mod = argv[:i] + argv[i + 2:]
        else:
            argv_mod = argv
        args = mod.get_base_argument_parser('t').parse_args(argv_mod)
        try:
            out.append(mod.parse_config(args))
        except (ValueError, NotImplementedError) as e:
            out.append(e)
    return out


def test_recipes_are_all_here():
    assert len(RECIPES) == 23 and MULTI_CHIP in RECIPES


@pytest.mark.parametrize('recipe', [r for r in RECIPES if r != MULTI_CHIP])
def test_every_recipe_parses_as_jax(recipe):
    want, got = both(['--config', recipe, '--experiment-name', 'x'])
    assert got.pop('device') == 'cuda'
    assert got == want


def test_multi_chip_recipe_raises_naming_slice_e():
    want, got = both(['--config', MULTI_CHIP, '--experiment-name', 'x'])
    assert want['environment']['nchips'] == 8
    assert isinstance(got, NotImplementedError)
    assert 'Slice E' in str(got) and 'nchips 8' in str(got)
    want, got = both(['--config', MULTI_CHIP, '--experiment-name', 'x',
                      '--nchips', '1', '--device', 'cpu'])
    assert got.pop('device') == 'cpu'
    assert got == want and got['environment']['nchips'] == 1


@pytest.mark.parametrize('environment,message', [
    ({'tensor_parallel': 2}, 'tensor_parallel 2'),
    ({'multihost': True}, 'multihost'),
    ({'ngpus': 4}, 'nchips 4'),
])
def test_parallel_environments_raise(tmp_path, environment, message):
    cfg = yaml.safe_load(open('examples/mnist/mnist_ls1.yaml'))
    cfg['environment'] = environment
    path = tmp_path / 'c.yaml'
    path.write_text(yaml.safe_dump(cfg))
    want, got = both(['--config', str(path)])
    assert isinstance(want, dict)
    assert isinstance(got, NotImplementedError) and message in str(got)


@pytest.mark.parametrize('argv', [
    [],
    ['--restore-experiment', 'e', '--init-from-checkpoint', 'c'],
    ['--config', 'c', '--auto-resume', '--restore-experiment', 'e'],
    ['--config', 'c', '--auto-resume', '--init-from-checkpoint', 'c'],
    ['--config', 'c', '--auto-resume'],
    ['--auto-resume', '--experiment-name', 'x'],
])
def test_cli_errors_are_jax_errors(argv):
    want, got = both(argv)
    assert isinstance(want, ValueError) and type(got) is type(want)
    assert str(got) == str(want)


@pytest.mark.parametrize('flags', [
    ['--skip-training'],
    ['--init-from-checkpoint', 'ckpt/checkpoint_3'],
    ['--nchips', '0'],
    ['--ngpus', '1', '--skip-training'],
])
def test_cli_overrides_are_jax_overrides(flags):
    want, got = both(['--config', 'examples/mnist/mnist_ls1.yaml',
                      '--experiment-name', 'x', *flags])
    got.pop('device')
    assert got == want


def test_ngpus_in_the_environment_becomes_nchips(tmp_path):
    cfg = yaml.safe_load(open('examples/mnist/mnist_ls1.yaml'))
    cfg['environment'] = {'platform': 'local', 'ngpus': 1}
    path = tmp_path / 'c.yaml'
    path.write_text(yaml.safe_dump(cfg))
    want, got = both(['--config', str(path), '--experiment-name', 'x'])
    got.pop('device')
    assert got == want and got['environment']['nchips'] == 1


class _Frozen(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


def test_default_experiment_name_is_jax_s(monkeypatch):
    monkeypatch.setattr(datetime, 'datetime', _Frozen)
    want, got = both(['--config', 'examples/mnist/mnist_ls1.yaml'])
    assert got['experiment_name'] == want['experiment_name'] == (
        '20260102-030405-mnist_ls1')


def _experiment(tmp_path, name='run'):
    cfg = yaml.safe_load(open('examples/mnist/mnist_ls1.yaml'))
    cfg['log']['root_experiments_dir'] = str(tmp_path / 'exps')
    path = tmp_path / 'c.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return path, tmp_path / 'exps' / name


def test_auto_resume_needs_a_finalized_checkpoint(tmp_path):
    path, exp_dir = _experiment(tmp_path)
    argv = ['--config', str(path), '--experiment-name', 'run',
            '--auto-resume']
    # No experiment yet: both start fresh.
    want, got = both(argv)
    assert 'restore_experiment' not in got and got.pop('device') == 'cuda'
    assert got == want
    # A save's temporary file does not count.
    ckpts = exp_dir / 'checkpoints'
    ckpts.mkdir(parents=True)
    (ckpts / '.checkpoint_3.abc.tmp').write_bytes(b'partial')
    want, got = both(argv)
    assert 'restore_experiment' not in got and 'restore_experiment' \
        not in want
    # A finalized checkpoint resumes from the experiment's config.yaml
    # (written by the run, edits to the original ignored).
    cfg = yaml.safe_load(path.read_text())
    cfg['experiment_name'] = 'run'
    cfg['optimization']['epochs'] = 99
    Experiment(lambda *a: ([], []), cfg).run()
    save_checkpoint(ckpts, {'epoch': 3, 'step': torch.tensor(7)}, 3)
    want, got = both(argv)
    assert got['restore_experiment'] == want['restore_experiment'] == str(
        exp_dir)
    assert got['optimization']['epochs'] == 99
    got.pop('device')
    assert got == want


def test_device_flag():
    _, got = both(['--config', 'examples/mnist/mnist_ls1.yaml',
                   '--device', 'cpu'])
    assert got['device'] == 'cpu'
