"""The port's config parsing against the JAX package's.

parse_config of quant_tpu_torch.config and quant_tpu.config give the
same dict on every recipe under examples/ and on each CLI combination
(the port adds config['device'], from its --device flag), raise the same
errors with the same messages, resume the same experiments under
--auto-resume and name an unnamed experiment alike. The port drives one
card a process: nchips above 1 in a single process raises; multihost
parses (data parallel over processes); tensor_parallel parses, a process
alone running unsharded as JAX does on one device, and a world it does
not divide is refused.
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
    # One process asked for two cards: the refusal names the way to run
    # them, one process a card.
    ({'nchips': 2}, 'multihost'),
    ({'ngpus': 4}, 'nchips 4'),
])
def test_parallel_environments_raise(tmp_path, environment, message):
    from unittest import mock
    cfg = yaml.safe_load(open('examples/mnist/mnist_ls1.yaml'))
    cfg['environment'] = environment
    path = tmp_path / 'c.yaml'
    path.write_text(yaml.safe_dump(cfg))
    want, got = both(['--config', str(path)])
    assert isinstance(want, dict)
    if 'tensor_parallel' in environment:
        # A process alone parses as JAX's and runs unsharded; a world of
        # 3 ranks, which tp = 2 does not divide, is refused.
        assert got.pop('device') == 'cuda' and got == want
        with mock.patch('torch.distributed.is_initialized',
                        return_value=True), \
                mock.patch('torch.distributed.get_world_size',
                           return_value=3):
            with pytest.raises(NotImplementedError, match=message):
                tparser.check_single_card(got)
        return
    assert isinstance(got, NotImplementedError) and message in str(got)


@pytest.mark.parametrize('world,tp,error', [
    (1, 2, None), (1, 4, None), (2, 2, None), (4, 2, None), (4, 4, None),
    (8, 2, None), (2, 4, 'does not divide'), (6, 4, 'does not divide'),
    (3, 2, 'does not divide')])
def test_tensor_parallel_is_held_to_the_world(world, tp, error):
    """JAX's make_mesh semantics: alone unsharded, a world tp divides
    gets the mesh (world / tp, tp), another world is refused."""
    from unittest import mock
    cfg = {'environment': {'tensor_parallel': tp}}
    with mock.patch('torch.distributed.is_initialized',
                    return_value=world > 1), \
            mock.patch('torch.distributed.get_world_size',
                       return_value=world):
        if error is None:
            tparser.check_single_card(cfg)
        else:
            with pytest.raises(NotImplementedError, match=error):
                tparser.check_single_card(cfg)


@pytest.mark.parametrize('nchips,error', [
    (0, None), (1, None), (2, None), (4, '2 processes')])
def test_nchips_is_held_to_the_joined_world(nchips, error):
    """A rank of a world of 2 (a pod worker, or multihost once joined)
    takes nchips 0 or 2, whatever the multihost flag says."""
    from unittest import mock
    from quant_tpu_torch.config.parser import check_single_card
    cfg = {'environment': {'nchips': nchips}}
    with mock.patch('torch.distributed.is_initialized', return_value=True), \
            mock.patch('torch.distributed.get_world_size', return_value=2):
        if error is None:
            check_single_card(cfg)
        else:
            with pytest.raises(NotImplementedError, match=error):
                check_single_card(cfg)


@pytest.mark.parametrize('environment', [
    {'multihost': True}, {'multihost': True, 'nchips': 4}])
def test_multihost_environment_parses_as_jax(tmp_path, environment):
    cfg = yaml.safe_load(open('examples/mnist/mnist_ls1.yaml'))
    cfg['environment'] = environment
    path = tmp_path / 'c.yaml'
    path.write_text(yaml.safe_dump(cfg))
    want, got = both(['--config', str(path)])
    assert got.pop('device') == 'cuda'
    assert got == want


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
