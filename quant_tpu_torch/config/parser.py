"""YAML config schema and CLI parsing (port of quant_tpu/config/parser.py).

The schema is the JAX package's (and the reference's): sections seed,
environment, data, model (with arch_config and kd_config), optimization
and log; the recipes under examples/ load unchanged. The CLI flags,
their validation errors, the --auto-resume rule and the experiment-name
default are the JAX package's, plus one flag: --device ('cuda' by
default, 'cpu' only when asked for), which plays the role of
JAX_PLATFORMS and lands in config['device'].

The port drives one card a process (`check_single_card`):
environment.multihost runs data parallel over processes, each one rank;
environment.tensor_parallel shards the model over 'model' groups of that
many ranks, and a process alone runs it unsharded; nchips above 1 in a
single process raises NotImplementedError. nchips 0 (all visible) and 1
run on the one card.
"""

import argparse
import datetime
import logging
from pathlib import Path

import yaml

logger = logging.getLogger(__name__)


def get_base_argument_parser(description: str = '') -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('--config', type=str,
                        help='Path to YAML experiment config')
    parser.add_argument('--experiment-name', type=str,
                        help='Name of the experiment directory')
    parser.add_argument('--nchips', '--ngpus', dest='nchips', type=int,
                        default=None,
                        help='Number of devices to use (0 = all visible)')
    parser.add_argument('--skip-training', action='store_true',
                        help='Evaluate only')
    parser.add_argument('--restore-experiment', type=str, default=None,
                        help='Path to an experiment dir to fully resume')
    parser.add_argument('--init-from-checkpoint', type=str, default=None,
                        help='Checkpoint to warm-start weights from')
    parser.add_argument('--auto-resume', action='store_true',
                        help='Resume the named experiment if it already '
                             'has checkpoints, else start fresh — the '
                             'same command line works before and after '
                             'a preemption')
    parser.add_argument('--device', type=str, default='cuda',
                        help="Device to run on: 'cuda' (default) or "
                             "'cpu'")
    return parser


def parse_common_fields(args: argparse.Namespace) -> None:
    """Validate CLI combinations (reference parser.py:151-162)."""
    if args.config is None and args.restore_experiment is None:
        raise ValueError('--config is required unless restoring '
                         'an experiment.')
    if args.restore_experiment and args.init_from_checkpoint:
        raise ValueError('--restore-experiment and --init-from-checkpoint '
                         'are mutually exclusive.')
    if getattr(args, 'auto_resume', False):
        if args.restore_experiment or args.init_from_checkpoint:
            raise ValueError('--auto-resume is mutually exclusive with '
                             '--restore-experiment / '
                             '--init-from-checkpoint.')
        if not args.config or not args.experiment_name:
            raise ValueError('--auto-resume needs --config and '
                             '--experiment-name (the stable identity the '
                             'relaunched command resumes).')


def check_single_card(config: dict) -> None:
    """Raise NotImplementedError for an environment the port cannot run:
    a tensor_parallel that does not divide the world, or an nchips this
    process cannot take.

    tensor_parallel follows JAX's make_mesh: a process alone runs
    unsharded (JAX's task has no mesh on one device), a world that tp
    divides gets the mesh (world / tp, tp), and a world where JAX would
    drop devices is refused, since a rank cannot be dropped.

    The port drives one card a process; data parallelism over several
    cards is several processes (environment.multihost, or
    platform.PodComputePlatform). So nchips is held to the world the
    process has joined (torch.distributed): 0 or 1 for a process alone,
    0 or the world's size for a rank. A multihost config that has not
    joined its world yet (the CLI's parse_config) is checked again by
    train.task once it has."""
    import torch.distributed as dist
    env = config.get('environment', {})
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    tp = int(env.get('tensor_parallel', 1) or 1)
    if tp < 1 or (world > 1 and world % tp):
        raise NotImplementedError(
            f'environment tensor_parallel {tp}: the run has {world} '
            f'processes of one card each, which {tp} does not divide '
            '(a rank cannot be left out of the mesh); set tensor_parallel '
            f'to a divisor of {world}.')
    nchips = int(env.get('nchips', 0) or 0)
    if nchips <= 1:
        return
    if not joined and env.get('multihost'):
        return
    if world == nchips:
        return
    if world > 1:
        raise NotImplementedError(
            f'environment nchips {nchips}: the run has {world} processes '
            f'of one card each; set nchips to 0 or {world}.')
    raise NotImplementedError(
        f'environment nchips {nchips}: this single process drives one '
        f'card and cannot take {nchips}; data parallelism over '
        f'{nchips} cards is {nchips} processes of one card each '
        '(Slice E part 1: environment.multihost, or '
        f'PodComputePlatform(n_processes={nchips})), or set nchips to '
        '0 or 1.')


def _default_experiment_name(config_path: str) -> str:
    stamp = datetime.datetime.now().strftime('%Y%m%d-%H%M%S')
    return f'{stamp}-{Path(config_path).stem}'


def parse_config(args: argparse.Namespace) -> dict:
    """Merge the YAML config with the CLI's overrides (reference
    parser.py:196-224); restoring an experiment reloads the config.yaml
    the experiment wrote."""
    parse_common_fields(args)

    if getattr(args, 'auto_resume', False):
        # Resume iff the named experiment already has a finalized
        # checkpoint; the restore path then reloads its config.yaml
        # (edits to the original YAML are ignored on resume, as with an
        # explicit --restore-experiment).
        with open(args.config) as f:
            raw = yaml.safe_load(f)
        root = Path(raw.get('log', {}).get('root_experiments_dir',
                                           'experiments/'))
        exp_dir = root / args.experiment_name
        from quant_tpu_torch.utils.checkpoints import has_finalized_checkpoint
        if has_finalized_checkpoint(exp_dir):
            args.restore_experiment = str(exp_dir)

    if args.restore_experiment is not None:
        config_path = Path(args.restore_experiment) / 'config.yaml'
    else:
        config_path = Path(args.config)

    with open(config_path) as f:
        config = yaml.safe_load(f)

    if args.experiment_name:
        config['experiment_name'] = args.experiment_name
    elif args.restore_experiment is not None:
        config.setdefault('experiment_name',
                          Path(args.restore_experiment).name)
    else:
        config.setdefault('experiment_name',
                          _default_experiment_name(str(config_path)))

    env = config.setdefault('environment', {})
    if args.nchips is not None:
        env['nchips'] = args.nchips
    elif 'nchips' not in env and 'ngpus' in env:
        env['nchips'] = env['ngpus']
    check_single_card(config)

    if args.skip_training:
        config['skip_training'] = True
    if args.init_from_checkpoint:
        config['init_from_checkpoint'] = args.init_from_checkpoint
    if args.restore_experiment:
        config['restore_experiment'] = args.restore_experiment
    config['device'] = getattr(args, 'device', None) or 'cuda'
    return config
