"""Offline serving-artifact preparation (port of quant_tpu/serving/prepare.py).

The worker's 'experiment' spec packs and folds a trained experiment in
every worker process at start-up. This module does that work once,
offline, and writes a self-contained serving artifact:

    <out_dir>/
      serving.yaml   — model section (architecture + arch_config),
                       input_shape, bn_fold flag, source checkpoint
      checkpoint_0   — the stripped variables (packed sign words, scales,
                       thresholds; no fp32 kernels of packed convs), a
                       port checkpoint (utils.checkpoints) in the JAX
                       variable-tree layout

Workers load it with the 'artifact' spec, with no export work.
Optionally it runs post-training EMA calibration first (needed for
folded serving of checkpoints trained with moving_average_mode 'off').
The serving.yaml is the JAX package's; the checkpoint is torch.save, not
orbax.

CLI:
    python -m quant_tpu_torch.serving.prepare --experiment DIR [--out DIR]
        [--input-shape H,W,C] [--device cuda|cpu]
        [--calibrate-dataset PATH [--calibrate-batches N]]
        [--calibrate-synthetic N]
"""

import argparse
import itertools
import logging
import pathlib
from typing import Any, Optional, Sequence

import torch
import yaml

from quant_tpu_torch.device import (
    DeviceLike, full_precision, resolve_device,
)

logger = logging.getLogger(__name__)


def serve_packed(model: torch.nn.Module, bn_fold: bool = False
                  ) -> torch.nn.Module:
    """The model in JAX's clone(inference_mode='packed', bn_fold=...)."""
    for m in model.modules():
        if hasattr(m, 'inference_mode'):
            m.inference_mode = 'packed'
    model.bn_fold = bn_fold
    return model


def load_experiment_model(experiment_dir: 'pathlib.Path | str',
                          device: DeviceLike = 'cuda'
                          ) -> tuple[torch.nn.Module, dict, pathlib.Path]:
    """(the model of the experiment's config.yaml with its latest
    checkpoint's model collections, the config's model section, the
    checkpoint's path)."""
    from quant_tpu_torch.train.task import build_model
    from quant_tpu_torch.utils.checkpoints import (
        get_path_to_checkpoint, restore_checkpoint,
    )
    from quant_tpu_torch.utils.jax_import import from_jax_variables

    experiment_dir = pathlib.Path(experiment_dir)
    cfg = yaml.safe_load((experiment_dir / 'config.yaml').read_text())
    model_cfg = dict(cfg['model'])
    model = build_model(model_cfg['architecture'],
                        dict(model_cfg.get('arch_config', {})),
                        device=resolve_device(device))
    ckpt = get_path_to_checkpoint(experiment_dir)
    payload = restore_checkpoint(ckpt)
    from_jax_variables(model, {col: payload.get(col, {}) for col in (
        'params', 'batch_stats', 'quant_state')})
    return model, model_cfg, ckpt


@full_precision()
def prepare_serving_artifact(
        experiment_dir: 'pathlib.Path | str',
        out_dir: Optional['pathlib.Path | str'] = None,
        input_shape: Sequence[int] = (224, 224, 3),
        calib_batches: Optional[Any] = None,
        device: DeviceLike = 'cuda') -> pathlib.Path:
    """Build the stripped (and folded) serving artifact of an experiment.

    Args:
        experiment_dir: trained experiment (config.yaml + checkpoints).
        out_dir: where to write (default <experiment>/serving).
        input_shape: per-example input shape the deployment serves.
        calib_batches: optional iterable of batches for post-training
            EMA calibration (nn.export.calibrate_ema_scales), needed for
            folded serving of 'off'-mode checkpoints.
        device: where the preparation runs ('cuda' unless 'cpu' is asked
            for); the artifact is the same tree either way. It runs
            under device.full_precision (TF32 off), the caller's flags
            back on return.

    Returns the artifact directory (out_dir).
    """
    from quant_tpu_torch.nn.export import (
        calibrate_ema_scales, export_packed_variables, fold_for_serving,
        strip_for_deployment,
    )
    from quant_tpu_torch.utils.checkpoints import save_checkpoint
    from quant_tpu_torch.utils.jax_import import to_jax_variables

    experiment_dir = pathlib.Path(experiment_dir)
    out = pathlib.Path(out_dir) if out_dir else experiment_dir / 'serving'
    model, model_cfg, ckpt = load_experiment_model(experiment_dir, device)
    arch_config = dict(model_cfg.get('arch_config', {}))

    if calib_batches is not None:
        model = calibrate_ema_scales(model, calib_batches)
        # The calibrated scales are read by EMA-mode serving only.
        arch_config['moving_average_mode'] = 'eval_only'

    serve_packed(model)
    export_packed_variables(model)
    _, bn_fold = fold_for_serving(model)
    strip_for_deployment(model)

    out.mkdir(parents=True, exist_ok=True)
    save_checkpoint(out, to_jax_variables(model), epoch=0)
    meta = {
        'model': {'architecture': model_cfg['architecture'],
                  'arch_config': arch_config},
        'input_shape': list(input_shape),
        'bn_fold': bn_fold,
        'source_checkpoint': str(ckpt),
    }
    (out / 'serving.yaml').write_text(yaml.safe_dump(meta))
    logger.info('serving artifact written to %s (bn_fold=%s)', out,
                bn_fold)
    return out


def load_serving_artifact(artifact_dir: 'pathlib.Path | str',
                          device: DeviceLike = 'cuda'
                          ) -> tuple[torch.nn.Module, tuple]:
    """-> (the packed serve-ready model on `device`, input_shape). The
    model holds the artifact's variables (JAX returns them beside it)."""
    from quant_tpu_torch.train.task import build_model
    from quant_tpu_torch.utils.checkpoints import restore_checkpoint
    from quant_tpu_torch.utils.jax_import import from_jax_variables

    artifact_dir = pathlib.Path(artifact_dir)
    meta = yaml.safe_load((artifact_dir / 'serving.yaml').read_text())
    model = build_model(meta['model']['architecture'],
                        dict(meta['model'].get('arch_config', {})),
                        device=resolve_device(device))
    serve_packed(model, bool(meta.get('bn_fold', False)))
    from_jax_variables(model, restore_checkpoint(
        artifact_dir / 'checkpoint_0'))
    return model, tuple(meta['input_shape'])


def calibration_batches(experiment_dir: 'pathlib.Path | str',
                        dataset_path: str, n: int) -> list:
    """The first n train batches of the experiment config's own data
    section, rebuilt against dataset_path (real-data calibration)."""
    from quant_tpu_torch.data import DATASET_REGISTRY

    cfg = yaml.safe_load(
        (pathlib.Path(experiment_dir) / 'config.yaml').read_text())
    data_cfg = dict(cfg.get('data', {}))
    loader_cls = DATASET_REGISTRY[data_cfg.pop('dataset')]
    data_cfg.pop('download', None)
    data_cfg['dataset_path'] = dataset_path
    loader = loader_cls(**data_cfg)
    try:
        return [x for x, _ in itertools.islice(
            iter(loader.get_train_loader()), n)]
    finally:
        loader.cleanup()


@full_precision()
def main(argv: Optional[list] = None) -> pathlib.Path:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--experiment', required=True)
    parser.add_argument('--out', default=None)
    parser.add_argument('--input-shape', default='224,224,3',
                        help='H,W,C the deployment serves')
    parser.add_argument('--device', default='cuda',
                        help="where the preparation runs: 'cuda' "
                             "(default) or 'cpu'")
    parser.add_argument('--calibrate-dataset', default=None,
                        help='dataset path for real-data EMA '
                             'calibration: the experiment config\'s own '
                             'data section is rebuilt against this path '
                             'and its train batches drive the observer '
                             'pass (preferred for off-mode checkpoints)')
    parser.add_argument('--calibrate-batches', type=int, default=10,
                        help='how many train batches to observe with '
                             '--calibrate-dataset')
    parser.add_argument('--calibrate-synthetic', type=int, default=0,
                        help='>0: run EMA calibration on N synthetic '
                             'batches of 16 N(0, 1) images (seeded; the '
                             'last resort when no calibration data is at '
                             'hand; prefer --calibrate-dataset)')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    shape = tuple(int(v) for v in args.input_shape.split(','))
    calib = None
    if args.calibrate_dataset:
        calib = calibration_batches(args.experiment, args.calibrate_dataset,
                                    args.calibrate_batches)
    elif args.calibrate_synthetic > 0:
        calib = [torch.randn((16,) + shape,
                             generator=torch.Generator().manual_seed(i))
                 for i in range(args.calibrate_synthetic)]
    out = prepare_serving_artifact(args.experiment, args.out,
                                   input_shape=shape, calib_batches=calib,
                                   device=args.device)
    print(out)
    return out


if __name__ == '__main__':
    main()
