"""Checkpoint save and restore (port of quant_tpu/utils/checkpoints.py;
orbax -> torch.save).

A checkpoint is one file, `checkpoints/checkpoint_{epoch}`, holding the
JAX payload's keys: `params`, `batch_stats` and `quant_state` in the
JAX variable-tree layout (`utils.jax_import.to_jax_variables`) as CPU
tensors, `opt_state` (the torch.optim optimizer's state_dict), `step`
(updates made, the schedule's input) and `epoch`; a serving artifact
holds the stripped tree (with `packed_params`) under the same name
rule. Everything loads under torch.load(weights_only=True).

A save writes a temporary file beside the target and os.replace()s it
into place, so an interrupted save leaves no file that matches
`_CKPT_RE` and never counts as finalized. The port never reads orbax
checkpoints (that needs JAX); a JAX tree, as numpy arrays, saves into a
port checkpoint with `tree_to_tensors`.

Three restore modes (train.task): full resume (model collections,
optimizer state, step, epoch), weights-only init (init_from_checkpoint)
and a teacher's weights.
"""

import logging
import os
import re
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r'checkpoint_(\d+)$')


def tree_to_tensors(tree: Any) -> Any:
    """Nested dicts (and lists) of arrays or tensors -> the same nesting
    of CPU tensors; other leaves (ints, floats, strings) as they are."""
    if isinstance(tree, dict):
        return {k: tree_to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_tensors(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


def save_checkpoint(checkpoints_dir: Path, state_dict: dict[str, Any],
                    epoch: int) -> Path:
    """Save `checkpoint_{epoch}` under checkpoints_dir; returns its path.
    Tensors and arrays are stored as CPU tensors."""
    checkpoints_dir = Path(checkpoints_dir).absolute()
    path = checkpoints_dir / f'checkpoint_{epoch}'
    checkpoints_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f'.checkpoint_{epoch}.',
                               suffix='.tmp', dir=str(checkpoints_dir))
    os.close(fd)
    try:
        torch.save(tree_to_tensors(state_dict), tmp)
        os.replace(tmp, path)  # atomic: never a half-written checkpoint
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    logger.info('Saved checkpoint to %s', path)
    return path


def restore_checkpoint(path: Path) -> dict:
    """Load a checkpoint file as CPU tensors (the payload carries its own
    structure: JAX's orbax target has no counterpart)."""
    return torch.load(Path(path).absolute(), map_location='cpu',
                      weights_only=True)


def _epochs(experiment_path: Path) -> dict[int, Path]:
    ckpt_dir = Path(experiment_path) / 'checkpoints'
    found = {}
    if ckpt_dir.is_dir():
        for p in ckpt_dir.iterdir():
            m = _CKPT_RE.search(p.name)
            if m:
                found[int(m.group(1))] = p
    return found


def has_finalized_checkpoint(experiment_path: Path) -> bool:
    """True when the experiment has a completed checkpoint_{N} (the
    `_CKPT_RE` rule: a save's temporary file does not count)."""
    return bool(_epochs(experiment_path))


def get_path_to_checkpoint(experiment_path: Path,
                           epoch: Optional[int] = None) -> Path:
    """Pick the checkpoint with the given (or max) epoch
    (reference checkpoints.py:107-136)."""
    found = _epochs(experiment_path)
    ckpt_dir = Path(experiment_path) / 'checkpoints'
    if not found:
        raise FileNotFoundError(f'No checkpoints under {ckpt_dir}')
    if epoch is not None:
        if epoch not in found:
            raise FileNotFoundError(f'No checkpoint_{epoch} under {ckpt_dir}')
        return found[epoch]
    return found[max(found)]
