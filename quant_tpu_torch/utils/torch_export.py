"""Export the JAX variable tree to reference (apple/ml-quant, PyTorch)
state dicts (port of quant_tpu/utils/torch_export.py; numpy only, the
port's own copy of the maps).

The inverse of utils/torch_import.py: a model trained with the port is
handed to the reference stack through its tree,
`export_state_dict(arch, to_jax_variables(model), arch_config)` (the
reference loads plain ``model.load_state_dict`` payloads,
quant/utils/checkpoints.py:54-104).

Outputs {name: numpy array} keyed exactly like the reference module
trees (quant/models/resnet.py:283-340, lenet.py:38-64), including the
reference's duplicated stem aliases (QResNet registers conv1/bn1 both as
attributes and inside ``blocks.0``, so its state_dict carries both name
sets for the same tensors). Layout conversions mirror the import:

  * HWIO kernel (kh, kw, I, O)  -> conv weight (O, I, kh, kw)
  * (in, out) dense kernel      -> linear weight (out, in)
  * params .scale/.bias + batch_stats .mean/.var -> BN
    weight/bias/running_mean/running_var (+ int64 num_batches_tracked,
    synthesized: the tree's BN does not count batches; only torch's
    momentum=None mode reads it)
  * negative_slope ()           -> PReLU weight (1,)
  * quant_state w_quantizer.vs (k, O) -> v1..vk buffers
  * x_quantizer.{ema, ema_count} -> moving_avg_module.{moving_average,
    num_batches_tracked} (+ the reference's per-scale momentum buffer,
    filled from `momentum`)

``numpy_to_state_dict`` wraps the arrays in torch tensors for
``torch.save``.
"""

from typing import Any, Mapping, Optional

import numpy as np
import torch

from quant_tpu_torch.ops.quantize import scheme_num_scales

__all__ = ['export_resnet_state_dict', 'export_lenet_state_dict',
           'numpy_to_state_dict']


def numpy_to_state_dict(sd: Mapping[str, np.ndarray]) -> dict:
    """Wrap {name: ndarray} as {name: torch.Tensor} (CPU tensors)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _get(tree: Mapping[str, Any], path: list[str]) -> Any:
    node: Any = tree
    for k in path:
        if not isinstance(node, Mapping) or k not in node:
            return None
        node = node[k]
    return np.asarray(node)


def _require(tree: Mapping[str, Any], path: list[str]) -> np.ndarray:
    """_get that raises a named KeyError for a required leaf (a missing/
    renamed BN or fc leaf must fail here, not later inside torch.save)."""
    leaf = _get(tree, path)
    if leaf is None:
        raise KeyError(f'required leaf missing from variables: '
                       f'{"/".join(path)}')
    return leaf


def _conv_w(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 2, 0, 1))  # HWIO -> OIHW


def _export_bn(variables: dict, src: list[str], out: dict, prefix: str,
               affine: bool = True) -> None:
    if affine:
        out[f'{prefix}.weight'] = _require(variables, ['params'] + src
                                           + ['bn', 'scale'])
        out[f'{prefix}.bias'] = _require(variables, ['params'] + src
                                         + ['bn', 'bias'])
    out[f'{prefix}.running_mean'] = _require(
        variables, ['batch_stats'] + src + ['bn', 'mean'])
    out[f'{prefix}.running_var'] = _require(
        variables, ['batch_stats'] + src + ['bn', 'var'])
    out[f'{prefix}.num_batches_tracked'] = np.asarray(0, np.int64)


def _export_quant_conv(variables: dict, src: list[str], out: dict,
                       prefix: str, momentum: float,
                       x_quant: str = 'fp') -> None:
    kernel = _get(variables, ['params'] + src + ['kernel'])
    if kernel is None:
        raise KeyError(f'no conv kernel at {"/".join(src)} (stripped '
                       'deployment checkpoints cannot be exported: the '
                       'reference needs the fp master weights)')
    out[f'{prefix}.weight'] = _conv_w(kernel)
    bias = _get(variables, ['params'] + src + ['bias'])
    if bias is not None:
        out[f'{prefix}.bias'] = bias
    vs = _get(variables, ['quant_state'] + src + ['w_quantizer', 'vs'])
    if vs is not None:
        for j in range(vs.shape[0]):
            out[f'{prefix}.w_approximate.v{j + 1}'] = vs[j]
    # The reference ActivationQuantizer registers moving_avg_module
    # buffers UNCONDITIONALLY for every non-fp x_quant (its constructor,
    # activation_quantization.py:65), even with moving_average_mode
    # 'off'. The tree only tracks EMA state when the mode is on, so a
    # mode='off' model must still synthesize the buffers or the
    # reference's strict load_state_dict fails with missing keys.
    ema = _get(variables, ['quant_state'] + src + ['x_quantizer', 'ema'])
    if x_quant != 'fp' or ema is not None:
        if x_quant != 'fp':
            k = scheme_num_scales(x_quant)
        else:  # scheme unknown to the caller; ema shape carries k
            k = ema.shape[0]
        count = _get(variables,
                     ['quant_state'] + src + ['x_quantizer', 'ema_count'])
        mam = f'{prefix}.x_approximate.moving_avg_module'
        out[f'{mam}.moving_average'] = (
            ema if ema is not None else np.zeros((k,), np.float32))
        out[f'{mam}.momentum'] = np.full((k,), momentum, np.float32)
        out[f'{mam}.num_batches_tracked'] = np.asarray(
            0 if count is None else int(count), np.int64)


def export_resnet_state_dict(variables: dict, num_blocks: list[int],
                             momentum: float = 0.99,
                             stage_x_quants: Optional[list[str]] = None,
                             ) -> dict:
    """QResNet (basic-block) variable tree -> reference state dict.

    num_blocks: per-stage block counts, to reconstruct the reference's
    flat ``blocks.{i}`` ModuleList indexing (resnet.py:306-330).
    momentum: arch_config.moving_average_momentum (fills the reference's
    MovingAverage momentum buffer).
    stage_x_quants: per-stage activation schemes (layer1..layerN
    x_quant); non-fp stages always get moving_avg_module buffers, as the
    reference registers them unconditionally.
    """
    out: dict = {}
    stage_x_quants = stage_x_quants or ['fp'] * len(num_blocks)

    # Stem — emitted under both reference name sets (attribute + Seq).
    stem_w = _require(variables, ['params', 'conv1', 'kernel'])
    out['conv1.weight'] = out['blocks.0.0.weight'] = _conv_w(stem_w)
    stem_b = _get(variables, ['params', 'conv1', 'bias'])
    if stem_b is not None:
        out['conv1.bias'] = out['blocks.0.0.bias'] = stem_b
    _export_bn(variables, ['bn1'], out, 'bn1')
    for k in ('weight', 'bias', 'running_mean', 'running_var',
              'num_batches_tracked'):
        out[f'blocks.0.1.{k}'] = out[f'bn1.{k}']

    flat = 1
    for s, n in enumerate(num_blocks):
        for b in range(n):
            name = f'layer{s + 1}_block{b}'
            pref = f'blocks.{flat}'
            flat += 1
            for bn in ('bn1', 'bn2'):
                _export_bn(variables, [name, bn], out, f'{pref}.{bn}')
            for conv in ('conv1', 'conv2'):
                _export_quant_conv(variables, [name, conv], out,
                                   f'{pref}.{conv}', momentum,
                                   x_quant=stage_x_quants[s])
            for nl in ('nonlin1', 'nonlin2'):
                slope = _get(variables,
                             ['params', name, nl, 'negative_slope'])
                if slope is not None:
                    out[f'{pref}.{nl}.weight'] = slope.reshape((1,))
            sc_w = _get(variables,
                        ['params', name, 'shortcut', 'conv', 'kernel'])
            if sc_w is not None:
                out[f'{pref}.shortcut.0.weight'] = _conv_w(sc_w)
                sc_b = _get(variables,
                            ['params', name, 'shortcut', 'conv', 'bias'])
                if sc_b is not None:
                    out[f'{pref}.shortcut.0.bias'] = sc_b
                _export_bn(variables, [name, 'shortcut', 'norm'], out,
                           f'{pref}.shortcut.1')

    fc_k = _require(variables, ['params', 'fc', 'kernel'])
    out['linear_classifier.2.weight'] = fc_k.T
    out['linear_classifier.2.bias'] = _require(variables,
                                               ['params', 'fc', 'bias'])
    return out


def export_lenet_state_dict(variables: dict, conv2_filters: int,
                            momentum: float = 0.99,
                            x_quant: str = 'fp') -> dict:
    """QLeNet5 variable tree -> reference state dict.

    fc1's input columns are permuted NHWC-flat -> NCHW-flat (the inverse
    of the import's reorder), so the exported model is numerically
    identical under torch's C-major flatten.
    """
    out: dict = {}
    out['conv1.weight'] = _conv_w(_get(variables,
                                       ['params', 'conv1', 'kernel']))
    b1 = _get(variables, ['params', 'conv1', 'bias'])
    if b1 is not None:
        out['conv1.bias'] = b1
    # Reference LeNet BNs are affine=False (lenet.py:68,74): stats only.
    for bn in ('bn_conv1', 'bn_conv2'):
        mean = _get(variables, ['batch_stats', bn, 'bn', 'mean'])
        if mean is not None:
            out[f'{bn}.running_mean'] = mean
            out[f'{bn}.running_var'] = _get(
                variables, ['batch_stats', bn, 'bn', 'var'])
            out[f'{bn}.num_batches_tracked'] = np.asarray(0, np.int64)
    _export_quant_conv(variables, ['conv2'], out, 'conv2', momentum,
                       x_quant=x_quant)

    # fc1: (in, out) kernel, rows in NHWC-flat (4,4,C) order -> torch
    # (out, in) with columns in NCHW-flat (C,4,4) order.
    w1 = _require(variables, ['params', 'fc1', 'kernel']).T  # (out, in)
    out_f = w1.shape[0]
    w1 = w1.reshape(out_f, 4, 4, conv2_filters)
    out['fc1.weight'] = np.transpose(w1, (0, 3, 1, 2)).reshape(out_f, -1)
    out['fc1.bias'] = _require(variables, ['params', 'fc1', 'bias'])
    out['fc2.weight'] = _require(variables, ['params', 'fc2', 'kernel']).T
    out['fc2.bias'] = _require(variables, ['params', 'fc2', 'bias'])
    return out


def export_state_dict(architecture: str, variables: dict,
                      arch_config: Optional[dict] = None) -> dict:
    """Dispatch on the registry architecture name ('lenet5'/'resnet')."""
    cfg = dict(arch_config or {})
    momentum = float(cfg.get('moving_average_momentum', 0.99))
    if architecture == 'lenet5':
        return export_lenet_state_dict(
            variables, conv2_filters=int(cfg.get('conv2_filters', 50)),
            momentum=momentum, x_quant=str(cfg.get('x_quant', 'fp')))
    if architecture == 'resnet':
        if 'bottleneck' in str(cfg.get('block', '')):
            raise ValueError('bottleneck blocks have no reference '
                             'counterpart to export to')
        num_blocks = list(cfg['num_blocks'])
        stage_x_quants = [
            str(cfg.get(f'layer{s + 1}', {}).get('x_quant', 'fp'))
            for s in range(len(num_blocks))]
        return export_resnet_state_dict(
            variables, num_blocks=num_blocks, momentum=momentum,
            stage_x_quants=stage_x_quants)
    raise ValueError(f'architecture {architecture} is not exportable')
