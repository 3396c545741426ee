"""Import reference (apple/ml-quant, PyTorch) checkpoints into the JAX
variable tree (port of quant_tpu/utils/torch_import.py; numpy only, the
port's own copy of the maps).

The reference trains with torch and checkpoints `model.state_dict()`
(reference quant/utils/checkpoints.py:17-51). This module converts such
a state dict, given as {name: numpy array}, into the JAX package's
variable collections, which the port's models load through
`utils.jax_import`:

    model = QResNet(...)          # the reference model's configuration
    tree = merge_imported(to_jax_variables(model),
                          import_resnet_state_dict(sd, num_blocks))
    from_jax_variables(model, tree)

Layout conversions:
  * conv weight  (O, I, kh, kw) -> HWIO (kh, kw, I, O)
  * linear weight (out, in)     -> (in, out)
  * BatchNorm weight/bias/running_mean/running_var
        -> params .scale/.bias + batch_stats .mean/.var
  * PReLU weight (1,)           -> negative_slope ()
  * WeightQuantizer buffers v1[, v2 | v1..vk]
        -> quant_state ... w_quantizer.vs (k, O) stack
  * ActivationQuantizer moving_avg_module.{moving_average,
        num_batches_tracked} -> x_quantizer.{ema, ema_count}

Name maps follow the reference module trees (quant/models/resnet.py:283-340,
quant/models/lenet.py:38-64). `state_dict_to_numpy` converts a torch
checkpoint payload (tensors expose .numpy()).
"""

from typing import Any, Mapping

import numpy as np

__all__ = ['import_resnet_state_dict', 'import_lenet_state_dict',
           'state_dict_to_numpy']


def state_dict_to_numpy(state_dict: Mapping[str, Any]) -> dict:
    """Convert {name: torch.Tensor|ndarray} to {name: ndarray}."""
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, 'detach'):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _set(tree: dict, path: list[str], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _conv_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _gather_quantizer_vs(sd: dict, prefix: str) -> np.ndarray:
    """Stack w_approximate.v1[,v2,...] buffers into a (k, O) array."""
    vs = []
    for j in range(1, 9):
        key = f'{prefix}.w_approximate.v{j}'
        if key not in sd:
            break
        vs.append(sd[key])
    if not vs:
        raise KeyError(f'no weight-quantizer buffers under {prefix}')
    return np.stack(vs)


def _import_quant_conv(sd: dict, prefix: str, dest: list[str],
                       params: dict, quant_state: dict) -> None:
    """One reference QuantConv2d -> params + quant_state entries."""
    _set(params, dest + ['kernel'], _conv_w(sd[f'{prefix}.weight']))
    if f'{prefix}.bias' in sd:
        _set(params, dest + ['bias'], sd[f'{prefix}.bias'])
    if f'{prefix}.w_approximate.v1' in sd:
        _set(quant_state, dest + ['w_quantizer', 'vs'],
             _gather_quantizer_vs(sd, prefix))
    ma = f'{prefix}.x_approximate.moving_avg_module.moving_average'
    if ma in sd:
        _set(quant_state, dest + ['x_quantizer', 'ema'], sd[ma])
        _set(quant_state, dest + ['x_quantizer', 'ema_count'],
             sd[f'{prefix}.x_approximate.moving_avg_module.'
                f'num_batches_tracked'].astype(np.int32))


def _import_bn(sd: dict, prefix: str, dest: list[str],
               params: dict, batch_stats: dict) -> None:
    _set(params, dest + ['bn', 'scale'], sd[f'{prefix}.weight'])
    _set(params, dest + ['bn', 'bias'], sd[f'{prefix}.bias'])
    _set(batch_stats, dest + ['bn', 'mean'], sd[f'{prefix}.running_mean'])
    _set(batch_stats, dest + ['bn', 'var'], sd[f'{prefix}.running_var'])


def import_resnet_state_dict(sd: Mapping[str, np.ndarray],
                             num_blocks: list[int]) -> dict:
    """Reference QResNet state_dict -> the JAX QResNet variable tree.

    num_blocks: per-stage block counts (e.g. [2, 2, 2, 2] for ResNet-18),
    needed to translate the reference's flat `blocks.{i}` ModuleList
    indices (resnet.py:306-330) into `layer{s}_block{b}` names.
    """
    sd = dict(sd)
    params: dict = {}
    batch_stats: dict = {}
    quant_state: dict = {}

    # Stem: blocks.0 = Sequential(conv1, bn1, relu, maxpool).
    _set(params, ['conv1', 'kernel'], _conv_w(sd['blocks.0.0.weight']))
    if 'blocks.0.0.bias' in sd:
        _set(params, ['conv1', 'bias'], sd['blocks.0.0.bias'])
    _import_bn(sd, 'blocks.0.1', ['bn1'], params, batch_stats)

    # Residual blocks: flat index -> (stage, block-in-stage).
    flat = 1
    for s, n in enumerate(num_blocks):
        for b in range(n):
            name = f'layer{s + 1}_block{b}'
            pref = f'blocks.{flat}'
            flat += 1
            for bn in ('bn1', 'bn2'):
                _import_bn(sd, f'{pref}.{bn}', [name, bn],
                           params, batch_stats)
            for conv in ('conv1', 'conv2'):
                _import_quant_conv(sd, f'{pref}.{conv}', [name, conv],
                                   params, quant_state)
            for nl in ('nonlin1', 'nonlin2'):
                w = sd.get(f'{pref}.{nl}.weight')
                if w is not None:
                    _set(params, [name, nl, 'negative_slope'],
                         np.asarray(w).reshape(()))
            if f'{pref}.shortcut.0.weight' in sd:
                _set(params, [name, 'shortcut', 'conv', 'kernel'],
                     _conv_w(sd[f'{pref}.shortcut.0.weight']))
                if f'{pref}.shortcut.0.bias' in sd:
                    _set(params, [name, 'shortcut', 'conv', 'bias'],
                         sd[f'{pref}.shortcut.0.bias'])
                _import_bn(sd, f'{pref}.shortcut.1',
                           [name, 'shortcut', 'norm'],
                           params, batch_stats)

    # Head: linear_classifier = Sequential(avgpool, flatten, linear).
    _set(params, ['fc', 'kernel'], sd['linear_classifier.2.weight'].T)
    _set(params, ['fc', 'bias'], sd['linear_classifier.2.bias'])

    return {'params': params, 'batch_stats': batch_stats,
            'quant_state': quant_state}


def import_lenet_state_dict(sd: Mapping[str, np.ndarray],
                            conv2_filters: int) -> dict:
    """Reference QLeNet5 state_dict -> the JAX QLeNet5 variable tree.

    NOTE on fc1: torch flattens NCHW (C-major), the tree's models NHWC.
    The fc1 weight columns are permuted to match the NHWC flatten, so
    the imported model is numerically identical.
    """
    sd = dict(sd)
    params: dict = {}
    batch_stats: dict = {}
    quant_state: dict = {}

    _set(params, ['conv1', 'kernel'], _conv_w(sd['conv1.weight']))
    if 'conv1.bias' in sd:
        _set(params, ['conv1', 'bias'], sd['conv1.bias'])
    # Reference BNs are affine=False (lenet.py:68,74): stats only.
    for bn in ('bn_conv1', 'bn_conv2'):
        if f'{bn}.running_mean' in sd:
            _set(batch_stats, [bn, 'bn', 'mean'],
                 sd[f'{bn}.running_mean'])
            _set(batch_stats, [bn, 'bn', 'var'],
                 sd[f'{bn}.running_var'])
    _import_quant_conv(sd, 'conv2', ['conv2'], params, quant_state)

    # fc1: reorder input columns NCHW-flat -> NHWC-flat (C,4,4 -> 4,4,C).
    w1 = sd['fc1.weight']          # (out, C*4*4) in torch C-major order
    out_f = w1.shape[0]
    w1 = w1.reshape(out_f, conv2_filters, 4, 4)
    w1 = np.transpose(w1, (0, 2, 3, 1)).reshape(out_f, -1)
    _set(params, ['fc1', 'kernel'], w1.T)
    _set(params, ['fc1', 'bias'], sd['fc1.bias'])
    _set(params, ['fc2', 'kernel'], sd['fc2.weight'].T)
    _set(params, ['fc2', 'bias'], sd['fc2.bias'])

    return {'params': params, 'batch_stats': batch_stats,
            'quant_state': quant_state}


def merge_imported(variables: dict, imported: dict) -> dict:
    """Overlay imported leaves onto a model's variables (e.g.
    `to_jax_variables(model)`), shape-checked and cast to the model's
    dtypes, keeping the model's values where the import has none."""
    out = {}
    for col, fresh in variables.items():
        imp = imported.get(col, {})

        def overlay(f, i):
            if not isinstance(f, dict):
                if i is None:
                    return f
                i = np.asarray(i)
                if tuple(i.shape) != tuple(f.shape):
                    raise ValueError(
                        f'shape mismatch: import {i.shape} vs {f.shape}')
                return i.astype(np.asarray(f).dtype)
            return {k: overlay(v, (i or {}).get(k) if isinstance(i, dict)
                               else None) for k, v in f.items()}

        out[col] = overlay(fresh, imp)
    return out
