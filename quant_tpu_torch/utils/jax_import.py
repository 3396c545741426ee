"""Fill the port's modules from a quant_tpu (JAX) variable tree, and
read them back as one.

The tree is nested dicts of numpy arrays with the JAX collections
`params`, `batch_stats`, `quant_state` and `packed_params`, exactly as
`jax.device_get(variables)` gives them; nothing of JAX is imported.
`params` leaves become trainable parameters and the other collections
buffers, so the params, batch_stats and quant_state of a JAX TrainState
load into a port model that trains on from there, and
`to_jax_variables` hands the trained state back (optimizer state is
not carried).
"""

from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn

# One row per leaf: port module class -> [(attribute, collection, path
# below the module's own node, optional)]. An optional leaf that is
# absent sets the attribute to None; a required one raises KeyError.
_LEAVES: dict[str, list[tuple[str, str, tuple[str, ...], bool]]] = {
    'Conv': [('kernel', 'params', ('kernel',), False),
             ('bias', 'params', ('bias',), False)],
    'Dense': [('kernel', 'params', ('kernel',), False),
              ('bias', 'params', ('bias',), False)],
    'BatchNorm': [('weight', 'params', ('bn', 'scale'), False),
                  ('bias', 'params', ('bn', 'bias'), False),
                  ('running_mean', 'batch_stats', ('bn', 'mean'), False),
                  ('running_var', 'batch_stats', ('bn', 'var'), False)],
    'PReLU': [('negative_slope', 'params', ('negative_slope',), False)],
    'ActivationQuantizer': [
        ('ema', 'quant_state', ('ema',), False),
        ('ema_count', 'quant_state', ('ema_count',), False)],
    'QuantConv2d': [
        ('kernel', 'params', ('kernel',), True),
        ('bias', 'params', ('bias',), False),
        ('w_vs', 'quant_state', ('w_quantizer', 'vs'), True),
        ('w_packed', 'packed_params', ('w_packed',), True),
        ('w_scales', 'packed_params', ('w_scales',), True),
        ('x_thresh', 'packed_params', ('x_thresh',), True),
        ('x_flip', 'packed_params', ('x_flip',), True),
        ('x_va', 'packed_params', ('x_va',), True),
        ('b_fold', 'packed_params', ('b_fold',), True)],
}


def leaf_slots(model: nn.Module
               ) -> Iterator[tuple[nn.Module, str, str, tuple[str, ...],
                                   bool]]:
    """(module, attribute, collection, the leaf's path in that
    collection, optional) for every leaf slot of the model, by the leaf
    map below; a module at dotted path `a.b` holds the leaves under
    `a/b`."""
    for name, module in model.named_modules():
        prefix = tuple(name.split('.')) if name else ()
        for attr, coll, path, optional in _LEAVES.get(
                type(module).__name__, ()):
            yield module, attr, coll, prefix + path, optional


def _lookup(tree: Mapping[str, Any], path: list[str]) -> Optional[Any]:
    node: Any = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            return None
        node = node[key]
    return node


def from_jax_variables(model: nn.Module,
                       variables: Mapping[str, Any]) -> nn.Module:
    """Load a JAX variable tree into `model` in place and return it.

    A port module at dotted path `a.b` reads the JAX node at `a/b` of
    each collection. The leaf map (JAX key below that node -> port
    attribute):

    ===================  =================================  ==============
    port module          JAX leaf                           attribute
    ===================  =================================  ==============
    Conv (stem conv1,    params/kernel (kh,kw,I,O)          kernel (HWIO)
    shortcut.conv)       params/bias                        bias
    Dense (fc, fc1, fc2) params/kernel (in,out)             kernel
                         params/bias                        bias
    BatchNorm (bn1..3,   params/bn/scale (absent when       weight
    shortcut.norm,       affine-free: LeNet's bn_conv1/2)
    bn_conv1, bn_conv2)  params/bn/bias (same)              bias
                         batch_stats/bn/mean                running_mean
                         batch_stats/bn/var                 running_var
    PReLU (nonlin1..3)   params/negative_slope ()           negative_slope
    QuantConv2d          params/kernel (absent if stripped) kernel or None
    (blockN.conv1..3,    params/bias                        bias
    LeNet's conv2)       quant_state/w_quantizer/vs (k,O)   w_vs or None
                         (absent if stripped, or fp)
                         packed_params/w_packed             w_packed or
                         (k,kh,kw,Wd,O) int32, k planes     None
                         packed_params/w_scales (k,O)       w_scales
                         packed_params/x_thresh (C,)        x_thresh
                         packed_params/x_flip (C,)          x_flip
                         packed_params/x_va (k,C)           x_va
                         (the three after fold_xnor_
                         thresholds)
                         packed_params/b_fold (O,) (after   b_fold
                         fold_bn_into_packed)
    ActivationQuantizer  quant_state/ema (k,)               ema
    (convN.x_quantizer)  quant_state/ema_count () int32     ema_count
    ===================  =================================  ==============

    Here k is the scheme's scale count (ls-1 and ls-T 1, ls-2 2, gf-k k)
    and, for w_packed, its sign planes (ls-T 2). Stripped trees
    (strip_for_deployment) lack the QuantConv2d kernel and w_vs, which
    are then set to None; unexported trees lack every packed_params
    leaf. A required leaf that is missing raises KeyError;
    a leaf whose shape differs from the module's, or that the module's
    configuration has no place for (a bias of a bias-free conv, EMA
    state of a moving_average_mode 'off' model), raises ValueError.
    Serve a folded tree with model.bn_fold = True.
    """
    device = next(model.parameters()).device
    for module, attr, coll, path, optional in leaf_slots(model):
        where = f"{coll}/{'/'.join(path)}"
        current = getattr(module, attr)
        value = _lookup(variables.get(coll, {}), list(path))
        if value is None:
            if optional:
                setattr(module, attr, None)
            elif current is not None:
                raise KeyError(f'required leaf missing: {where}')
            continue
        t = torch.from_numpy(np.array(value)).to(device)
        if current is None and not optional:
            raise ValueError(
                f'{where}: the tree has it, the module has no such state '
                '(config mismatch)')
        if current is not None and current.shape != t.shape:
            raise ValueError(
                f'{where}: shape {tuple(t.shape)} != {tuple(current.shape)}')
        if attr in module._parameters:
            setattr(module, attr, nn.Parameter(t))
        else:
            setattr(module, attr, t)
    return model


def to_jax_variables(model: nn.Module) -> dict[str, Any]:
    """The model's state as a JAX variable tree of numpy arrays, the
    inverse of from_jax_variables (by the same leaf map): an attribute
    that is None is left out of the tree. The arrays are copies, so the
    tree stays as it was while the model trains on."""
    tree: dict[str, Any] = {}
    for module, attr, coll, path, _ in leaf_slots(model):
        value = getattr(module, attr)
        if value is None:
            continue
        node = tree.setdefault(coll, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value.detach().cpu().numpy().copy()
    return tree
