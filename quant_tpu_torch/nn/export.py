"""Serving preparation: pack, fold, strip (port of quant_tpu/nn/export.py:
24-41, 145-345).

The JAX functions map variable trees to variable trees; here the state
lives in the modules, so each function updates a QResNet in place and
returns it. `packed_params_tree` reads the result back in the JAX
tree's shape.
"""

import logging

import torch

from quant_tpu_torch.nn.layers import QuantConv2d
from quant_tpu_torch.nn.resnet import QResNet

logger = logging.getLogger(__name__)

PACKED_LEAVES = ('w_packed', 'w_scales', 'x_thresh', 'x_flip', 'x_va')


def _quant_convs(model: torch.nn.Module) -> list[tuple[str, QuantConv2d]]:
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, QuantConv2d)]


def export_packed_variables(model: QResNet) -> QResNet:
    """Pack every quantized conv's sign words once; `w_scales` are the
    cached weight scales (quant_state w_quantizer/vs)."""
    for _, conv in _quant_convs(model):
        conv.export_packed()
    return model


def fold_xnor_thresholds(model: QResNet, eps: float = 1e-5) -> QResNet:
    """Fold each pre-conv BN + clamp + sign extraction into per-channel
    thresholds: x_thresh = -b/a, x_flip = sign(a), x_va = ema / |a|, for
    the eval affine BN(x) = a*x + b.

    Validity checks (as the JAX fold): an EMA moving-average mode that
    has tracked batches, and |a| > 0 per channel. The clamp-box check on
    residual planes is vacuous for ls-1, the only ported scheme. Serve
    the result with model.bn_fold = True (fold_for_serving does both).
    """
    if all(conv.w_packed is None for _, conv in _quant_convs(model)):
        raise ValueError('fold_xnor_thresholds needs packed_params — '
                         'run export_packed_variables first.')
    if getattr(model, 'block', None) != 'xnor':
        raise ValueError(
            f'threshold folding is defined for the BN->conv (xnor) '
            f"families, not {getattr(model, 'block', None)!r}.")
    if model.moving_average_mode == 'off':
        raise ValueError(
            "threshold folding requires an EMA moving_average_mode "
            "('eval_only'/'train_and_eval'): with mode 'off' the eval "
            'scales are solved from the actual clamp(BN(x)) values, '
            'which the folded path never computes.')
    for name, blk in model.blocks():
        for conv_name, bn in (('conv1', blk.bn1), ('conv2', blk.bn2)):
            conv = getattr(blk, conv_name)
            if conv.w_packed is None:
                continue
            label = f'{name}/{conv_name}'
            a = bn.weight / torch.sqrt(bn.running_var + eps)
            if not bool((a.abs() > 0).all()):
                raise ValueError(
                    f'{label}: BN scale gamma has a zero channel — no '
                    'threshold form exists; serve unfolded.')
            quant = conv.x_quantizer
            if not int(quant.ema_count) > 0:
                raise ValueError(
                    f'{label}: activation EMA has tracked no batches — '
                    'train (or run a calibration pass) first.')
            b = bn.bias - bn.running_mean * a
            conv.x_thresh = (-b / a).to(torch.float32)
            conv.x_flip = torch.where(a >= 0, 1.0, -1.0).to(torch.float32)
            conv.x_va = (quant.ema[:, None] / a.abs()[None, :]).to(
                torch.float32)
    return model


def fold_for_serving(model: QResNet) -> tuple[QResNet, bool]:
    """Apply the threshold fold and set bn_fold; when the fold's
    preconditions are unmet, log why and return the model unfolded.
    Returns (model, folded)."""
    try:
        fold_xnor_thresholds(model)
    except (ValueError, KeyError) as e:
        logger.info('BN folding not applicable (%s); serving the '
                    'unfolded packed form', e)
        return model, False
    model.bn_fold = True
    return model, True


def strip_for_deployment(model: QResNet) -> QResNet:
    """Drop what serving never reads: the fp kernels and cached weight
    scales of every packed conv. The model then serves from the packed
    buffers only."""
    convs = [conv for _, conv in _quant_convs(model)
             if conv.w_packed is not None]
    if not convs:
        raise ValueError('strip_for_deployment needs packed_params — '
                         'run export_packed_variables first.')
    for conv in convs:
        conv.kernel = None
        conv.w_vs = None
    return model


def packed_params_tree(model: torch.nn.Module) -> dict:
    """The model's packed buffers as the JAX 'packed_params' tree:
    {block: {conv: {leaf: tensor}}}."""
    tree: dict = {}
    for name, conv in _quant_convs(model):
        leaves = {k: getattr(conv, k) for k in PACKED_LEAVES
                  if getattr(conv, k) is not None}
        if not leaves:
            continue
        node = tree
        for part in name.split('.'):
            node = node.setdefault(part, {})
        node.update(leaves)
    return tree
