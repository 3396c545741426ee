"""Serving preparation: pack, calibrate, fold, strip (port of
quant_tpu/nn/export.py).

The JAX functions map variable trees to variable trees; here the state
lives in the modules, so each function updates a QResNet or QLeNet5 in
place and returns it. `packed_params_tree` reads the result back in the
JAX tree's shape. Each function puts the model in eval mode (a model in
train mode would solve, track and normalize on the batch) and records
no gradient.
"""

import copy
import functools
import logging
from typing import Callable, Iterable

import numpy as np
import torch

from quant_tpu_torch.nn.layers import ActivationQuantizer, QuantConv2d
from quant_tpu_torch.nn.lenet import QLeNet5
from quant_tpu_torch.ops.quantize import scheme_num_scales

logger = logging.getLogger(__name__)

PACKED_LEAVES = ('w_packed', 'w_scales', 'x_thresh', 'x_flip', 'x_va',
                 'b_fold')


def _in_eval(fn: Callable) -> Callable:
    """Run fn(model, ...) with the model in eval mode, under no_grad."""
    @functools.wraps(fn)
    def run(model: torch.nn.Module, *args, **kwargs):
        model.eval()
        with torch.no_grad():
            return fn(model, *args, **kwargs)
    return run


def _quant_convs(model: torch.nn.Module) -> list[tuple[str, QuantConv2d]]:
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, QuantConv2d)]


def _require_packed(model: torch.nn.Module, what: str) -> None:
    if all(conv.w_packed is None for _, conv in _quant_convs(model)):
        raise ValueError(f'{what} needs packed_params — run '
                         'export_packed_variables first.')


@_in_eval
def export_packed_variables(model: torch.nn.Module) -> torch.nn.Module:
    """Pack the sign words of every conv that can serve packed (binary
    weights, one group) once; `w_scales` are the cached weight scales
    (quant_state w_quantizer/vs), ls-T's repeated for its two planes."""
    for _, conv in _quant_convs(model):
        if conv.packable:
            conv.export_packed()
    return model


@_in_eval
def fold_bn_into_packed(model: torch.nn.Module,
                        eps: float = 1e-5) -> torch.nn.Module:
    """Fold each eval BN that follows a packed conv into the conv's
    epilogue (regular / regular_bottleneck families): for the affine
    a*y + b with a = gamma/sqrt(var+eps), w_scales *= a and b_fold =
    b + a*bias. Serve with model.bn_fold = True."""
    _require_packed(model, 'fold_bn_into_packed')
    block = getattr(model, 'block', None)
    if block not in ('regular', 'regular_bottleneck'):
        raise ValueError(
            f'BN folding is defined for conv->BN block families '
            f'(regular/regular_bottleneck), not {block!r}.')
    for _, blk in model.blocks():
        for _, conv, bn in blk.fold_pairs():
            if conv.w_packed is None:
                continue
            a = bn.scale(eps)
            b = bn.bias - bn.running_mean * a
            conv.w_scales = conv.w_scales * a[None, :]
            if conv.bias is not None:
                b = b + a * conv.bias
            conv.b_fold = b
    return model


def _eval_only_twin(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of the model with moving_average_mode 'eval_only' (JAX's
    model.clone(moving_average_mode='eval_only')): every state carried
    over, EMA state created (zero, untracked) where the model had none."""
    twin = copy.deepcopy(model).eval()
    dev = next(twin.parameters()).device
    for m in twin.modules():
        if hasattr(m, 'moving_average_mode'):
            m.moving_average_mode = 'eval_only'
        if isinstance(m, ActivationQuantizer) and m.scheme != 'fp' \
                and m.ema is None:
            k = scheme_num_scales(m.scheme)
            m.ema = torch.zeros(k, dtype=torch.float32, device=dev)
            m.ema_count = torch.zeros((), dtype=torch.int32, device=dev)
    return twin


def calibrate_ema_scales(model: torch.nn.Module,
                         batches: Iterable) -> torch.nn.Module:
    """Post-training EMA calibration (the observer pass of
    quant_tpu/nn/export.py:106-142).

    A model trained with moving_average_mode 'off' solves its activation
    scales per batch, so it cannot serve threshold-folded. This runs eval
    forwards (BN on running statistics, as EMA serving sees them) of the
    model's 'eval_only' twin with every activation quantizer in observer
    mode, blending each batch's solved scales into the EMA.

    Args:
        model: a QResNet or QLeNet5 (any moving_average_mode, either
            mode); unchanged.
        batches: iterable of NHWC input batches (tensors or arrays).

    Returns:
        the 'eval_only' twin in eval mode carrying the calibrated EMA
        scales, its quantizers out of observer mode; fold_for_serving
        folds it as any EMA model.
    """
    twin = _eval_only_twin(model)
    dev = next(twin.parameters()).device
    quants = [m for m in twin.modules() if isinstance(m, ActivationQuantizer)]
    n = 0
    try:
        for q in quants:
            q.calibrate = True
        with torch.inference_mode():
            for batch in batches:
                twin(torch.as_tensor(batch, device=dev))
                n += 1
    finally:
        for q in quants:
            q.calibrate = False
    if n == 0:
        raise ValueError('calibrate_ema_scales got an empty batch '
                         'iterable — EMA state would stay untracked.')
    return twin


def _clamp_box_check(label: str, scheme: str, clamp: dict,
                     ema: torch.Tensor) -> None:
    """Under a symmetric clamp every residual plane must stay inside the
    box: the EMA scale prefix sums through plane k-1 must be <= alpha."""
    if clamp.get('kind') != 'symmetric':
        return
    ema_np = ema.cpu().numpy()
    if scheme in ('ls-2', 'ls-T'):
        prefix = ema_np[:1]  # the residual before plane 2 is v1 * b1
    elif scheme.startswith('gf-'):
        prefix = np.cumsum(ema_np)[:-1]
    else:  # ls-1: one plane, no residual to bound
        prefix = np.zeros(0)
    alpha = float(clamp.get('alpha', 1.0))
    if prefix.size and not (prefix <= alpha).all():
        raise ValueError(
            f'{label}: EMA scale prefix sums {prefix.tolist()} exceed '
            f'clamp alpha {alpha} — residual planes would leave the '
            'clamp box; serve unfolded.')


@_in_eval
def fold_xnor_thresholds(model: torch.nn.Module,
                         eps: float = 1e-5) -> torch.nn.Module:
    """Fold each pre-conv BN + clamp + sign extraction into per-channel
    thresholds: x_thresh = -b/a, x_flip = sign(a), x_va = ema / |a|
    (k, C), for the eval affine BN(x) = a*x + b.

    Families: QResNet with 'xnor' / 'xnor_bottleneck' blocks (every
    in-block BN; fp-activation convs are skipped) and QLeNet5 (its
    affine-free bn_conv2, eps 1e-4). Validity checks, as the JAX fold:
    an EMA moving-average mode that has tracked batches, |a| > 0 per
    channel, and the clamp box (_clamp_box_check). Serve with
    model.bn_fold = True (fold_for_serving does both).
    """
    _require_packed(model, 'fold_xnor_thresholds')
    is_lenet = isinstance(model, QLeNet5)
    block = getattr(model, 'block', None)
    if block not in ('xnor', 'xnor_bottleneck') and not is_lenet:
        raise ValueError(
            f'threshold folding is defined for the BN->conv (xnor) '
            f'families and QLeNet5, not {block!r}.')
    if model.moving_average_mode == 'off':
        raise ValueError(
            "threshold folding requires an EMA moving_average_mode "
            "('eval_only'/'train_and_eval'): with mode 'off' the eval "
            'scales are solved from the actual clamp(BN(x)) values, '
            'which the folded path never computes.')
    if is_lenet:
        if model.x_quant == 'fp':
            raise ValueError('threshold folding is undefined for fp '
                             'activations (they consume BN values).')
        # bn_conv2 is affine-free at eps 1e-4 (lenet.py:60-67).
        pairs = [('conv2/bn_conv2', conv, bn, 1e-4)
                 for _, conv, bn in model.fold_pairs()]
    else:
        pairs = [(f'{name}/{conv_name}', conv, bn, eps)
                 for name, blk in model.blocks()
                 for conv_name, conv, bn in blk.fold_pairs()]
    folds = []  # every conv is checked before any is written
    for label, conv, bn, bn_eps in pairs:
        if conv.x_quant == 'fp' or conv.w_packed is None:
            continue
        a = bn.scale(bn_eps)
        if not bool((a.abs() > 0).all()):
            raise ValueError(
                f'{label}: BN scale gamma has a zero channel — no '
                'threshold form exists; serve unfolded.')
        quant = conv.x_quantizer
        if not int(quant.ema_count) > 0:
            raise ValueError(
                f'{label}: activation EMA has tracked no batches — '
                'train (or run a calibration pass) first.')
        _clamp_box_check(label, conv.x_quant, conv.clamp, quant.ema)
        beta = (bn.bias if bn.bias is not None
                else torch.zeros_like(bn.running_mean))
        b = beta - bn.running_mean * a
        folds.append((conv, (-b / a).to(torch.float32),
                      torch.where(a >= 0, 1.0, -1.0).to(torch.float32),
                      (quant.ema[:, None] / a.abs()[None, :]).to(
                          torch.float32)))
    for conv, thresh, flip, va in folds:
        conv.x_thresh, conv.x_flip, conv.x_va = thresh, flip, va
    return model


def fold_for_serving(model: torch.nn.Module
                     ) -> tuple[torch.nn.Module, bool]:
    """The family's export-time BN elimination, as JAX dispatches it:
    the epilogue fold (fold_bn_into_packed) first, then the threshold
    fold; set bn_fold where one applied. When neither is defined or its
    preconditions are unmet, log why and return the model unfolded.
    Returns (model, folded)."""
    try:
        try:
            fold_bn_into_packed(model)
        except (ValueError, KeyError):
            fold_xnor_thresholds(model)
    except (ValueError, KeyError) as e:
        logger.info('BN folding not applicable (%s); serving the '
                    'unfolded packed form', e)
        return model, False
    model.bn_fold = True
    return model, True


@_in_eval
def strip_for_deployment(model: torch.nn.Module) -> torch.nn.Module:
    """Drop what serving never reads: the fp kernels and cached weight
    scales of every packed conv. The model then serves from the packed
    buffers only."""
    _require_packed(model, 'strip_for_deployment')
    for _, conv in _quant_convs(model):
        if conv.w_packed is not None:
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


def packed_weight_bytes(model: torch.nn.Module) -> tuple[int, int]:
    """(bytes of every packed_params leaf, bytes of the fp32 kernels of
    the convs that have packed words), as the JAX function counts."""
    packed = fp = 0
    for _, conv in _quant_convs(model):
        leaves = [getattr(conv, k) for k in PACKED_LEAVES]
        packed += sum(t.numel() * t.element_size() for t in leaves
                      if t is not None)
        if conv.w_packed is not None and conv.kernel is not None:
            fp += conv.kernel.numel() * conv.kernel.element_size()
    return packed, fp
