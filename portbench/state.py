"""Weights, state and inputs of a cell, drawn from the seed on the device.

Every leaf is named as the published model's variable tree names it (the
JAX package's, which the program keeps: `layer1_block0.conv1.kernel`,
HWIO kernels, (in, out) dense kernels) and drawn by its kind, one call
to the generator a kind, so a run's set-up draws in a few large calls.
The distributions are trained-like: kernels and biases as torch's
default init, BN affines with 30% negative gammas and random running
statistics, PReLU slopes, EMA activation scales near (0.9, 0.45) (inside
the clamp's box, so the threshold fold holds), and the weight scales a
trained model caches, solved from the drawn kernels. The program and the
reference are handed the same tensors.
"""

import math

import torch

from portbench import counts

EMA_BASE = (0.9, 0.45)
NEGATIVE_GAMMA_SHARE = 0.3

Leaf = tuple[str, tuple[int, ...], str, int]   # name, shape, kind, fan_in


def _bn(p: str, c: int) -> list[Leaf]:
    return [(f'{p}.weight', (c,), 'bn_weight', 0),
            (f'{p}.bias', (c,), 'bn_bias', 0),
            (f'{p}.running_mean', (c,), 'bn_mean', 0),
            (f'{p}.running_var', (c,), 'bn_var', 0)]


def _conv(p: str, k: int, c_in: int, c_out: int, bias: bool) -> list[Leaf]:
    fan_in = k * k * c_in
    out = [(f'{p}.kernel', (k, k, c_in, c_out), 'uniform', fan_in)]
    if bias:
        out.append((f'{p}.bias', (c_out,), 'uniform', fan_in))
    return out


def _planes(scheme: str) -> int:
    return {'fp': 0, 'ls-1': 1, 'ls-2': 2, 'ls-T': 1}[scheme]


def _xnor_conv(name: str, k: int, c_in: int, c_out: int, k_w: int,
               k_x: int, ema: bool) -> list[Leaf]:
    """An XNOR block's nth BN -> binary conv -> PReLU (`name` the conv's:
    `<block>.conv<n>`), the BN over the conv's input."""
    p, n = name.rsplit('.conv', 1)
    out = _bn(f'{p}.bn{n}', c_in) + _conv(name, k, c_in, c_out, True)
    out.append((f'{name}.w_vs', (k_w, c_out), 'w_vs', 0))
    if ema:
        out.append((f'{name}.x_quantizer.ema', (k_x,), 'ema', 0))
        out.append((f'{name}.x_quantizer.ema_count', (), 'ema_count', 0))
    out.append((f'{p}.nonlin{n}.negative_slope', (), 'slope', 0))
    return out


def _regular_conv(name: str, k: int, c_in: int, c_out: int) -> list[Leaf]:
    """A regular block's nth conv -> BN, the BN over the conv's output."""
    p, n = name.rsplit('.conv', 1)
    return _conv(name, k, c_in, c_out, False) + _bn(f'{p}.bn{n}', c_out)


STUDENT_BLOCKS = ('xnor', 'xnor_bottleneck')
TEACHER_BLOCKS = ('regular', 'regular_bottleneck')


def leaves(config: dict, teacher: bool = False,
           ema: bool = False) -> list[Leaf]:
    """Every parameter and buffer of a ResNet of `config`, named and
    shaped as QResNet's state dict, in the forward order of its convs
    (counts.layers, which walks the configuration's `block`): its XNOR
    student (STUDENT_BLOCKS; with EMA activation scales where `ema`) or,
    with `teacher`, its regular fp teacher (TEACHER_BLOCKS). Any other
    block raises."""
    families = TEACHER_BLOCKS if teacher else STUDENT_BLOCKS
    if config['block'] not in families:
        raise ValueError(
            f"no {'teacher' if teacher else 'student'} state of the block "
            f"{config['block']!r}")
    k_x, k_w = _planes(config['x_quant']), _planes(config['w_quant'])
    out: list[Leaf] = []
    for layer in counts.layers(config):
        k, c_in, c_out = layer.k, layer.c_in, layer.c_out
        if layer.kind == 'stem':
            out += (_conv('conv1', k, c_in, c_out, config['layer0']['bias'])
                    + _bn('bn1', c_out))
        elif layer.kind == 'binary':
            out += (_regular_conv(layer.name, k, c_in, c_out) if teacher
                    else _xnor_conv(layer.name, k, c_in, c_out, k_w, k_x,
                                    ema))
        elif layer.kind == 'shortcut':
            out += (_conv(layer.name, 1, c_in, c_out, not teacher)
                    + _bn(layer.name[:-len('conv')] + 'norm', c_out))
        else:
            out += [('fc.kernel', (c_in, c_out), 'uniform', c_in),
                    ('fc.bias', (c_out,), 'uniform', c_in)]
    return out


def _draw(kind: str, u: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    """A leaf from uniforms in [0, 1): two a value for bn_weight."""
    fan_in = leaf[3]
    if kind == 'uniform':
        bound = 1.0 / math.sqrt(fan_in)
        return (2.0 * u - 1.0) * bound
    if kind == 'bn_weight':
        mag, pick = u.chunk(2)
        return (0.3 + 1.2 * mag) * torch.where(
            pick < NEGATIVE_GAMMA_SHARE, -1.0, 1.0)
    if kind == 'bn_bias':
        return 1.6 * u - 0.8
    if kind == 'bn_mean':
        return u - 0.5
    if kind == 'bn_var':
        return 0.2 + 1.8 * u
    if kind == 'slope':
        return 0.1 + 0.25 * u
    if kind == 'ema':
        base = torch.tensor(EMA_BASE[:u.numel()], device=u.device)
        return base * (0.9 + 0.1 * u)
    raise ValueError(f'unknown leaf kind {kind!r}')


_DRAWN = ('uniform', 'bn_weight', 'bn_bias', 'bn_mean', 'bn_var', 'slope',
          'ema')


def draw(spec: list[Leaf], gen: torch.Generator,
         device: torch.device) -> dict[str, torch.Tensor]:
    """The state of `spec` from `gen`, one generator call a kind; the
    cached weight scales (`w_vs`) solved from the drawn kernels as the
    ls-1 weight quantizer solves them (mean |w| of each out-channel)."""
    state: dict[str, torch.Tensor] = {}
    for kind in _DRAWN:
        group = [leaf for leaf in spec if leaf[2] == kind]
        if not group:
            continue
        per = [math.prod(leaf[1]) * (2 if kind == 'bn_weight' else 1)
               for leaf in group]
        flat = torch.rand(sum(per), generator=gen, device=device)
        for leaf, u in zip(group, flat.split(per)):
            state[leaf[0]] = _draw(kind, u, leaf).reshape(leaf[1])
    for name, shape, kind, _ in spec:
        if kind == 'ema_count':
            state[name] = torch.ones((), dtype=torch.int32, device=device)
        elif kind == 'w_vs':
            if shape[0] != 1:
                raise NotImplementedError('cached scales of ls-1 weights only')
            kernel = state[name[:-len('w_vs')] + 'kernel']
            state[name] = kernel.abs().mean((0, 1, 2))[None]
    return {name: state[name] for name, *_ in spec}


def images(gen: torch.Generator, device: torch.device, pool: int, batch: int,
           size: int, channels: int) -> torch.Tensor:
    """(pool, batch, size, size, channels) float32 NHWC, standard normal."""
    return torch.randn((pool, batch, size, size, channels), generator=gen,
                       device=device)


def labels(gen: torch.Generator, device: torch.device, pool: int, batch: int,
           classes: int) -> torch.Tensor:
    return torch.randint(0, classes, (pool, batch), generator=gen,
                         device=device)


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def serve_state(config: dict, gen: torch.Generator,
                device: torch.device) -> dict[str, torch.Tensor]:
    return draw(leaves(config, ema=True), gen, device)


def train_states(config: dict, gen: torch.Generator, device: torch.device
                 ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(student, teacher) of the train form: the student without EMA
    state (moving_average_mode 'off')."""
    student = draw(leaves(config), gen, device)
    teacher = draw(leaves({**config, **config['train']['teacher']},
                          teacher=True), gen, device)
    return student, teacher
