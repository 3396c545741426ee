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


def leaves(config: dict, teacher: bool = False,
           ema: bool = False) -> list[Leaf]:
    """Every parameter and buffer of a basic-block ResNet of `config`:
    its XNOR student (with EMA activation scales where `ema`) or, with
    `teacher`, its regular fp teacher."""
    l0 = config['layer0']
    width = l0['n_in_channels']
    out = _conv('conv1', l0['kernel_size'], config['in_channels'], width,
                l0['bias']) + _bn('bn1', width)
    k_x, k_w = _planes(config['x_quant']), _planes(config['w_quant'])
    in_planes = width
    for s, blocks in enumerate(config['num_blocks']):
        planes = width * 2 ** s
        for b in range(blocks):
            p = f'layer{s + 1}_block{b}'
            down = (s > 0 and b == 0) or in_planes != planes
            if teacher:
                out += (_conv(f'{p}.conv1', 3, in_planes, planes, False)
                        + _bn(f'{p}.bn1', planes)
                        + _conv(f'{p}.conv2', 3, planes, planes, False)
                        + _bn(f'{p}.bn2', planes))
            else:
                for n, c_in in (('1', in_planes), ('2', planes)):
                    out += _bn(f'{p}.bn{n}', c_in)
                    out += _conv(f'{p}.conv{n}', 3, c_in, planes, True)
                    out.append((f'{p}.conv{n}.w_vs', (k_w, planes), 'w_vs',
                                0))
                    if ema:
                        out.append((f'{p}.conv{n}.x_quantizer.ema', (k_x,),
                                    'ema', 0))
                        out.append((f'{p}.conv{n}.x_quantizer.ema_count',
                                    (), 'ema_count', 0))
                    out.append((f'{p}.nonlin{n}.negative_slope', (),
                                'slope', 0))
            if down:
                out += _conv(f'{p}.shortcut.conv', 1, in_planes, planes,
                             not teacher)
                out += _bn(f'{p}.shortcut.norm', planes)
            in_planes = planes
    out += [('fc.kernel', (in_planes, config['output_classes']), 'uniform',
             in_planes),
            ('fc.bias', (config['output_classes'],), 'uniform', in_planes)]
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
