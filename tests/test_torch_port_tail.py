"""The block's tail in the binary convs' epilogue (ops.binary_infer.Tail).

A served block hands the pointwise ops after a binary conv (a PReLU, the
residual add, the shortcut's eval BatchNorm, a PReLU) to the conv. Here,
on the CPU, where each conv wrapper runs its plain twin:

* each twin with each tail shape equals the eager chain the blocks ran
  before (nn.layers' PReLU and BatchNorm modules and `+`) bit for bit,
  for the ls-1 conv and the multi-plane conv at ls-2 and ls-T groupings,
  bf16 and float32 out, with NaN, +-inf and -0.0 planted in the conv's
  output and in the residual, and negative slopes;
* folded served ResNets of the four block families give logits equal
  bit for bit to the same modules run through the eager chain, with one
  binary conv call handed a tail a binary conv (chip_smoke.tail_calls),
  and none where the tail cannot engage (per-batch scales serve
  unfolded; the bf16 route); the tail launch counter stays put, since
  the CPU launches no kernel.

tests/test_torch_port_tail_kernel.py holds the kernels to these twins on
the card, with the operands built here (`conv_operands`, `tail_case`).
"""

from typing import Callable, Optional

import pytest
import torch

from chip_smoke import tail_calls
from quant_tpu_torch import _build
from quant_tpu_torch.nn import resnet
from quant_tpu_torch.nn.layers import BatchNorm, PReLU
from quant_tpu_torch.ops import binary_infer as BI
from quant_tpu_torch.probes import models

TAILS = ('prelu', 'prelu_add', 'add_prelu', 'bn_add_prelu', 'prelu_bn_add')
GROUPINGS = ('ls-1', 'ls-2', 'ls-T')
DTYPES = (torch.bfloat16, torch.float32)
# (N, H, W, C, O, k, stride, padding): a 3x3 conv whose O fills whole
# 16-byte chunks in both dtypes, and a strided 1x1 conv of a ragged O.
SHAPES = ((2, 7, 7, 40, 24, 3, 1, 1), (3, 8, 8, 64, 13, 1, 2, 0))
SLOPE_A, SLOPE_B = -0.37, 0.1  # negative; off the bf16 grid


def bits(t: torch.Tensor) -> torch.Tensor:
    """t's bit patterns: equal bits are equal values, NaN, -0.0 and all."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def assert_bits_equal(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    same = bits(got) == bits(want)
    assert bool(same.all()), (
        f'{int((~same).sum())} of {same.numel()} values differ, first at '
        f'{tuple(int(i) for i in (~same).nonzero()[0])}')


def plant(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """t with NaN, +inf, -inf and -0.0 written at one element in 16 each."""
    flat = t.view(-1)
    pos = torch.randperm(flat.numel(), generator=gen)
    k = max(1, flat.numel() // 16)
    for i, v in enumerate((float('nan'), float('inf'), float('-inf'),
                           -0.0)):
        flat[pos[i * k:(i + 1) * k]] = v
    return t


def conv_operands(shape: tuple, grouping: str, seed: int
                  ) -> tuple[Callable, tuple]:
    """(conv, its output shape) for a grouping's conv at `shape`:
    conv(out_dtype, tail) runs xnor_conv2d (ls-1) or xnor_conv2d_planes
    (ls-2: two activation planes, ls-T: two planes of one scale) on
    seeded words. vx is 0 for sample 0 and vw negative for a third of the
    channels, so zero dots give -0.0 terms; the bias holds NaN, +-inf and
    -0.0, so the conv's output v does."""
    n, h, w, c, o, k, stride, padding = shape
    gen = torch.Generator().manual_seed(seed)
    wc = -(-c // 32)
    planes = 1 if grouping == 'ls-1' else 2
    groups = 2 if grouping == 'ls-2' else 1

    def words(*dims: int) -> torch.Tensor:
        return torch.randint(-2 ** 31, 2 ** 31, dims, generator=gen,
                             dtype=torch.int64).to(torch.int32)

    x = words(planes, n, h, w, wc)
    wt = words(1, k, k, wc, o)
    vx = torch.rand((groups, n), generator=gen) + 0.1
    vx[:, 0] = 0.0
    vw = (torch.rand((1, o), generator=gen) + 0.01) * torch.where(
        torch.arange(o) % 3 == 0, -1.0, 1.0)
    bias = torch.randn(o, generator=gen)
    bias[:4] = torch.tensor([float('nan'), float('inf'), float('-inf'),
                             -0.0])  # channel 3's vw < 0: -0.0 + -0.0
    oh, ow = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // (
        stride) + 1
    kw = dict(in_channels=c, stride=stride, padding=padding)

    on: dict = {}  # device: the operands there

    def conv(out_dtype: torch.dtype, tail: Optional[BI.Tail] = None,
             device: str = 'cpu', plain: bool = False) -> torch.Tensor:
        """The conv on `device` (its plain twin with `plain`)."""
        if device not in on:
            on[device] = [t.to(device) for t in (x, wt, vx, vw, bias)]
        args = on[device]
        if tail is not None:
            tail = BI.Tail(*(None if t is None else (
                tuple(v.to(device) for v in t) if isinstance(t, tuple)
                else t.to(device)) for t in tail))
        if grouping == 'ls-1':
            fn = BI.xnor_conv2d_plain if plain else BI.xnor_conv2d
            return fn(args[0][0], args[1][0], args[2][0], args[3][0],
                      args[4], out_dtype=out_dtype, tail=tail, **kw)
        fn = BI.xnor_conv2d_planes_plain if plain else BI.xnor_conv2d_planes
        return fn(*args, x_group=planes // groups, out_dtype=out_dtype,
                  tail=tail, **kw)

    return conv, (n, oh, ow, o)


def tail_case(kind: str, shape: tuple, dtype: torch.dtype, seed: int
              ) -> tuple[BI.Tail, Callable]:
    """(the tail of `kind`, eager(v)): the tail handed to a conv of output
    `shape` and its eager chain on the conv's plain output v, as the
    blocks run it (nn.resnet): PReLU modules of slopes SLOPE_A and
    SLOPE_B, `+` and a shortcut BatchNorm in eval (negative gammas among
    its seeded state) on a raw shortcut output of the out dtype; the
    residual and that raw output hold NaN, +-inf and -0.0."""
    gen = torch.Generator().manual_seed(seed)
    act_a, act_b = PReLU(), PReLU()
    with torch.no_grad():
        act_a.negative_slope.fill_(SLOPE_A)
        act_b.negative_slope.fill_(SLOPE_B)
    o = shape[-1]
    bn = BatchNorm(o)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(o, generator=gen))
        bn.bias.copy_(torch.randn(o, generator=gen))
        bn.running_mean.copy_(torch.randn(o, generator=gen))
        bn.running_var.copy_(torch.rand(o, generator=gen) + 0.2)
    r = plant(torch.randn(shape, generator=gen), gen).to(dtype)
    chain = None if dtype == torch.float32 else dtype  # the blocks' dtype
    slope_a, slope_b = act_a.negative_slope, act_b.negative_slope
    with torch.no_grad():
        bn_vecs = tuple(v.detach() for v in bn.eval_affine())
    if kind == 'prelu':
        return BI.Tail(slope_a=slope_a), act_a
    if kind == 'prelu_add':
        return BI.Tail(slope_a, r), lambda v: act_a(v) + r
    if kind == 'add_prelu':
        return BI.Tail(residual=r, slope_b=slope_b), lambda v: act_b(v + r)
    if kind == 'bn_add_prelu':
        return (BI.Tail(residual=r, bn=bn_vecs, slope_b=slope_b),
                lambda v: act_b(v + bn(r, chain)))
    assert kind == 'prelu_bn_add'
    return (BI.Tail(slope_a, r, bn_vecs),
            lambda v: act_a(v) + bn(r, chain))


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('grouping', GROUPINGS)
@pytest.mark.parametrize('kind', TAILS)
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_twin_tail_equals_the_eager_chain(shape, kind, grouping, dtype):
    conv, out_shape = conv_operands(shape, grouping, seed=1)
    tail, eager = tail_case(kind, out_shape, dtype, seed=2)
    before = BI.tail_launches.count
    with tail_calls() as tails, torch.no_grad():
        v = conv(dtype)
        want = eager(v)
        got = conv(dtype, tail)
    assert tails[0] == 1
    assert BI.tail_launches.count == before  # the twin launches nothing
    assert_bits_equal(got, want)
    # The conv's output holds the planted values (the residual holds them
    # by construction).
    assert v.isnan().any() and v.isinf().any()
    assert bool(((v == 0) & (bits(v) < 0)).any())


def test_tail_is_refused_where_it_does_not_fit():
    conv, out_shape = conv_operands(SHAPES[0], 'ls-1', seed=3)
    r = torch.zeros(out_shape)
    with pytest.raises(ValueError, match='residual'):
        conv(torch.bfloat16, BI.Tail(residual=r))
    bad_bn = (torch.zeros(3),) * 3
    with pytest.raises(ValueError, match='BatchNorm'):
        conv(torch.float32, BI.Tail(residual=r, bn=bad_bn))
    with pytest.raises(ValueError, match='needs a residual'):
        conv(torch.float32, BI.Tail(bn=bad_bn))
    with pytest.raises(ValueError, match='slope'):
        conv(torch.float32, BI.Tail(slope_a=torch.zeros(2)))
    x = torch.zeros(1, 4, 4, 8)
    packed = torch.zeros(1, 3, 3, 1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match='int8 route'):
        BI.quant_conv2d_infer(x, x_scheme='ls-1', x_vs=torch.ones(1, 1),
                              w_packed=packed, w_vs=torch.ones(1, 4),
                              in_channels=8, padding=1,
                              tail=BI.Tail(slope_a=torch.tensor(0.25)))


# Served models: (family, x_quant, w_quant, options, tails a forward of
# the small_config model: one a binary conv where the tail engages).
MODEL_CASES = {
    'xnor_double': ('xnor', 'ls-1', 'ls-1', {}, 8),
    'xnor_single': ('xnor', 'ls-1', 'ls-1', {'double_shortcut': False}, 8),
    'xnor_ls2_int8': ('xnor', 'ls-2', 'ls-1', {'sign_compute': 'int8'}, 8),
    'xnor_bottleneck_ls2': ('xnor_bottleneck', 'ls-2', 'ls-1',
                            {'sign_compute': 'int8'}, 12),
    'regular': ('regular', 'ls-1', 'ls-1', {}, 8),
    'regular_bottleneck_lsT': ('regular_bottleneck', 'ls-T', 'ls-1', {},
                               12),
    # Per-batch scales serve unfolded; 'auto' takes the bf16 route for
    # ls-2: neither hands its tail over.
    'xnor_unfolded': ('xnor', 'ls-1', 'ls-1',
                      {'moving_average_mode': 'off'}, 0),
    'xnor_ls2_bf16_route': ('xnor', 'ls-2', 'ls-1', {}, 0),
}


def served_model(case: str) -> torch.nn.Module:
    """MODEL_CASES' model: small_config's, seeded and prepared for
    serving, its PReLU slopes drawn in [-0.5, 0.5]."""
    family, x_quant, w_quant, options, _ = MODEL_CASES[case]
    config = models.small_config(family, x_quant, w_quant)
    for layer in ('layer1', 'layer2', 'layer3', 'layer4'):
        if 'double_shortcut' in options:
            config[layer]['double_shortcut'] = options['double_shortcut']
    kwargs = {k: v for k, v in options.items() if k != 'double_shortcut'}
    model = models.seeded_model(
        lambda xq, wq, **kw: models.build(family, config, **kw),
        x_quant, w_quant, 'cpu', seed=5, **kwargs)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, PReLU):
                m.negative_slope.uniform_(-0.5, 0.5, generator=gen)
    return model


def forward_and_tails(model: torch.nn.Module, x: torch.Tensor
                      ) -> tuple[torch.Tensor, int]:
    """The logits and the binary conv calls handed a tail; the tail
    launch counter stays put (the CPU runs the twins)."""
    before = BI.tail_launches.count
    with tail_calls() as tails:
        logits = model(x)
    assert BI.tail_launches.count == before
    return logits, tails[0]


@pytest.mark.parametrize('dtype', [torch.bfloat16, None], ids=str)
@pytest.mark.parametrize('case', list(MODEL_CASES))
def test_served_model_equals_the_eager_chain(monkeypatch, case, dtype):
    model = served_model(case)
    model.eval_dtype = dtype
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(7))
    got, tails = forward_and_tails(model, x)
    assert tails == MODEL_CASES[case][-1]
    monkeypatch.setattr(resnet._Block, 'tail_engages',
                        lambda self, *a, **kw: False)
    want, eager_tails = forward_and_tails(model, x)
    assert eager_tails == 0
    assert_bits_equal(got, want)


def test_tail_counter_is_a_launch_counter():
    assert _build.COUNTERS['xnor_conv2d_tail'] is BI.tail_launches
