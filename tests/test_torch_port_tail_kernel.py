"""The binary convs' tail on the card: xnor_conv2d and xnor_conv2d_planes
with each tail (ops.binary_infer.Tail) against their plain twins, which
apply the tail with the eager ops, bit for bit.

The tests marked `card` need a CUDA card and skip elsewhere (the `card`
fixture decides, never the import). On the card:

    python -m pytest tests/test_torch_port_tail_kernel.py -m card -q

The operands and tails are tests/test_torch_port_tail.py's (which holds
the twins to the blocks' eager chain on the CPU): NaN, +-inf and -0.0 in
the conv's output and in the residual, negative slopes, ls-1, ls-2 and
ls-T groupings, bf16 and float32 out, at the shapes of the served
ResNets' layer1 (ResNet-50's conv3, a 1x1 conv of 64 into 256 channels
at 56x56; ResNet-18's conv2, a 3x3 conv of 64 channels at 56x56) and at
a ragged O. The file imports no JAX.
"""

import pytest
import torch

from quant_tpu_torch.ops import binary_infer as BI
from tests.test_torch_port_tail import (
    DTYPES, GROUPINGS, TAILS, assert_bits_equal, conv_operands, tail_case,
)

# (N, H, W, C, O, k, stride, padding).
CARD_SHAPES = {
    'r50_layer1_conv3': (4, 56, 56, 64, 256, 1, 1, 0),
    'r18_layer1_conv2': (4, 56, 56, 64, 64, 3, 1, 1),
    'ragged_o': (3, 15, 15, 96, 45, 3, 2, 1),
}


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('grouping', GROUPINGS)
@pytest.mark.parametrize('kind', TAILS)
@pytest.mark.parametrize('shape', list(CARD_SHAPES))
def test_kernel_tail_equals_the_twin(card, shape, kind, grouping, dtype):
    conv, out_shape = conv_operands(CARD_SHAPES[shape], grouping, seed=11)
    tail, _ = tail_case(kind, out_shape, dtype, seed=12)
    with torch.no_grad():
        want = conv(dtype, tail, device='cuda', plain=True)
        before = BI.tail_launches.count
        got = conv(dtype, tail, device='cuda')
        launched = BI.tail_launches.count - before
        plain = conv(dtype, device='cuda')
    torch.cuda.synchronize()
    assert launched == 1  # the launch with a tail, and only it, counts
    assert BI.tail_launches.count == before + 1
    assert_bits_equal(got, want)
    assert_bits_equal(plain, conv(dtype, device='cuda', plain=True))


@pytest.mark.card
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('layout', [(1, 1, 1, 1), (2, 1, 1, 1),
                                    (1, 2, 1, 1)], ids=str)
def test_tail_instances_keep_three_blocks_an_sm(card, layout, dtype):
    """Without a tail the instances are as before; with one, they still
    hold 3 blocks an SM (ls-1's conv, ls-2's two groups, ls-T's pair)."""
    regs, blocks = BI.conv_occupancy(dtype, *layout)
    tail_regs, tail_blocks = BI.conv_occupancy(dtype, *layout, tail=True)
    print(f'{layout} {dtype}: {regs} registers without the tail, '
          f'{tail_regs} with it')
    assert blocks == tail_blocks == 3
