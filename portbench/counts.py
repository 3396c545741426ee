"""The benchmark's yardstick: the card's peaks, the kernel classes, and the
work of a configuration counted from its shapes alone.

Whatever implements a layer, its work is what the layer needs:

- a binary conv of an activation scheme of k_a planes and a weight scheme
  of k_w planes does 2 * MACs * k_a * k_w operations at the int8 peak
  (for ls-2 x ls-1 that is also the time of one bf16 conv over baked
  operands at the bf16 peak, so either route is held to one bound);
- MACs count the kernel taps that fall inside the image (zero padding is
  no work), per output position;
- a binary conv's bytes are its input read once in the chain's dtype,
  its packed sign words (k_w planes of ceil(C_in / 32) int32 words a
  tap and out-channel), its scales and bias (float32), and its output
  written once in the chain's dtype; its least time is the larger of
  bytes over the HBM bandwidth and operations over the int8 peak;
- the stem, the 1x1 shortcut convs and the fc do 2 * MACs at the peak of
  the chain's dtype;
- a train step's model work is 3 x the student's forward (forward,
  input gradient, weight gradient) plus 1 x the frozen teacher's
  forward (walked by the teacher's own block), every conv dense, at the
  train dtype's peak. Recomputation under remat is not work.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, 700 W).
"""

import math
import re
from dataclasses import dataclass
from typing import Iterator, Optional

PEAK_OPS_PER_S = {
    'int8': 1979e12,
    'bfloat16': 989e12,
    'float16': 989e12,
    'tf32': 495e12,
    'float32': 67e12,      # outside the tensor cores (TF32 off)
}
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {'float32': 4, 'bfloat16': 2, 'float16': 2}

# Kernel classes by name, first match wins: the port's binary-conv
# kernels and pools first, then the classes of
# quant_tpu_torch/probes/train_profile.py's CLASSES, as copied here.
BINARY_CONV_PATTERN = r'xnor|pack_sign|binary_conv'
CLASSES = (
    ('binary_conv', BINARY_CONV_PATTERN),
    ('pool', r'pool'),
    ('optimizer', r'adam|multi_tensor|foreach'),
    ('conv', r'conv|cudnn|xmma|implicit|wgrad|dgrad|fprop|winograd|fft'),
    ('gemm', r'gemm|cutlass|cublas|sm90_'),
    ('sort', r'sort|radix|scan'),
    ('reduction', r'reduce|norm|mean|sum'),
    ('copy', r'copy|Memcpy|Memset|cat|transpose|permute'),
    ('elementwise', r'elementwise|vectorized|unrolled|where|index'),
)
POINTWISE_CLASSES = ('elementwise', 'reduction', 'copy')

_COMPILED = tuple((name, re.compile(p, re.IGNORECASE)) for name, p in CLASSES)


def kernel_class(name: str) -> str:
    for cls, pattern in _COMPILED:
        if pattern.search(name):
            return cls
    return 'other'


def scheme_planes(scheme: str) -> int:
    """Sign planes a scheme's values take: fp 0, ls-1 1, ls-2 2, ls-T 2
    (two planes, one scale), gf-k k."""
    if scheme == 'fp':
        return 0
    if scheme == 'ls-1':
        return 1
    if scheme in ('ls-2', 'ls-T'):
        return 2
    if re.fullmatch(r'gf-\d+', scheme):
        return int(scheme.split('-')[1])
    raise ValueError(f'unknown scheme {scheme!r}')


def scheme_scales(scheme: str) -> int:
    """Scale vectors a scheme keeps: ls-T one for its two planes."""
    return 1 if scheme == 'ls-T' else scheme_planes(scheme)


def valid_taps(size: int, out: int, stride: int, pad: int, k: int) -> int:
    """Sum over output positions of the kernel taps inside the input."""
    return sum(sum(0 <= o * stride - pad + i < size for i in range(k))
               for o in range(out))


def out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


@dataclass(frozen=True)
class Layer:
    """One conv or dense layer of a configuration, per image."""
    name: str
    kind: str          # 'stem', 'binary' (a block's conv: fp in a regular
                       # teacher), 'shortcut', 'fc'
    h: int             # input height and width
    w: int
    c_in: int
    c_out: int
    k: int
    stride: int
    pad: int

    @property
    def h_out(self) -> int:
        return out_size(self.h, self.k, self.stride, self.pad)

    @property
    def w_out(self) -> int:
        return out_size(self.w, self.k, self.stride, self.pad)

    @property
    def macs(self) -> int:
        """Multiply-accumulates an image, over the taps inside it."""
        return self.c_in * self.c_out * (
            valid_taps(self.h, self.h_out, self.stride, self.pad, self.k)
            * valid_taps(self.w, self.w_out, self.stride, self.pad, self.k))


def _basic(pre: str, size: int, c_in: int, planes: int, stride: int
           ) -> tuple[list[Layer], int]:
    """A basic block's convs: two 3x3, the block's stride on the first."""
    conv1 = Layer(f'{pre}.conv1', 'binary', size, size, c_in, planes, 3,
                  stride, 1)
    return [conv1, Layer(f'{pre}.conv2', 'binary', conv1.h_out, conv1.w_out,
                         planes, planes, 3, 1, 1)], planes


def _bottleneck(pre: str, size: int, c_in: int, planes: int, stride: int
                ) -> tuple[list[Layer], int]:
    """A bottleneck's convs: a 1x1 reduce to `planes`, a 3x3 with the
    block's stride, a 1x1 expand to 4 x `planes`."""
    conv2 = Layer(f'{pre}.conv2', 'binary', size, size, planes, planes, 3,
                  stride, 1)
    return [Layer(f'{pre}.conv1', 'binary', size, size, c_in, planes, 1, 1,
                  0),
            conv2,
            Layer(f'{pre}.conv3', 'binary', conv2.h_out, conv2.w_out, planes,
                  4 * planes, 1, 1, 0)], 4 * planes


# The block families the walk takes, by a configuration's `block`.
BLOCK_WALKS = {'xnor': _basic, 'regular': _basic,
               'xnor_bottleneck': _bottleneck,
               'regular_bottleneck': _bottleneck}


def layers(config: dict) -> list[Layer]:
    """Every conv and the fc of a ResNet configuration, in forward order:
    the stem, each block's convs (by its `block`: a basic block's two 3x3,
    or a bottleneck's 1x1, 3x3 and 1x1) and its 1x1 shortcut where the
    block changes width or resolution, the fc. A block not in
    BLOCK_WALKS raises."""
    walk = BLOCK_WALKS.get(config['block'])
    if walk is None:
        raise ValueError(f"no walk of the block {config['block']!r}")
    l0 = config['layer0']
    size, c = config['image_size'], config['in_channels']
    width = l0['n_in_channels']
    out = [Layer('conv1', 'stem', size, size, c, width, l0['kernel_size'],
                 l0['stride'], l0['padding'])]
    size = out[0].h_out
    if l0['maxpool']['type'] == 'maxpool2d':
        mp = l0['maxpool']
        size = out_size(size, mp['kernel_size'], mp['stride'],
                        mp['padding'])
    in_planes = width
    for s, blocks in enumerate(config['num_blocks']):
        planes = width * 2 ** s
        for b in range(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            pre = f'layer{s + 1}_block{b}'
            convs, out_planes = walk(pre, size, in_planes, planes, stride)
            out += convs
            if stride != 1 or in_planes != out_planes:
                out.append(Layer(f'{pre}.shortcut.conv', 'shortcut', size,
                                 size, in_planes, out_planes, 1, stride, 0))
            size, in_planes = convs[-1].h_out, out_planes
    out.append(Layer('fc', 'fc', 1, 1, in_planes, config['output_classes'],
                     1, 1, 0))
    return out


def binary_conv_ops(layer: Layer, x_quant: str, w_quant: str) -> int:
    """Operations of one image through a binary conv at the int8 peak."""
    return 2 * layer.macs * scheme_planes(x_quant) * scheme_planes(w_quant)


def binary_conv_bytes(layer: Layer, batch: int, w_quant: str,
                      chain_dtype: str) -> int:
    """Bytes a binary conv must move for a batch (module docstring)."""
    e = DTYPE_BYTES[chain_dtype]
    words = math.ceil(layer.c_in / 32)
    k_w = scheme_planes(w_quant)
    return (batch * layer.h * layer.w * layer.c_in * e
            + k_w * layer.k * layer.k * words * layer.c_out * 4
            + (scheme_scales(w_quant) + 1) * layer.c_out * 4
            + batch * layer.h_out * layer.w_out * layer.c_out * e)


def binary_conv_bound_s(config: dict, batch: int) -> float:
    """The least time of a forward's binary convs on the card."""
    serve = config['serve']
    total = 0.0
    for layer in layers(config):
        if layer.kind != 'binary':
            continue
        ops = batch * binary_conv_ops(layer, config['x_quant'],
                                      config['w_quant'])
        nbytes = binary_conv_bytes(layer, batch, config['w_quant'],
                                   serve['eval_dtype'])
        total += max(ops / PEAK_OPS_PER_S['int8'], nbytes / HBM_BYTES_PER_S)
    return total


def serve_peak_s(config: dict) -> float:
    """An image's serving forward at peak: binary convs at the int8 peak,
    the stem, shortcuts and fc at the chain dtype's."""
    dense_peak = PEAK_OPS_PER_S[config['serve']['eval_dtype']]
    total = 0.0
    for layer in layers(config):
        if layer.kind == 'binary':
            total += binary_conv_ops(layer, config['x_quant'],
                                     config['w_quant']) / PEAK_OPS_PER_S['int8']
        else:
            total += 2 * layer.macs / dense_peak
    return total


def train_peak_s(config: dict) -> float:
    """An image's train step at peak: 3 x the student's dense forward at
    the train dtype's peak plus the teacher's forward, walked by its own
    `block`, at its dtype's."""
    train = config['train']
    student_peak = PEAK_OPS_PER_S[_peak_key(train['train_dtype'],
                                            train.get('tf32', False))]
    teacher_peak = PEAK_OPS_PER_S[_peak_key(train['teacher']['dtype'],
                                            train.get('tf32', False))]
    student = sum(layer.macs for layer in layers(config))
    teacher = sum(layer.macs
                  for layer in layers({**config, **train['teacher']}))
    return 3 * 2 * student / student_peak + 2 * teacher / teacher_peak


def _peak_key(dtype: str, tf32: bool) -> str:
    return 'tf32' if (dtype == 'float32' and tf32) else dtype


def walk_binary(config: dict) -> Iterator[Layer]:
    yield from (layer for layer in layers(config) if layer.kind == 'binary')


def class_seconds(kernels: list, classes: tuple[str, ...]) -> Optional[float]:
    """Seconds of device time in kernels of `classes`; None if none ran."""
    secs = [k.seconds for k in kernels if kernel_class(k.name) in classes]
    return sum(secs) if secs else None
