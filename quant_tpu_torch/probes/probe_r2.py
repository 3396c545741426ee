"""Chip probes, first set: matmul, conv, elementwise and stem rates on the
card (port of tools/probe_r2.py, one probe per JAX probe, same names).

The JAX probes measured XLA's ops on the TPU; here the same work goes to
PyTorch's ops on the GPU (cuBLAS, cuDNN), except `pallas_add` and
`pallas_matmul_bf16`, which run the port's own kernels (csrc/probe.cu).
Shapes are the JAX probes' unless a docstring says otherwise. Each probe
chains its op's output into its next input (`chain`: one element, in
place) and reports time per rep (`common.timed_loop`).

TF32 is stated in every float32 record and set for it: JAX's default f32
precision maps to TF32 on, Precision.HIGHEST to TF32 off. PyTorch has no
int8 conv on CUDA, so the int8 conv probes run their im2col or shift
form through torch._int_mm, with the constant weights stored column-major
(`common.col_major`).

Usage: python -m quant_tpu_torch.probes.probe_r2 <probe> | --all
           [--device cuda] [--out PATH]
       python -m quant_tpu_torch.probes.probe_r2 --list
"""

import sys
import time
from typing import Callable

import torch
import torch.nn.functional as F

from quant_tpu_torch import _build
from quant_tpu_torch.device import DeviceLike, resolve_device
from quant_tpu_torch.ops.conv import conv2d, stem_conv_s2d
from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1
from quant_tpu_torch.probes import kernels as K
from quant_tpu_torch.probes.common import (
    col_major, im2col3x3, main, nchw, oihw, pm1, randint, randn, record,
    registrar, tf32, timed_loop,
)

PROBES: dict[str, Callable[..., None]] = {}
probe = registrar(PROBES)


def chain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x made to depend on y without changing a value: x's first element
    adds 0 * y's first element, in place (the JAX probes' `x + y[:1]*0`
    carry, without a pass over x)."""
    x[(0,) * x.ndim].add_(y[(0,) * y.ndim].to(x.dtype), alpha=0)
    return x


def _matmul_probe(dev: torch.device, dtype: torch.dtype, n: int,
                  inner: int = 16, b_col_major: bool = False) -> float:
    """T(FL)OP/s of an n^3 matmul; bf16 and f32 through torch.matmul
    (bf16 output, summed in f32), int8 through torch._int_mm (int32),
    with B row-major or, if asked, column-major (the same values)."""
    if dtype == torch.int8:
        a = randint(-127, 127, (n, n), dev, dtype)
        b = randint(-127, 127, (n, n), dev, dtype, seed=1)
        if b_col_major:
            b = col_major(b)
        mm = torch._int_mm
    else:
        a = randn((n, n), dev, dtype)
        b = randn((n, n), dev, dtype, seed=1)
        mm = torch.matmul
    sec, _ = timed_loop(lambda a: chain(a, mm(a, b)), a, dev, inner)
    return 2 * n ** 3 / sec / 1e12


@probe
def matmul_bf16(device: DeviceLike = 'cuda', n: int = 8192) -> None:
    dev = resolve_device(device)
    record('matmul_bf16', dev, tflops=_matmul_probe(dev, torch.bfloat16, n),
           n=n)


@probe
def matmul_f32(device: DeviceLike = 'cuda', n: int = 4096) -> None:
    dev = resolve_device(device)
    with tf32(True):
        t = _matmul_probe(dev, torch.float32, n)
    record('matmul_f32', dev, tflops=t, n=n, tf32=True)


@probe
def matmul_int8(device: DeviceLike = 'cuda', n: int = 8192,
                inner: int = 16) -> None:
    """torch._int_mm with B row-major (the JAX probe's layout) and with
    B column-major."""
    dev = resolve_device(device)
    for col in (False, True):
        record('matmul_int8', dev, n=n, b_layout='col' if col else 'row',
               tops=_matmul_probe(dev, torch.int8, n, inner, col))


# ResNet-18 conv shapes (NHWC): (name, H, Cin, Cout, k, stride)
RESNET_SHAPES = [
    ('stem', 224, 3, 64, 7, 2),
    ('l1', 56, 64, 64, 3, 1),
    ('l2a', 56, 64, 128, 3, 2),
    ('l2b', 28, 128, 128, 3, 1),
    ('l3a', 28, 128, 256, 3, 2),
    ('l3b', 14, 256, 256, 3, 1),
    ('l4a', 14, 256, 512, 3, 2),
    ('l4b', 7, 512, 512, 3, 1),
    ('ds2', 56, 64, 128, 1, 2),
    ('ds3', 28, 128, 256, 1, 2),
    ('ds4', 14, 256, 512, 1, 2),
]


def _conv_time(dev: torch.device, batch: int, h: int, cin: int, cout: int,
              k: int, stride: int, dtype: torch.dtype = torch.bfloat16,
              inner: int = 10) -> tuple[float, float]:
    """(seconds, TFLOP/s) of one F.conv2d on ±1 operands, channels_last,
    TF32 off (float32 is full precision)."""
    x = nchw(pm1((batch, h, h, cin), dev, dtype))
    w = oihw(pm1((k, k, cin, cout), dev, dtype, seed=1))
    pad = (k - 1) // 2

    def step(x: torch.Tensor) -> torch.Tensor:
        return chain(x, F.conv2d(x, w, stride=stride, padding=pad))

    with tf32(False):
        sec, _ = timed_loop(step, x, dev, inner)
    ho = (h + 2 * pad - k) // stride + 1
    return sec, 2 * batch * ho * ho * cout * cin * k * k / sec / 1e12


@probe
def conv_shapes_bf16(device: DeviceLike = 'cuda') -> None:
    dev = resolve_device(device)
    batch = 256
    for name, h, cin, cout, k, s in RESNET_SHAPES:
        sec, tf = _conv_time(dev, batch, h, cin, cout, k, s)
        record('conv_shapes_bf16', dev, shape=name, batch=batch,
               ms=sec * 1e3, tflops=tf)


@probe
def conv_l1_batches(device: DeviceLike = 'cuda') -> None:
    dev = resolve_device(device)
    for batch in (128, 512, 1024):
        sec, tf = _conv_time(dev, batch, 56, 64, 64, 3, 1)
        record('conv_l1_batches', dev, batch=batch, ms=sec * 1e3,
               tflops=tf)


@probe
def conv_stem_fp32_highest(device: DeviceLike = 'cuda') -> None:
    dev = resolve_device(device)
    sec, tf = _conv_time(dev, 256, 224, 3, 64, 7, 2, dtype=torch.float32)
    record('conv_stem_fp32_highest', dev, ms=sec * 1e3, tflops=tf,
           tf32=False)


@probe
def elementwise_chain(device: DeviceLike = 'cuda') -> None:
    """BN + PReLU + sign on a layer1-sized bf16 tensor -> GB/s, counting
    one read and one write of the tensor per rep (PyTorch runs the chain
    as separate passes; JAX fused it)."""
    dev = resolve_device(device)
    x = randn((256, 56, 56, 64), dev, torch.bfloat16)
    g = torch.ones(64, dtype=torch.bfloat16, device=dev)
    b = torch.zeros(64, dtype=torch.bfloat16, device=dev)

    def step(x: torch.Tensor) -> torch.Tensor:
        y = x * g + b
        y = torch.where(y >= 0, y, 0.25 * y)
        return chain(x, torch.sign(y))

    sec, _ = timed_loop(step, x, dev, 20)
    gb = 2 * x.numel() * 2 / 1e9
    record('elementwise_chain', dev, ms=sec * 1e3, gbps=gb / sec)


@probe
def maxpool(device: DeviceLike = 'cuda') -> None:
    """The stem pool on (256, 112, 112, 64) bf16: the port's kernel
    (`ms`) beside F.max_pool2d on the channels_last view
    (`library_ms`)."""
    dev = resolve_device(device)
    x = randn((256, 112, 112, 64), dev, torch.bfloat16)

    def rate(pool: Callable[[torch.Tensor], torch.Tensor]) -> float:
        sec, _ = timed_loop(lambda x: chain(x, pool(x)), x, dev, 20)
        return sec * 1e3

    record('maxpool', dev, ms=rate(max_pool_3x3_s2_p1),
           library_ms=rate(lambda t: F.max_pool2d(nchw(t), 3, 2, 1)))


@probe
def stem_s2d(device: DeviceLike = 'cuda') -> None:
    """The stem conv (7x7/s2/p3, bf16, batch 256) in its exact
    space-to-depth form (ops.conv.stem_conv_s2d: 2x2 blocks -> 12
    channels, one 4x4/s1 conv) and as the regular conv (ops.conv.conv2d),
    with the slice carry. The JAX probe timed a 4x4 conv with random
    weights over 114x114 blocks, the form stem_conv_s2d makes exact."""
    dev = resolve_device(device)
    x = randn((256, 224, 224, 3), dev, torch.bfloat16)
    w = randn((7, 7, 3, 64), dev, torch.bfloat16, seed=1) * 0.05

    def rate(fn: Callable[[torch.Tensor], torch.Tensor]) -> float:
        sec, _ = timed_loop(lambda x: chain(x, fn(x)), x, dev, 10)
        return sec * 1e3

    with tf32(False):
        record('stem_s2d', dev, ms=rate(lambda t: stem_conv_s2d(t, w)))
        record('stem_regular', dev,
               ms=rate(lambda t: conv2d(t, w, stride=2, padding=3)))


@probe
def winograd_matmuls(device: DeviceLike = 'cuda') -> None:
    """The F(2x2,3x3) transform-domain cost: 16 batched matmuls of
    (B*(H/2)^2, C) @ (C, C) through torch.bmm, against the direct 3x3
    conv, per layer width."""
    dev = resolve_device(device)
    batch = 256
    for cname, h, c in (('l1', 56, 64), ('l3b', 14, 256), ('l4b', 7, 512)):
        tiles = (h // 2) ** 2
        a = randn((16, batch * tiles, c), dev, torch.bfloat16)
        w = randn((16, c, c), dev, torch.bfloat16, seed=1)
        sec, _ = timed_loop(lambda a: chain(a, torch.bmm(a, w)), a, dev, 10)
        sec_direct, tf_direct = _conv_time(dev, batch, h, c, c, 3, 1)
        record('winograd_matmuls', dev, layer=cname, batch=batch,
               wino_matmul_ms=sec * 1e3, direct_conv_ms=sec_direct * 1e3,
               direct_tflops=tf_direct)


@probe
def matmul_int4(device: DeviceLike = 'cuda') -> None:
    """int4 matmul rate: not available on this card."""
    dev = resolve_device(device)
    record('matmul_int4', dev, available=False,
           reason='PyTorch has no int4 x int4 matmul on CUDA, and the H100 '
                  'data sheet gives its tensor cores no int4 rate')


def _shift_matmul_conv(dev: torch.device, batch: int, h: int, cin: int,
                       cout: int, dtype: torch.dtype,
                       inner: int = 8) -> tuple[float, float]:
    """3x3 s1 conv as 9 shifted (B*H*W, Cin) @ (Cin, Cout) matmuls: bf16
    through torch.matmul (bf16 products summed in bf16), int8 through
    torch._int_mm (int32)."""
    if dtype == torch.int8:
        x = randint(-1, 2, (batch, h, h, cin), dev, dtype) * 2 - 1
        ws = [col_major(randint(-1, 2, (cin, cout), dev, dtype, seed=1 + i))
              for i in range(9)]
        mm = torch._int_mm
    else:
        x = pm1((batch, h, h, cin), dev, dtype)
        ws = [pm1((cin, cout), dev, dtype, seed=1 + i) for i in range(9)]
        mm = torch.matmul

    def step(x: torch.Tensor) -> torch.Tensor:
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        acc = None
        for i in range(9):
            dy, dx = divmod(i, 3)
            xs = xp[:, dy:dy + h, dx:dx + h, :].reshape(batch * h * h, cin)
            y = mm(xs, ws[i])
            acc = y if acc is None else acc + y
        return chain(x, acc)

    sec, _ = timed_loop(step, x, dev, inner)
    return sec, 2 * batch * h * h * cin * cout * 9 / sec / 1e12


@probe
def conv_shift_matmul(device: DeviceLike = 'cuda') -> None:
    """Shift-matmul conv in bf16 and int8 on the 3x3 stride-1 ResNet
    shapes."""
    dev = resolve_device(device)
    batch = 256
    for name, h, c in (('l1', 56, 64), ('l2b', 28, 128),
                       ('l3b', 14, 256), ('l4b', 7, 512)):
        sec_bf, tf_bf = _shift_matmul_conv(dev, batch, h, c, c,
                                           torch.bfloat16)
        record('conv_shift_matmul', dev, layer=name, dtype='bf16',
               ms=sec_bf * 1e3, tflops=tf_bf)
        sec_i8, tf_i8 = _shift_matmul_conv(dev, batch, h, c, c, torch.int8)
        record('conv_shift_matmul', dev, layer=name, dtype='int8',
               ms=sec_i8 * 1e3, tops=tf_i8)


@probe
def conv_im2col_int8(device: DeviceLike = 'cuda') -> None:
    """3x3 conv as one int8 matmul over im2col patches (K = 9*Cin),
    through torch._int_mm."""
    dev = resolve_device(device)
    batch = 256
    for name, h, c in (('l1', 56, 64), ('l3b', 14, 256), ('l4b', 7, 512)):
        x = pm1((batch, h, h, c), dev, torch.int8)
        w = col_major(pm1((9 * c, c), dev, torch.int8, seed=1))
        sec, _ = timed_loop(
            lambda x: chain(x, torch._int_mm(im2col3x3(x), w)), x, dev, 8)
        flops = 2 * batch * h * h * c * c * 9
        record('conv_im2col_int8', dev, layer=name, ms=sec * 1e3,
               tops=flops / sec / 1e12)


@probe
def conv_s8_small(device: DeviceLike = 'cuda') -> None:
    """Does a tiny int8 conv run, and is it exact? PyTorch has no int8
    conv on CUDA, so it is the im2col form through torch._int_mm, held
    against a float64 conv."""
    dev = resolve_device(device)
    x = pm1((8, 8, 8, 32), dev, torch.int8)
    w = pm1((3, 3, 32, 32), dev, torch.int8, seed=1)
    y = torch._int_mm(im2col3x3(x), col_major(w.reshape(9 * 32, 32)))
    want = F.conv2d(nchw(x.double()), oihw(w.double()), padding=1)
    want = want.permute(0, 2, 3, 1).reshape(8 * 8 * 8, 32)
    record('conv_s8_small', dev, ran=True, checksum=int(y.sum()),
           correct=bool(torch.equal(y.double(), want)))


@probe
def pallas_add(device: DeviceLike = 'cuda') -> None:
    """Does the port's add kernel build and launch, and is x + 2x = 3x?"""
    dev = resolve_device(device)
    build_s = None
    if dev.type == 'cuda':
        t0 = time.perf_counter()
        _build.build(['probe'])
        build_s = time.perf_counter() - t0
    x = torch.arange(1024 * 256, dtype=torch.float32,
                     device=dev).reshape(1024, 256)
    y = K.add(x, 2.0 * x)
    record('pallas_add', dev, compiled=dev.type == 'cuda', build_s=build_s,
           correct=bool(torch.equal(y, 3.0 * x)))


@probe
def pallas_matmul_bf16(device: DeviceLike = 'cuda', n: int = 4096,
                       inner: int = 8) -> None:
    """The port's tiled tensor-core matmul at n^3 in bf16 (f32 sums; A
    and B equal, as the JAX probe drew both from one key). The JAX
    kernel took 512x512 output tiles over full-K strips; the port's
    kernel takes 128x128 tiles over 32-deep K slices."""
    dev = resolve_device(device)
    a = randn((n, n), dev, torch.bfloat16)
    b = a.clone()
    sec, _ = timed_loop(lambda a: chain(a, K.tiled_matmul(a, b)), a, dev,
                        inner)
    record('pallas_matmul_bf16', dev, tflops=2 * n ** 3 / sec / 1e12,
           ms=sec * 1e3, n=n)


if __name__ == '__main__':
    sys.exit(main(PROBES, __doc__))
