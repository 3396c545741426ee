"""Chip probes, second set: chained rates, the stem against its s2d form,
the served model's batch sweep and the tiled tensor-core matmul (port of
tools/probe_r3.py, one probe per JAX probe, same names).

Where the JAX probe chains an op's output into its next input, so does
this one; elsewhere the carry is the JAX probe's. PyTorch runs eagerly
and removes no work, so no reduction is needed to force a result; the
ones JAX used are kept where they are part of the carry. Library ops as
in probe_r2 (cuBLAS, cuDNN, torch._int_mm for int8); the two
`pallas_matmul_*` probes run the port's kernel (csrc/probe.cu).

Usage: python -m quant_tpu_torch.probes.probe_r3 <probe> | --all
           [--device cuda] [--out PATH]
       python -m quant_tpu_torch.probes.probe_r3 --list
"""

import sys
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from quant_tpu_torch.device import DeviceLike, resolve_device
from quant_tpu_torch.ops.conv import conv2d, stem_conv_s2d
from quant_tpu_torch.probes import kernels as K
from quant_tpu_torch.probes.common import (
    col_major, im2col3x3, main, nchw, oihw, pm1, randn, record, registrar,
    tf32, timed_loop,
)
from quant_tpu_torch.probes.models import seeded_serving_resnet18

PROBES: dict[str, Callable[..., None]] = {}
probe = registrar(PROBES)
EPS = 1e-30
LAYERS = (('l1', 56, 64), ('l2b', 28, 128), ('l3b', 14, 256),
          ('l4b', 7, 512))


def _matmul_chain(dev: torch.device, dtype: torch.dtype, n: int = 8192,
                  inner: int = 16) -> float:
    """a <- a @ b in dtype (torch.matmul, f32 sums): the output is the
    next input; values decay toward 0 with the 1/n scaling, which does
    not change the time."""
    a = randn((n, n), dev, dtype) / n
    b = randn((n, n), dev, dtype, seed=1) / n
    sec, _ = timed_loop(lambda a: a @ b, a, dev, inner)
    return 2 * n ** 3 / sec / 1e12


@probe
def matmul_chain_bf16(device: DeviceLike = 'cuda', n: int = 8192,
                      inner: int = 16) -> None:
    dev = resolve_device(device)
    record('matmul_chain_bf16', dev,
           tflops=_matmul_chain(dev, torch.bfloat16, n, inner), n=n)


@probe
def matmul_chain_f32(device: DeviceLike = 'cuda') -> None:
    """float32 at the default precision: TF32 on."""
    dev = resolve_device(device)
    with tf32(True):
        t = _matmul_chain(dev, torch.float32, n=4096)
    record('matmul_chain_f32', dev, tflops=t, n=4096, tf32=True)


@probe
def matmul_chain_f32_highest(device: DeviceLike = 'cuda') -> None:
    """float32 at Precision.HIGHEST: TF32 off."""
    dev = resolve_device(device)
    with tf32(False):
        t = _matmul_chain(dev, torch.float32, n=4096)
    record('matmul_chain_f32_highest', dev, tflops=t, n=4096, tf32=False)


def _conv_chain(dev: torch.device, batch: int, h: int, c: int, k: int = 3,
                dtype: torch.dtype = torch.bfloat16,
                inner: int = 10) -> tuple[float, float]:
    """x <- sign(conv(x, w)), 3x3 s1 'same', C -> C, channels_last."""
    x = nchw(pm1((batch, h, h, c), dev, dtype))
    w = oihw(pm1((k, k, c, c), dev, dtype, seed=1))
    pad = (k - 1) // 2
    sec, _ = timed_loop(lambda x: torch.sign(F.conv2d(x, w, padding=pad)),
                        x, dev, inner)
    return sec, 2 * batch * h * h * c * c * k * k / sec / 1e12


@probe
def conv_chain_bf16(device: DeviceLike = 'cuda') -> None:
    dev = resolve_device(device)
    for batch in (256, 1024):
        for name, h, c in LAYERS:
            sec, tf = _conv_chain(dev, batch, h, c)
            record('conv_chain_bf16', dev, layer=name, batch=batch,
                   ms=sec * 1e3, tflops=tf)


def _im2col_chain(dev: torch.device, batch: int, h: int, c: int,
                  dtype: torch.dtype, inner: int) -> tuple[float, float]:
    """x <- sign(im2col(x) @ w) as ONE (B*H*W, 9C) @ (9C, C) matmul:
    torch.matmul in bf16, torch._int_mm in int8 with the weights stored
    column-major (PyTorch has no int8 conv on CUDA)."""
    x = pm1((batch, h, h, c), dev, dtype)
    w = pm1((9 * c, c), dev, dtype, seed=1)
    mm = torch.matmul
    if dtype == torch.int8:
        w, mm = col_major(w), torch._int_mm

    def step(x: torch.Tensor) -> torch.Tensor:
        y = mm(im2col3x3(x), w)
        return torch.where(y >= 0, 1, -1).to(dtype).reshape(x.shape)

    sec, _ = timed_loop(step, x, dev, inner)
    return sec, 2 * batch * h * h * c * c * 9 / sec / 1e12


@probe
def conv_chain_int8(device: DeviceLike = 'cuda') -> None:
    """Chained 3x3 s1 int8 conv (s8 x s8 -> s32), in the im2col form."""
    dev = resolve_device(device)
    for batch in (256, 1024):
        for name, h, c in LAYERS:
            sec, tf = _im2col_chain(dev, batch, h, c, torch.int8, 10)
            record('conv_chain_int8', dev, layer=name, batch=batch,
                   ms=sec * 1e3, tops=tf)


@probe
def conv_chain_wide_channels(device: DeviceLike = 'cuda') -> None:
    """Is the conv rate limited by C? C = 1024 / 2048 at small H."""
    dev = resolve_device(device)
    for name, h, c in (('c1024', 7, 1024), ('c2048', 4, 2048)):
        sec, tf = _conv_chain(dev, 256, h, c)
        record('conv_chain_wide_channels', dev, layer=name, ms=sec * 1e3,
               tflops=tf)


@probe
def conv_im2col_chain_bf16(device: DeviceLike = 'cuda') -> None:
    dev = resolve_device(device)
    for name, h, c in (('l1', 56, 64), ('l3b', 14, 256), ('l4b', 7, 512)):
        sec, tf = _im2col_chain(dev, 256, h, c, torch.bfloat16, 8)
        record('conv_im2col_chain_bf16', dev, layer=name, ms=sec * 1e3,
               tflops=tf)


@probe
def elementwise_chain_v2(device: DeviceLike = 'cuda') -> None:
    """BN + PReLU + sign, output chained into the next input. GB/s counts
    one read and one write of the tensor per rep."""
    dev = resolve_device(device)
    x = randn((256, 56, 56, 64), dev, torch.bfloat16)
    g = torch.full((64,), 1.01, dtype=torch.bfloat16, device=dev)
    b = torch.full((64,), 0.01, dtype=torch.bfloat16, device=dev)

    def step(x: torch.Tensor) -> torch.Tensor:
        y = x * g + b
        y = torch.where(y >= 0, y, 0.25 * y)
        return torch.sign(y) * 1.5

    sec, _ = timed_loop(step, x, dev, 20)
    gb = 2 * x.numel() * 2 / 1e9
    record('elementwise_chain_v2', dev, ms=sec * 1e3, gbps=gb / sec)


@probe
def stem_vs_s2d_v2(device: DeviceLike = 'cuda', batch: int = 256,
                   inner: int = 10) -> None:
    """The port's regular stem conv (ops.conv.conv2d, 7x7/s2/p3) against
    its exact space-to-depth form (ops.conv.stem_conv_s2d), bf16, with
    the JAX probe's sum carry."""
    dev = resolve_device(device)
    x = randn((batch, 224, 224, 3), dev, torch.bfloat16)
    w = randn((7, 7, 3, 64), dev, torch.bfloat16) * 0.05

    def run(fn: Callable[[torch.Tensor], torch.Tensor]) -> float:
        def step(x: torch.Tensor) -> torch.Tensor:
            return x * (1.0 + EPS * fn(x).sum().to(x.dtype))
        sec, _ = timed_loop(step, x, dev, inner)
        return sec * 1e3

    with tf32(False):
        record('stem_vs_s2d_v2', dev, kind='regular', batch=batch,
               ms=run(lambda t: conv2d(t, w, stride=2, padding=3)))
        record('stem_vs_s2d_v2', dev, kind='s2d', batch=batch,
               ms=run(lambda t: stem_conv_s2d(t, w)))


@probe
def batch_sweep_model(device: DeviceLike = 'cuda',
                      batches: Sequence[int] = (64, 128, 256, 512, 1024),
                      iters: int = 12, seed: int = 0) -> None:
    """The port's served ResNet-18 (seeded, packed, threshold-folded,
    stripped; bf16 chain) in images per second against batch, with the
    s2d stem on (as the JAX probe) and off. The JAX probe swept 512,
    1024 and 2048 on the TPU; here the sweep starts at serving batches."""
    dev = resolve_device(device)
    model = seeded_serving_resnet18(dev, seed, stem_s2d=True)
    model.eval_dtype = torch.bfloat16
    for s2d in (True, False):
        model.conv1.s2d = s2d  # same parameters either way
        for batch in batches:
            x = randn((batch, 224, 224, 3), dev)

            def step(t: torch.Tensor) -> torch.Tensor:
                return t + 1e-12 * model(t).mean().to(t.dtype)

            with torch.inference_mode():
                sec, _ = timed_loop(step, x, dev, iters, outer=1)
            record('batch_sweep_model', dev, batch=batch, stem_s2d=s2d,
                   ips=batch / sec, ms=sec * 1e3)


def _pallas_mm(dev: torch.device, dtype: torch.dtype, n: int = 4096,
               inner: int = 8) -> float:
    """The port's tiled tensor-core matmul, output chained into the next
    input. int8: A is ±1 and B = A^T as in the JAX probe; bf16: normal
    values / n. The JAX kernel's tiles were (256, 256) over 512-deep K
    steps; the port's are (128, 128) over 32 (bf16) or 64 (int8)."""
    if dtype == torch.int8:
        a = pm1((n, n), dev, dtype)
        b = a.t().contiguous()
    else:
        a = randn((n, n), dev, dtype) / n
        b = randn((n, n), dev, dtype, seed=1) / n
    sec, _ = timed_loop(lambda a: K.tiled_matmul(a, b), a, dev, inner)
    return 2 * n ** 3 / sec / 1e12


@probe
def pallas_matmul_bf16_v2(device: DeviceLike = 'cuda', n: int = 4096,
                          inner: int = 8) -> None:
    dev = resolve_device(device)
    t = _pallas_mm(dev, torch.bfloat16, n, inner)
    record('pallas_matmul_bf16_v2', dev, tflops=t,
           ms=2 * n ** 3 / t / 1e9, n=n)


@probe
def pallas_matmul_int8(device: DeviceLike = 'cuda', n: int = 4096,
                       inner: int = 8) -> None:
    dev = resolve_device(device)
    t = _pallas_mm(dev, torch.int8, n, inner)
    record('pallas_matmul_int8', dev, tops=t, ms=2 * n ** 3 / t / 1e9, n=n)


if __name__ == '__main__':
    sys.exit(main(PROBES, __doc__))
