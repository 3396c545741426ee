#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quant_tpu_torch) on one GPU.

Drives the port's serving path end to end on the card:

1. prints the card's name and power limit (nvidia-smi) and builds the
   four CUDA kernels from quant_tpu_torch/csrc with nvcc (sm_90a);
2. holds each kernel against its plain PyTorch twin on the card, at the
   serving path's shapes (TF32 off everywhere);
3. builds the packed XNOR ResNet-18 (224 px, 1000 classes, the bench
   configuration of the JAX package) from seeded weights, prepares it
   with the port's own export, fold and strip, runs the bf16 chain at
   batch 128 and checks the launch counts (16 xnor_conv2d, 16 producer,
   1 pool per forward), then holds the fp32 chain on the card against
   the same model on the CPU;
4. serves 16 requests through InferenceEngine on the card;
5. times each kernel, its plain twin and a library yardstick at the
   path's shapes with CUDA events, and the forward's images per second.

Prints the card line, a JSON line {"kernels": [...]} and, last,
{"ok": true, "device": {...}}. Any failed phase raises and exits
non-zero; without CUDA it exits 2 before printing any result.

Usage: python3 chip_smoke.py [--batch 128] [--iters 10] [--seed 0]
                             [--report PATH]
"""

import argparse
import copy
import json
import subprocess
import sys
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at 700 W
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak (2 ops/MAC)
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
DEVICE = 'cuda'

# fp32 chain, card vs CPU: the binary convs, producers and pool are exact
# on both; the stem conv, BN, 1x1 shortcuts and head round differently
# (cuDNN vs CPU kernels, rsqrt), and an activation sitting within that
# rounding of its threshold flips its sign, moving the dots it feeds by
# 2. Held to 2% of the logits' spread.
FP32_REL_TOL = 2e-2


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn: Callable[[], Any], iters: int) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def valid_taps(size: int, out: int, stride: int, pad: int, k: int) -> int:
    """Sum over output positions of the kernel taps inside the input."""
    return sum(sum(0 <= o * stride - pad + i < size for i in range(k))
               for o in range(out))


def resnet18(device: str, seed: int) -> torch.nn.Module:
    """Packed, folded, stripped XNOR ResNet-18 from seeded weights."""
    from quant_tpu_torch.nn import export
    from quant_tpu_torch.nn.layers import BatchNorm, QuantConv2d
    from quant_tpu_torch.nn.resnet import QResNet
    from quant_tpu_torch.ops.quantize import quantizer_ls_1

    gen = torch.Generator().manual_seed(seed)
    layer = {'x_quant': 'ls-1', 'w_quant': 'ls-1',
             'clamp': {'kind': 'symmetric', 'alpha': 2.0},
             'double_shortcut': True}
    model = QResNet(
        block='xnor',
        layer0={'n_in_channels': 64, 'kernel_size': 7, 'stride': 2,
                'padding': 3, 'bias': False,
                'maxpool': {'type': 'maxpool2d', 'kernel_size': 3,
                            'stride': 2, 'padding': 1}},
        layer1=dict(layer), layer2=dict(layer), layer3=dict(layer),
        layer4=dict(layer), nonlins=['prelu', 'prelu'],
        num_blocks=[2, 2, 2, 2], output_classes=1000,
        moving_average_mode='eval_only', device='cpu', generator=gen)

    def uniform(like: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        return torch.empty_like(like).uniform_(lo, hi, generator=gen)

    for m in model.modules():
        if isinstance(m, BatchNorm):
            sign = torch.where(uniform(m.weight, 0, 1) < 0.3, -1.0, 1.0)
            m.weight.copy_(uniform(m.weight, 0.3, 1.5) * sign)
            m.bias.copy_(uniform(m.bias, -0.8, 0.8))
            m.running_mean.copy_(uniform(m.running_mean, -0.5, 0.5))
            m.running_var.copy_(uniform(m.running_var, 0.2, 2.0))
        elif isinstance(m, QuantConv2d):
            # Cached weight scales as training leaves them (per-out-channel
            # mean |w|), and EMA activation scales as the JAX bench fills
            # them (0.5, one tracked batch).
            m.w_vs = quantizer_ls_1(torch.movedim(m.kernel, -1, 0))[0]
            m.x_quantizer.ema.fill_(0.5)
            m.x_quantizer.ema_count.fill_(1)
    export.export_packed_variables(model)
    model, folded = export.fold_for_serving(model)
    if not folded:
        raise RuntimeError('threshold fold did not apply')
    export.strip_for_deployment(model)
    return model.to(device)


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f'{name}: {got.shape}/{got.dtype} vs '
                             f'{want.shape}/{want.dtype}')
    err = (got.double() - want.double()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f'{name}: kernel differs from its plain twin '
                             f'(max abs err {err})')
    return err


def kernel_phases(batch: int, gen: torch.Generator) -> dict[str, float]:
    """Each kernel against its plain twin at the serving path's shapes;
    returns {kernel: max abs error}."""
    from quant_tpu_torch.ops import binary_gemm as G
    from quant_tpu_torch.ops import binary_infer as B
    from quant_tpu_torch.ops.conv import max_pool2d
    from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1

    dev = DEVICE

    def words(*shape: int) -> torch.Tensor:
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def rand(*shape: int, dtype: torch.dtype = torch.float32
             ) -> torch.Tensor:
        return torch.randn(shape, generator=gen).to(dev, dtype)

    errs = {}
    conv_err = 0.0
    for hw, cin, cout, stride in ((56, 64, 64, 1), (56, 64, 128, 2),
                                  (7, 512, 512, 1)):
        x = words(batch, hw, hw, cin // 32)
        w = words(3, 3, cin // 32, cout)
        n = torch.ones(batch, device=dev)
        o = torch.ones(cout, device=dev)
        kw = dict(in_channels=cin, stride=stride, padding=1)
        conv_err = max(conv_err, check_equal(
            f'xnor_conv2d int dot {hw}x{cin}->{cout}/s{stride}',
            B.xnor_conv2d(x, w, n, o, None, **kw),
            B.xnor_conv2d_plain(x, w, n, o, None, **kw)))
        vx = rand(batch).abs() + 0.1
        vw = rand(cout).abs() * 0.05 + 0.01
        bias = rand(cout)
        for dt in (torch.bfloat16, torch.float32):
            conv_err = max(conv_err, check_equal(
                f'xnor_conv2d epilogue {dt} {hw}x{cin}->{cout}/s{stride}',
                B.xnor_conv2d(x, w, vx, vw, bias, out_dtype=dt, **kw),
                B.xnor_conv2d_plain(x, w, vx, vw, bias, out_dtype=dt,
                                    **kw)))
    errs['xnor_conv2d'] = conv_err

    m, k, n_out = batch * 49, 4608, 512
    a, bt = words(m, k // 32), words(k // 32, n_out)
    gemm_err = check_equal(
        'xnor_gemm unit scales',
        G.xnor_gemm(a, bt, torch.ones(m, device=dev),
                    torch.ones(n_out, device=dev), k),
        G.xnor_gemm_plain(a, bt, torch.ones(m, device=dev),
                          torch.ones(n_out, device=dev), k))
    vx, vw = rand(m).abs() + 0.1, rand(n_out).abs() + 0.1
    got = G.xnor_gemm(a, bt, vx, vw, k)
    want = G.xnor_gemm_plain(a, bt, vx, vw, k)
    # Same float32 ops in the same order: expected equal; allclose at
    # float32 epsilon in case a library matmul rounds the dot's
    # conversion differently.
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-3)
    errs['xnor_gemm'] = max(gemm_err, (got - want).abs().max().item())

    pack_err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for hw, c in ((56, 64), (28, 128), (7, 512)):
            x = rand(batch, hw, hw, c, dtype=dt)
            t = rand(c) * 0.5
            flip = torch.where(rand(c) < -0.5, -1.0, 1.0)
            x[:, 0, 0] = t.to(dt)  # values on the rounded threshold
            pack_err = max(pack_err, check_equal(
                f'pack_threshold_signs {dt} {hw}x{c}',
                B.pack_threshold_signs(x, t, flip),
                B.pack_threshold_signs_plain(x, t, flip)))
    errs['pack_threshold_signs'] = pack_err

    pool_err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        x = rand(batch, 112, 112, 64, dtype=dt)
        pool_err = max(pool_err, check_equal(
            f'max_pool_3x3_s2_p1 {dt}', max_pool_3x3_s2_p1(x),
            max_pool2d(x, kernel_size=3, stride=2, padding=1)))
    errs['max_pool_3x3_s2_p1'] = pool_err
    torch.cuda.synchronize()
    return errs


def capture_conv_inputs(model: torch.nn.Module) -> tuple[list, list]:
    """Forward pre-hooks that record each QuantConv2d's input."""
    from quant_tpu_torch.nn.layers import QuantConv2d
    seen: list = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for m in model.modules() if isinstance(m, QuantConv2d)]
    return seen, hooks


def time_kernels(model: torch.nn.Module, x: torch.Tensor,
                 conv_inputs: list, iters: int) -> list[dict]:
    """Per kernel, summed over the launches of one forward at the path's
    shapes: kernel, plain twin and library ms, and the bound."""
    from quant_tpu_torch.ops import binary_gemm as G
    from quant_tpu_torch.ops import binary_infer as B
    from quant_tpu_torch.ops.conv import max_pool2d
    from quant_tpu_torch.ops.packing import packed_width, unpack_signs
    from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1

    dt = model.eval_dtype
    rows = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                       bytes=0.0, ops=0.0)
            for name in ('xnor_conv2d', 'pack_threshold_signs')}
    shapes = []
    for conv, xin in conv_inputs:
        n, h, w, c = xin.shape
        wc = packed_width(c)
        thresh, flip = conv.x_thresh, conv.x_flip
        vx = conv.x_quantizer(xin)[0]
        wp = conv.w_packed[0].contiguous()
        vw = conv.w_scales[0]
        s = conv.stride
        words = B.pack_threshold_signs(xin, thresh, flip)
        r = rows['pack_threshold_signs']
        r['ms'] += time_ms(lambda: B.pack_threshold_signs(xin, thresh, flip),
                           iters)
        r['plain_ms'] += time_ms(
            lambda: B.pack_threshold_signs_plain(xin, thresh, flip), iters)
        nb = xin.numel() * xin.element_size() + 8 * c + words.numel() * 4
        r['bytes'] += nb
        r['bound_ms'] += bound_ms(nb, 2 * xin.numel(), FP32_OPS_PER_S)[0]

        kw = dict(in_channels=c, stride=s, padding=1, out_dtype=dt)
        out = B.xnor_conv2d(words, wp, vx, vw, conv.bias, **kw)
        oh, ow, o = out.shape[1:]
        r = rows['xnor_conv2d']
        r['ms'] += time_ms(
            lambda: B.xnor_conv2d(words, wp, vx, vw, conv.bias, **kw), iters)
        r['plain_ms'] += time_ms(
            lambda: B.xnor_conv2d_plain(words, wp, vx, vw, conv.bias, **kw),
            iters)
        xs = unpack_signs(words, c, dtype=dt).permute(0, 3, 1, 2)
        ws = B.unpack_weights_int8(wp, c, dtype=dt).permute(3, 2, 0, 1)
        xs = xs.contiguous(memory_format=torch.channels_last)
        ws = ws.contiguous(memory_format=torch.channels_last)
        r['library_ms'] += time_ms(
            lambda: F.conv2d(xs, ws, stride=s, padding=1), iters)
        macs = n * o * c * valid_taps(h, oh, s, 1, 3) * valid_taps(
            w, ow, s, 1, 3)
        nb = (words.numel() + wp.numel()) * 4 + 4 * (n + 2 * o) \
            + out.numel() * out.element_size()
        r['bytes'] += nb
        r['ops'] += 2 * macs
        r['bound_ms'] += bound_ms(nb, 2 * macs, INT8_OPS_PER_S)[0]
        shapes.append([n, h, w, c, o, s])
    for r in rows.values():
        r['bound_by'] = ('bytes' if r['bytes'] / HBM_BYTES_PER_S
                         >= r['ops'] / INT8_OPS_PER_S else 'operations')
    rows['pack_threshold_signs']['library_ms'] = None

    with torch.inference_mode():
        stem = torch.relu(model.bn1(model.conv1(x.to(dt), dt), dt))
    stem_nchw = stem.permute(0, 3, 1, 2)
    pooled = max_pool_3x3_s2_p1(stem)
    nb = (stem.numel() + pooled.numel()) * stem.element_size()
    b, by = bound_ms(nb, 8 * pooled.numel(), FP32_OPS_PER_S)
    rows['max_pool_3x3_s2_p1'] = dict(
        ms=time_ms(lambda: max_pool_3x3_s2_p1(stem), iters),
        plain_ms=time_ms(lambda: max_pool2d(stem, kernel_size=3, stride=2,
                                            padding=1), iters),
        library_ms=time_ms(lambda: F.max_pool2d(stem_nchw, 3, 2, 1), iters),
        bound_ms=b, bound_by=by, bytes=nb, ops=8 * pooled.numel())

    gen = torch.Generator().manual_seed(1)
    m, k, n_out = x.shape[0] * 49, 4608, 512
    a = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, k // 32), generator=gen,
                      dtype=torch.int32).to(DEVICE)
    bt = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // 32, n_out),
                       generator=gen, dtype=torch.int32).to(DEVICE)
    vx, vw = torch.rand(m).to(DEVICE), torch.rand(n_out).to(DEVICE)
    a16 = unpack_signs(a, k, dtype=torch.bfloat16)
    b16 = unpack_signs(bt.t(), k, dtype=torch.bfloat16).t()
    nb = (a.numel() + bt.numel() + m + n_out + m * n_out) * 4
    b, by = bound_ms(nb, 2 * m * n_out * k, INT8_OPS_PER_S)
    rows['xnor_gemm'] = dict(
        ms=time_ms(lambda: G.xnor_gemm(a, bt, vx, vw, k), iters),
        plain_ms=time_ms(lambda: G.xnor_gemm_plain(a, bt, vx, vw, k), iters),
        library_ms=time_ms(lambda: torch.matmul(a16, b16), iters),
        bound_ms=b, bound_by=by, bytes=nb, ops=2 * m * n_out * k,
        shape=[m, k, n_out])
    rows['xnor_conv2d']['shapes'] = shapes
    return [dict(name=name, **row) for name, row in rows.items()]


def serve(model: torch.nn.Module, seed: int) -> dict:
    """16 requests through InferenceEngine on the card, against predict."""
    from quant_tpu_torch.serving.engine import InferenceEngine

    images = np.random.default_rng(seed).standard_normal(
        (16, 224, 224, 3)).astype(np.float32)
    engine = InferenceEngine(model, (224, 224, 3), max_batch=16,
                             max_wait_ms=5.0, device=DEVICE)
    engine.warmup([16])
    # All 16 are queued before the scheduler starts, so it serves them as
    # one batch of 16: the batch predict() runs, hence the same kernels.
    futures = [engine.submit(img) for img in images]
    engine.start()
    try:
        got = np.stack([f.result(timeout=120) for f in futures])
    finally:
        engine.stop()
    want = engine.predict(images)
    if not np.isfinite(got).all() or got.shape != (16, 1000):
        raise AssertionError(f'served logits bad: {got.shape}')
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    stats = engine.stats
    if stats['requests'] != 16 or stats['batches'] != 1:
        raise AssertionError(f'unexpected engine stats {stats}')
    return dict(requests=16, batches=stats['batches'],
                latency_ms=stats['latency_ms'],
                max_abs_err=float(np.abs(got - want).max()))


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=128)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--report', default=None,
                    help='also write the full results as JSON here')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2

    from quant_tpu_torch import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    print(f'build: {build_s:.3f} s ({", ".join(logs) or "cached"})')
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')

    gen = torch.Generator().manual_seed(args.seed)
    errs = kernel_phases(args.batch, gen)
    print(f'kernels vs plain twins: {errs}', flush=True)

    cpu_model = resnet18('cpu', args.seed)
    model = copy.deepcopy(cpu_model).to(DEVICE)
    model.eval_dtype = torch.bfloat16
    x = torch.randn(args.batch, 224, 224, 3, generator=gen).to(DEVICE)
    seen, hooks = capture_conv_inputs(model)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with torch.inference_mode():
        logits = model(x)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    for h in hooks:
        h.remove()
    want = {'xnor_conv2d': 16, 'pack_threshold_signs': 16,
            'max_pool_3x3_s2_p1': 1, 'xnor_gemm': 0}
    if launches != want:
        raise AssertionError(f'launches {launches}, expected {want}')
    if logits.shape != (args.batch, 1000) or not logits.isfinite().all():
        raise AssertionError('bad bf16 logits')
    print(f'main path launches: {launches}', flush=True)

    model.eval_dtype = None
    with torch.inference_mode():
        got32 = model(x[:4]).cpu()
        want32 = cpu_model(x[:4].cpu())
    spread = (want32.max() - want32.min()).item()
    fp32_err = (got32 - want32).abs().max().item()
    print(f'fp32 chain card vs CPU: max abs err {fp32_err} '
          f'(logit spread {spread})', flush=True)
    if not fp32_err <= FP32_REL_TOL * spread:
        raise AssertionError('fp32 chain disagrees with the CPU model')
    model.eval_dtype = torch.bfloat16

    served = serve(model, args.seed)
    print(f'serving: {served}', flush=True)

    ms_fwd = time_ms(lambda: model(x), args.iters)
    img_s = args.batch / ms_fwd * 1e3
    with torch.inference_mode():
        stem_ms = time_ms(lambda: torch.relu(model.bn1(
            model.conv1(x.to(torch.bfloat16), torch.bfloat16),
            torch.bfloat16)), args.iters)
    rows = time_kernels(model, x, seen, args.iters)
    print(f'main path bf16 batch {args.batch}: {ms_fwd} ms/forward, '
          f'{img_s} img/s; stem conv+BN+ReLU {stem_ms} ms', flush=True)

    sources = {'xnor_conv2d': 'quant_tpu_torch/csrc/xnor.cu',
               'pack_threshold_signs': 'quant_tpu_torch/csrc/xnor.cu',
               'xnor_gemm': 'quant_tpu_torch/csrc/xnor.cu',
               'max_pool_3x3_s2_p1': 'quant_tpu_torch/csrc/pool.cu'}
    replaces = {'xnor_conv2d': 'quant_tpu/ops/binary_gemm.py:41',
                'xnor_gemm': 'quant_tpu/ops/binary_gemm.py:41',
                'pack_threshold_signs': 'quant_tpu/ops/binary_infer.py:179',
                'max_pool_3x3_s2_p1': 'quant_tpu/ops/pool.py:87'}
    kernels = [dict(name=r['name'], route='cuda', source=sources[r['name']],
                    replaces=replaces[r['name']],
                    launches=launches[r['name']],
                    on_main_path=want[r['name']] > 0,
                    max_abs_err=errs[r['name']], ms=r['ms'],
                    plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                    bound_by=r['bound_by'], library_ms=r['library_ms'])
               for r in rows]
    if args.report:
        with open(args.report, 'w') as f:
            json.dump(dict(card=card_line(), build_s=build_s,
                           batch=args.batch, ms_per_forward=ms_fwd,
                           images_per_s=img_s, stem_ms=stem_ms,
                           fp32_max_abs_err=fp32_err, fp32_spread=spread,
                           serving=served, kernels=rows,
                           torch=torch.__version__,
                           cuda=torch.version.cuda), f, indent=1)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
