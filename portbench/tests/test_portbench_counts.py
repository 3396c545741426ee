"""counts.py against the shapes the program's model really runs: each
configuration's QResNet walked at 224 px on the CPU with forward hooks
(the dense fp32 form, whose convs run the served model's shapes), and
its exported packed weights."""

import math

import pytest
import torch
import torch.nn.functional as F

from conftest import BOTTLENECK, bench_config
from portbench import counts, run as bench_run, state
from quant_tpu_torch.nn import export
from quant_tpu_torch.nn.layers import Conv, Dense, QuantConv2d
from quant_tpu_torch.nn.resnet import QResNet

CONFIGS = ('r18_xnor_ls1', 'r18_xnor_ls2_ls1', BOTTLENECK)
CPU = torch.device('cpu')


def _model(cfg: dict, **kw) -> QResNet:
    from portbench import port
    return QResNet(**port._student(cfg), moving_average_mode='eval_only',
                   device=CPU, **kw)


def _run_shapes(cfg: dict) -> dict:
    """{module name: (input NHWC shape, output shape, module)} of one
    forward at the configuration's size."""
    model = _model(cfg, inference_mode='dense')
    model.load_state_dict(state.serve_state(
        cfg, state.generator(1, CPU), CPU))
    seen = {}
    for name, m in model.named_modules():
        if isinstance(m, (Conv, QuantConv2d, Dense)):
            m.register_forward_hook(
                lambda mod, i, o, name=name: seen.__setitem__(
                    name, (tuple(i[0].shape), tuple(o.shape), mod)))
    size = cfg['image_size']
    with torch.no_grad():
        model(torch.randn(1, size, size, cfg['in_channels']))
    return seen


def _taps(h: int, w: int, k: int, stride: int, pad: int) -> int:
    """Kernel taps inside the image, summed over output positions, by
    unfolding a map of ones."""
    ones = torch.ones(1, 1, h, w)
    return int(F.unfold(ones, k, padding=pad, stride=stride).sum())


@pytest.mark.parametrize('name', CONFIGS)
def test_layers_match_the_model(name):
    cfg = bench_config(name)
    seen = _run_shapes(cfg)
    layers = counts.layers(cfg)
    assert {l.name for l in layers} == set(seen)
    for layer in layers:
        shape_in, shape_out, mod = seen[layer.name]
        if layer.kind == 'fc':
            assert shape_in == (1, layer.c_in)
            assert shape_out == (1, layer.c_out)
            assert layer.macs == math.prod(mod.kernel.shape)
            continue
        _, h, w, c = shape_in
        assert (h, w, c) == (layer.h, layer.w, layer.c_in), layer.name
        assert shape_out[1:] == (layer.h_out, layer.w_out, layer.c_out)
        kh, kw, ci, co = mod.kernel.shape
        assert (kh, ci, co) == (layer.k, layer.c_in, layer.c_out)
        taps = _taps(h, w, kh, layer.stride, layer.pad)
        assert layer.macs == ci * co * taps, layer.name
        assert (layer.kind == 'binary') == isinstance(mod, QuantConv2d)


@pytest.mark.parametrize('name', CONFIGS)
def test_binary_conv_bytes_match_the_served_tensors(name):
    cfg = bench_config(name)
    seen = _run_shapes(cfg)
    model = _model(cfg)
    model.load_state_dict(state.serve_state(
        cfg, state.generator(1, CPU), CPU))
    export.export_packed_variables(model)
    convs = dict(model.named_modules())
    batch, e = 128, counts.DTYPE_BYTES[cfg['serve']['eval_dtype']]
    for layer in counts.walk_binary(cfg):
        conv = convs[layer.name]
        shape_in, shape_out, _ = seen[layer.name]
        want = (batch * math.prod(shape_in[1:]) * e
                + conv.w_packed.numel() * conv.w_packed.element_size()
                + conv.w_scales.numel() * 4 + conv.bias.numel() * 4
                + batch * math.prod(shape_out[1:]) * e)
        assert counts.binary_conv_bytes(layer, batch, cfg['w_quant'],
                                        cfg['serve']['eval_dtype']) == want


def test_work_of_resnet18():
    """1.68 G MACs an image over the taps inside it (1.82 G counting the
    padding), 1.54 G of them in the 16 binary convs; the ls-2 x ls-1
    forward does twice the binary work at the int8 peak."""
    bench = bench_run.spec()
    ls1 = bench_run.config(bench, 'r18_xnor_ls1')
    ls2 = bench_run.config(bench, 'r18_xnor_ls2_ls1')
    macs = sum(l.macs for l in counts.layers(ls1))
    binary = sum(l.macs for l in counts.walk_binary(ls1))
    assert macs == 1_680_390_912 and binary == 1_544_396_800
    dense_s = sum(2 * l.macs for l in counts.layers(ls1)
                  if l.kind != 'binary') / counts.PEAK_OPS_PER_S['bfloat16']
    int8_s = 2 * binary / counts.PEAK_OPS_PER_S['int8']
    assert counts.serve_peak_s(ls1) == pytest.approx(dense_s + int8_s)
    assert counts.serve_peak_s(ls2) == pytest.approx(dense_s + 2 * int8_s)
    assert counts.train_peak_s(ls1) == pytest.approx(
        8 * macs / counts.PEAK_OPS_PER_S['float32'])


def test_work_of_resnet50():
    """The bottleneck ResNet-50 at 224 px: 54 layers (the stem, 48 binary
    convs, 32 of them 1x1, 4 fp 1x1 shortcuts, the fc), 3.948 G MACs an
    image over the taps inside it, 3.470 G binary; at batch 256 of ls-2 x
    ls-1 on the bf16 chain its binary convs' least time is 3.16 ms, 2.25
    ms of it in the 1x1 convs, 26 of which their bytes bound (all but
    layer4's six). The teacher's work follows the teacher's own
    block."""
    cfg = bench_config(BOTTLENECK)
    layers = counts.layers(cfg)
    binary = list(counts.walk_binary(cfg))
    assert len(layers) == 54 and len(binary) == 48
    assert sum(l.k == 1 for l in binary) == 32
    assert [l.kind for l in layers].count('shortcut') == 4
    assert layers[-1].c_in == 2048
    macs = sum(l.macs for l in layers)
    assert macs == 3_948_251_904
    assert sum(l.macs for l in binary) == 3_470_327_808

    def least_s(layer):
        ops = 256 * counts.binary_conv_ops(layer, 'ls-2', 'ls-1')
        nbytes = counts.binary_conv_bytes(layer, 256, 'ls-1', 'bfloat16')
        return (max(ops / counts.PEAK_OPS_PER_S['int8'],
                    nbytes / counts.HBM_BYTES_PER_S),
                ops / counts.PEAK_OPS_PER_S['int8'])
    one = [least_s(l) for l in binary if l.k == 1]
    assert sum(bound > ops_s for bound, ops_s in one) == 26
    assert sum(b for b, _ in one) == pytest.approx(2.2491e-3, rel=1e-4)
    assert counts.binary_conv_bound_s(cfg, 256) == pytest.approx(
        3.1614e-3, rel=1e-4)
    peak = counts.PEAK_OPS_PER_S['bfloat16']
    assert counts.train_peak_s(cfg) == pytest.approx(8 * macs / peak)
    basic = {**cfg['train']['teacher'], 'block': 'regular'}
    teacher = sum(l.macs for l in counts.layers({**cfg, **basic}))
    assert counts.train_peak_s({**cfg, 'train': {
        **cfg['train'], 'teacher': basic}}) == pytest.approx(
        6 * macs / peak + 2 * teacher / peak)
    assert teacher != macs


def test_kernel_classes():
    assert counts.kernel_class(
        'void (anonymous namespace)::xnor_conv2d_kernel<__nv_bfloat16>'
    ) == 'binary_conv'
    assert counts.kernel_class('pack_sign_planes_wide_kernel') == \
        'binary_conv'
    assert counts.kernel_class('max_pool_3x3_s2_p1_kernel') == 'pool'
    assert counts.kernel_class(
        'cutlass_tensorop_bf16_s16816fprop_optimized_bf16') == 'conv'
    assert counts.kernel_class(
        'void at::native::vectorized_elementwise_kernel<4>') == 'elementwise'
    assert counts.kernel_class('Memcpy DtoD') == 'copy'
