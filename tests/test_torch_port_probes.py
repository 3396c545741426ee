"""The port's chip-probe path on the CPU: the probe kernels' plain twins
against the functions the Pallas kernel bodies compute in JAX, the s2d
stem against JAX's, the probe registries against the JAX scripts, and
the kernel probes themselves at a small size.

The Pallas kernels of tools/probe_r2.py and tools/probe_r3.py are
closures inside the probe functions and cannot be imported; their bodies
compute `x + y` and `jnp.dot(a, b, preferred_element_type=acc)
.astype(dtype)`, which is what the twins are held against. Inputs are
made with numpy from a seed.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.nn import QResNet as JQResNet
from quant_tpu.nn import export as jexport
from quant_tpu.ops.conv import stem_conv_s2d as j_stem_s2d
from quant_tpu_torch import _build
from quant_tpu_torch.nn import layers as tlayers
from quant_tpu_torch.nn.resnet import QResNet
from quant_tpu_torch.ops.conv import conv2d, stem_conv_s2d
from quant_tpu_torch.probes import (common, models, probe_r2, probe_r3,
                                    xnor_variants)
from quant_tpu_torch.probes import kernels as K
from quant_tpu_torch.utils.jax_import import from_jax_variables

REPO = Path(__file__).resolve().parent.parent
# As tests/ops/test_stem_s2d.py: the same multiply-adds in another
# association order, so only accumulation-order rounding.
STEM_TOL = dict(rtol=1e-5, atol=1e-4)
# As tests/test_torch_port_model.py's fp32 chain.
FP32_TOL = dict(rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ twins

@pytest.mark.parametrize('m,k,n', [(128, 64, 128), (256, 192, 128),
                                   (128, 1024, 384)])
def test_tiled_matmul_int8_twin_wraps_as_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, (m, k), dtype=np.int8)
    b = rng.integers(-128, 128, (k, n), dtype=np.int8)
    want = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                              preferred_element_type=jnp.int32)
                      .astype(jnp.int8))
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert np.abs(exact).max() > 127   # the wrap is exercised
    got = K.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int8 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        K.tiled_matmul_plain(torch.from_numpy(a), torch.from_numpy(b))
        .numpy(), want)


@pytest.mark.parametrize('m,k,n', [(128, 32, 128), (256, 96, 128),
                                   (128, 1024, 384)])
def test_tiled_matmul_bf16_twin_within_one_ulp_of_jax(m, k, n):
    # Positive values: no cancellation, so float32 sums taken in another
    # order (XLA's dot vs torch's matmul) stay within 2*K*2^-24 relative
    # of each other, under one bf16 ulp (2^-8); rounding both to bf16 can
    # then differ by at most one ulp.
    rng = np.random.default_rng(k)
    a32 = rng.uniform(0, 1, (m, k)).astype(np.float32)
    b32 = rng.uniform(0, 1, (k, n)).astype(np.float32)
    a, b = (torch.from_numpy(t).to(torch.bfloat16) for t in (a32, b32))
    ja, jb = (jnp.asarray(t).astype(jnp.bfloat16) for t in (a32, b32))
    want = jnp.dot(ja, jb, preferred_element_type=jnp.float32).astype(
        jnp.bfloat16)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        torch.bfloat16)
    got = K.tiled_matmul(a, b)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert K.bf16_ulps(got, want) <= 1


def test_tiled_matmul_bf16_twin_exact_on_integer_values():
    # Integer values with |sum| < 2^24 sum exactly in float32 in any
    # order, so the bf16 results are equal.
    rng = np.random.default_rng(5)
    a = rng.integers(-8, 9, (128, 256)).astype(np.float32)
    b = rng.integers(-8, 9, (256, 128)).astype(np.float32)
    want = jnp.dot(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                   preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    got = K.tiled_matmul(torch.from_numpy(a).to(torch.bfloat16),
                         torch.from_numpy(b).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_bf16_ulps_counts_across_zero():
    v = torch.tensor([1.0, -1.0, 0.0, 2.0 ** -133], dtype=torch.bfloat16)
    up = torch.tensor([1.0078125, -0.99609375, -0.0, -(2.0 ** -133)],
                      dtype=torch.bfloat16)
    assert K.bf16_ulps(v, v) == 0
    assert K.bf16_ulps(v[:1], up[:1]) == 1     # next bf16 above 1
    assert K.bf16_ulps(v[1:2], up[1:2]) == 1   # next toward 0 from -1
    assert K.bf16_ulps(v[2:3], up[2:3]) == 0   # +0 and -0
    assert K.bf16_ulps(v[3:], up[3:]) == 2     # smallest subnormals


@pytest.mark.parametrize('shape', [(1024, 256), (7, 3, 5)])
def test_add_twin_equals_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jnp.asarray(x) + jnp.asarray(y))
    got = K.add(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        K.add_plain(torch.from_numpy(x), torch.from_numpy(y)).numpy(), want)


@pytest.mark.parametrize('a_shape,b_shape,dtype,match', [
    ((100, 64), (64, 128), torch.int8, 'multiple of the tile'),
    ((128, 64), (64, 200), torch.int8, 'multiple of the tile'),
    ((128, 48), (48, 128), torch.bfloat16, 'multiple of the tile'),
    ((128, 32), (32, 128), torch.float32, 'bf16 or int8'),
    ((128, 32), (64, 128), torch.bfloat16, 'contraction differs'),
    ((2, 128, 32), (32, 128), torch.bfloat16, '2-D'),
])
def test_tiled_matmul_raises(a_shape, b_shape, dtype, match):
    a = torch.zeros(a_shape, dtype=dtype)
    b = torch.zeros(b_shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        K.tiled_matmul(a, b)


def test_tiled_matmul_raises_on_mixed_types_and_int32_overflow():
    with pytest.raises(ValueError, match='bf16 or int8'):
        K.tiled_matmul(torch.zeros(128, 64, dtype=torch.int8),
                       torch.zeros(64, 128, dtype=torch.bfloat16))
    big = K.MAX_INT8_K + 64
    with pytest.raises(ValueError, match='overflow'):
        K.tiled_matmul(torch.zeros(128, big, dtype=torch.int8),
                       torch.zeros(big, 128, dtype=torch.int8))


def test_add_raises_on_shape_and_type():
    with pytest.raises(ValueError, match='shapes differ'):
        K.add(torch.zeros(4, 4), torch.zeros(4, 5))
    with pytest.raises(ValueError, match='float32'):
        K.add(torch.zeros(4, dtype=torch.float64),
              torch.zeros(4, dtype=torch.float64))


# -------------------------------------------------------- s2d stem

@pytest.mark.parametrize('n,hw,cout', [(2, 224, 64), (1, 30, 8)])
def test_stem_conv_s2d_matches_jax_and_regular_conv(n, hw, cout):
    rng = np.random.default_rng(hw)
    x = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    w = (rng.standard_normal((7, 7, 3, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(t) for t in (x, w, b))
    got = stem_conv_s2d(tx, tw, bias=tb).numpy()
    assert got.shape == (n, hw // 2, hw // 2, cout)
    want = np.asarray(j_stem_s2d(jnp.asarray(x), jnp.asarray(w),
                                 bias=jnp.asarray(b)))
    np.testing.assert_allclose(got, want, **STEM_TOL)
    regular = conv2d(tx, tw, stride=2, padding=3, bias=tb).numpy()
    np.testing.assert_allclose(got, regular, **STEM_TOL)


def test_stem_conv_s2d_raises_as_jax():
    with pytest.raises(ValueError, match='7x7/s2/p3'):
        stem_conv_s2d(torch.zeros(1, 8, 8, 3), torch.zeros(5, 5, 3, 4))
    with pytest.raises(ValueError, match='even spatial'):
        stem_conv_s2d(torch.zeros(1, 9, 8, 3), torch.zeros(7, 7, 3, 4))


def test_conv_s2d_guard_falls_back_to_regular_conv(monkeypatch):
    calls = []
    monkeypatch.setattr(tlayers, 'stem_conv_s2d',
                        lambda *a, **k: calls.append(1) or
                        stem_conv_s2d(*a, **k))
    x = torch.randn(1, 10, 10, 3, generator=torch.Generator().manual_seed(0))
    s2d = tlayers.Conv(3, 4, 7, stride=2, padding=3, s2d=True)
    plain = tlayers.Conv(3, 4, 7, stride=2, padding=3)
    plain.load_state_dict(s2d.state_dict())
    torch.testing.assert_close(s2d(x), plain(x), **STEM_TOL)
    assert calls == [1]
    s2d(torch.zeros(1, 9, 10, 3))                 # odd H: regular conv
    tlayers.Conv(3, 4, 7, stride=1, padding=3, s2d=True)(x)
    tlayers.Conv(3, 4, 3, stride=2, padding=1, s2d=True)(x)
    assert calls == [1]


LAYER = {'x_quant': 'ls-1', 'w_quant': 'ls-1',
         'clamp': {'kind': 'symmetric', 'alpha': 2.0},
         'double_shortcut': True}
S2D_CONFIG = dict(
    block='xnor',
    layer0={'n_in_channels': 8, 'kernel_size': 7, 'stride': 2,
            'padding': 3, 'bias': False,
            'maxpool': {'type': 'maxpool2d', 'kernel_size': 3,
                        'stride': 2, 'padding': 1}},
    layer1=dict(LAYER), layer2=dict(LAYER), layer3=dict(LAYER),
    layer4=None, nonlins=['prelu', 'prelu'], num_blocks=[1, 1, 1],
    output_classes=10, moving_average_mode='eval_only', stem_s2d=True)


def _perturbed(variables, rng):
    """Non-trivial BN affines (30% negative gammas) and stats, and
    tracked EMA scales, so the threshold fold has work to do."""
    def leaf(path, x):
        names = [getattr(p, 'key', '') for p in path]
        if names[-1] == 'ema_count':
            return np.ones_like(x)
        if names[0] == 'quant_state':
            return rng.uniform(0.1, 0.9, x.shape).astype(x.dtype)
        if names[0] == 'batch_stats':
            lo, hi = (-0.5, 0.5) if names[-1] == 'mean' else (0.2, 2.0)
            return rng.uniform(lo, hi, x.shape).astype(x.dtype)
        if 'bn' in names and names[-1] == 'scale':
            sgn = np.where(rng.random(x.shape) < 0.3, -1.0, 1.0)
            return (rng.uniform(0.3, 1.5, x.shape) * sgn).astype(x.dtype)
        if 'bn' in names and names[-1] == 'bias':
            return rng.uniform(-0.8, 0.8, x.shape).astype(x.dtype)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, dict(variables))


def test_qresnet_stem_s2d_matches_jax_fp32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    model = JQResNet(**S2D_CONFIG)
    init = jax.jit(lambda k, v: model.init(k, v, True))
    variables = _perturbed(init(jax.random.key(0), jnp.asarray(x[:2])), rng)
    packed = model.clone(inference_mode='packed')
    pvars = jax.jit(lambda v, s: jexport.export_packed_variables(
        packed, v, s))(variables, jnp.asarray(x[:1]))
    serve, fvars, folded = jexport.fold_for_serving(packed, pvars)
    assert folded
    svars = jax.tree.map(np.asarray,
                         jexport.strip_for_deployment(fvars))
    want = np.asarray(jax.jit(lambda v, t: serve.apply(v, t, False))(
        svars, jnp.asarray(x)))

    port = from_jax_variables(
        QResNet(**S2D_CONFIG, bn_fold=True, device='cpu'), svars)
    assert port.conv1.s2d
    got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **FP32_TOL)
    port.conv1.s2d = False   # the same parameters through the 7x7 conv
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want,
                               **FP32_TOL)


def test_bench_resnet18_is_the_bench_config():
    model = models.bench_resnet18('ls-1', 'ls-1', device='cpu')
    assert [n for n, _ in model.blocks()] == [
        f'layer{s}_block{b}' for s in range(1, 5) for b in range(2)]
    assert model.fc.kernel.shape == (512, 1000)
    assert model.conv1.kernel.shape == (7, 7, 3, 64)
    assert not model.conv1.s2d
    assert all(blk.double_shortcut for _, blk in model.blocks())


# ---------------------------------------------------------- probes

def _jax_probe_names(script):
    """Names of the @probe functions of a JAX probe script, by ast."""
    tree = ast.parse((REPO / 'tools' / script).read_text())
    return [node.name for node in tree.body
            if isinstance(node, ast.FunctionDef)
            and any(isinstance(d, ast.Name) and d.id == 'probe'
                    for d in node.decorator_list)]


@pytest.mark.parametrize('module,script', [(probe_r2, 'probe_r2.py'),
                                           (probe_r3, 'probe_r3.py')])
def test_probe_names_equal_the_jax_scripts(module, script, capsys):
    names = _jax_probe_names(script)
    assert len(names) > 10
    assert list(module.PROBES) == names
    assert common.main(module.PROBES, module.__doc__, ['--list']) == 0
    assert capsys.readouterr().out.split() == names


ALL_PROBES = ([('probe_r2', n) for n in _jax_probe_names('probe_r2.py')]
              + [('probe_r3', n) for n in _jax_probe_names('probe_r3.py')])


@pytest.mark.parametrize('module,name', ALL_PROBES)
def test_probe_default_device_needs_cuda(module, name):
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA; the rule is for machines '
                    'without it')
    fn = {'probe_r2': probe_r2, 'probe_r3': probe_r3}[module].PROBES[name]
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        fn()


@pytest.fixture
def records():
    common.RECORDS.clear()
    yield common.RECORDS
    common.RECORDS.clear()


def test_pallas_add_probe_on_cpu(records):
    probe_r2.pallas_add(device='cpu')
    (row,) = records
    assert row['probe'] == 'pallas_add' and row['device'] == 'cpu'
    assert row['correct'] is True and row['compiled'] is False


@pytest.mark.parametrize('fn,key', [
    (probe_r2.pallas_matmul_bf16, 'tflops'),
    (probe_r3.pallas_matmul_bf16_v2, 'tflops'),
    (probe_r3.pallas_matmul_int8, 'tops'),
])
def test_matmul_kernel_probes_on_cpu(fn, key, records):
    fn(device='cpu', n=256, inner=1)
    (row,) = records
    assert row['probe'] == fn.__name__ and row['n'] == 256
    assert row[key] > 0 and row['ms'] > 0


def test_probe_cli_appends_to_out(tmp_path, capsys, records):
    out = tmp_path / 'rows.jsonl'
    argv = ['pallas_add', '--device', 'cpu', '--out', str(out)]
    assert common.main(probe_r2.PROBES, probe_r2.__doc__, argv) == 0
    assert common.main(probe_r2.PROBES, probe_r2.__doc__, argv) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])['correct'] is True
    assert capsys.readouterr().out.count('"pallas_add"') == 2


def test_probe_cli_all_records_failures_and_goes_on(capsys, records):
    ran = []

    def good(device):
        ran.append(device)
        common.record('good', device, ok=True)

    def bad(device):
        raise ArithmeticError('boom')

    table = {'bad': bad, 'good': good}
    assert common.main(table, 'test probes', ['--all', '--device',
                                               'cpu']) == 1
    assert ran == [torch.device('cpu')]
    assert [r['probe'] for r in records] == ['bad', 'good']
    assert records[0]['error'] == 'ArithmeticError: boom'
    assert common.main(table, 'test probes', ['good', '--device',
                                               'cpu']) == 0
    capsys.readouterr()


def test_timed_loop_chains_and_times_per_rep():
    seen = []

    def step(c):
        seen.append(c)
        return c + 1

    sec, carry = common.timed_loop(step, 0, torch.device('cpu'), inner=3,
                                   outer=2)
    assert seen == list(range(9)) and carry == 9 and sec >= 0


def test_chain_keeps_values_and_tf32_restores():
    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    y = torch.full((4, 4), 7, dtype=torch.int32)
    assert torch.equal(probe_r2.chain(x.clone(), y), x)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    with common.tf32(not prev[0]):
        assert torch.backends.cuda.matmul.allow_tf32 == (not prev[0])
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == prev


def test_im2col3x3_is_the_hwio_conv():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 4, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 6)).astype(np.float32))
    got = common.im2col3x3(x) @ w.reshape(27, 6)
    want = conv2d(x, w, padding=1).reshape(-1, 6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('name', sorted(xnor_variants.KNOCKOUTS))
def test_xnor_knockouts_apply_only_where_their_text_is(name):
    """A knock-out replaces each of its texts where the source holds it
    once, and is stale (None) where it does not; 'kernel' changes
    nothing. Checked on a stand-in source, so the probe's texts need not
    follow every edit of csrc/xnor.cu."""
    subs = xnor_variants.KNOCKOUTS[name]
    src = 'head\n' + '\n'.join(old for old, _ in subs) + '\ntail\n'
    want = 'head\n' + '\n'.join(new for _, new in subs) + '\ntail\n'
    assert xnor_variants.variant_source(name, src) == want
    assert xnor_variants.variant_source(name, 'other') == (
        None if subs else 'other')
    assert xnor_variants.variant_source(name, src + src) == (
        None if subs else src + src)


@pytest.mark.parametrize('name', sorted(xnor_variants.WG_KNOCKOUTS))
def test_wgmma_knockouts_apply_to_their_file_only_where_their_text_is(name):
    """Each knock-out of the wgmma core or its loaders names an existing
    source and GEMM kernels to time, and substitutes as the conv's do
    (checked on a stand-in source)."""
    fname, kernels = xnor_variants.WG_TARGETS[name]
    assert (_build.CSRC / fname).is_file()
    assert kernels and set(kernels) <= set(xnor_variants.GEMMS)
    subs = xnor_variants.WG_KNOCKOUTS[name]
    src = 'head\n' + '\n'.join(old for old, _ in subs) + '\ntail\n'
    want = 'head\n' + '\n'.join(new for _, new in subs) + '\ntail\n'
    table = xnor_variants.WG_KNOCKOUTS
    assert xnor_variants.variant_source(name, src, table) == want
    assert xnor_variants.variant_source(name, 'other', table) is None
    assert xnor_variants.variant_source(name, src + src, table) is None


@pytest.mark.parametrize('name', sorted(xnor_variants.PLANES_VARIANTS))
def test_planes_variants_apply_only_where_their_text_is(name):
    """Each variant of the multi-plane conv substitutes as the conv's
    knock-outs do (checked on a stand-in source)."""
    table = xnor_variants.PLANES_VARIANTS
    subs = table[name]
    assert subs
    src = 'head\n' + '\n'.join(old for old, _ in subs) + '\ntail\n'
    want = 'head\n' + '\n'.join(new for _, new in subs) + '\ntail\n'
    assert xnor_variants.variant_source(name, src, table) == want
    assert xnor_variants.variant_source(name, 'other', table) is None
    assert xnor_variants.variant_source(name, src + src, table) is None


def test_sass_stage_is_the_loop_around_the_mmas():
    """The stage count runs from the label that the first backward
    branch after the last IMMA jumps to through that branch: forward
    branches (a k-step loop's early exit) and code outside the loop do
    not count; no backward branch gives None."""
    lines = [('MOV', ''), ('', '.L_x_1'), ('BAR', ''), ('STS', ''),
             ('BAR', ''), ('LDS', ''), ('IMMA', ''), ('BRA', '.L_x_2'),
             ('IMMA', ''), ('', '.L_x_2'), ('ISETP', ''), ('BRA', '.L_x_1'),
             ('STG', ''), ('EXIT', '')]
    assert xnor_variants._stage(lines) == [
        'BAR', 'STS', 'BAR', 'LDS', 'IMMA', 'BRA', 'IMMA', 'ISETP', 'BRA']
    assert xnor_variants._stage(lines[:-4] + [('EXIT', '')]) is None


def test_sass_listing_reads_labels_and_addresses(monkeypatch):
    """cuobjdump's listing parsed into opcodes and BRA targets, a target
    named by label or by address (an operand like `c[0x0]` of any other
    instruction is no target), and the stage loop found in both forms."""
    body = ('        /*0000*/                   MOV R1, c[0x0][0x28] ;\n'
            '                                   /* 0x000fe40000000800 */\n'
            '{top}        /*0010*/                   BAR.SYNC 0x0 ;\n'
            '        /*0020*/                   IMMA.16832.S8.S8 R4, R8 ;\n'
            '        /*0030*/               @P0 BRA {fwd} ;\n'
            '        /*0040*/                   IMMA.16832.S8.S8 R4, R8 ;\n'
            '{mid}        /*0050*/              @!P1 BRA {back} ;\n'
            '        /*0060*/                   EXIT ;\n')
    sass = ('\tFunction : by_label\n' + body.format(
        top='.L_x_1:\n', mid='.L_x_2:\n', fwd='`(.L_x_2)', back='`(.L_x_1)')
        + '\tFunction : by_address\n' + body.format(
            top='', mid='', fwd='0x50', back='0x10'))
    monkeypatch.setattr(_build, 'nvcc_path', lambda: '/cuda/bin/nvcc')
    monkeypatch.setattr(xnor_variants.subprocess, 'run', lambda *a, **k: (
        type('Done', (), {'stdout': sass})))
    listing = xnor_variants._listing('lib.so')
    assert set(listing) == {'by_label', 'by_address'}
    for lines in listing.values():
        assert [op for op, _ in lines if op] == [
            'MOV', 'BAR', 'IMMA', 'BRA', 'IMMA', 'BRA', 'EXIT']
        assert [t for op, t in lines if op and t] in (
            ['.L_x_2', '.L_x_1'], ['0x50', '0x10'])
        assert xnor_variants._stage(lines) == ['BAR', 'IMMA', 'BRA', 'IMMA',
                                               'BRA']


def test_variants_build_apart():
    """Every (variant, source) pair is built in a directory of its own,
    so a baseline xnor.cu, probe.cu and pool.cu cannot overwrite each
    other's copy of the sources."""
    assert set(xnor_variants.WG_TARGETS) == set(xnor_variants.WG_KNOCKOUTS)
    pairs = {(v, s) for v in ('baseline', *xnor_variants.KNOCKOUTS,
                              *xnor_variants.PLANES_VARIANTS,
                              *xnor_variants.WG_KNOCKOUTS,
                              *xnor_variants.BW_VARIANTS)
             for s in ('xnor', 'probe', 'pool')}
    dirs = {xnor_variants.lib_file(v, s).parent for v, s in pairs}
    assert len(dirs) == len(pairs)


@pytest.mark.parametrize('name', sorted(xnor_variants.BW_VARIANTS))
def test_bandwidth_variants_apply_to_the_sources_as_they_are(name):
    """Each variant of the pool or the add names its part and changes the
    source of that part as it stands: none is stale, so each is built
    and timed."""
    part = name.split('_')[0]
    assert part in xnor_variants.BW_FILES and part in xnor_variants.PARTS
    src = (_build.CSRC / xnor_variants.BW_FILES[part]).read_text()
    got = xnor_variants.variant_source(name, src, xnor_variants.BW_VARIANTS)
    assert got is not None and got != src


def test_variants_parts_are_checked_before_the_device():
    with pytest.raises(SystemExit):
        xnor_variants.main(['--parts', 'pool,bogus'])
    assert xnor_variants.main(['--parts', 'pool,add']) == 2  # no CUDA here
