"""Spatial partitioning in the port (parallel/spatial.py, the banded
layers and models, the banded InferenceEngine, the kernels' row bands)
against the JAX package, on the CPU over gloo.

One world of 4 ranks is spawned once for the file, as
tests/test_torch_port_tp.py spawns its worlds; JAX runs in this process
on the virtual CPU devices of tests/conftest.py. Cases:

* JAX's five GEOMETRIES (tests/parallel/test_spatial.py): each rank's
  band of `halo_exchange_conv2d` against JAX's halo conv and the
  unsharded conv; the halo max pool (equal); the two-layer chain; a
  ('data' 2, 'space' 2) mesh; the three geometry errors; the halo
  conv's input gradient against unsharded autograd;
* the kernels' plain twins on a band (pad_top, pad_bottom) against the
  whole map's rows, exact: xnor_conv2d, xnor_conv2d_planes, the stem
  pool (NaN and +-inf planted), and the raw-zero-edge control (JAX's
  0.0 fill of an fp conv's edge into the binary conv differs);
* banded packed models against JAX's packed apply and the unsharded
  port, with the layers that ran banded: JAX's
  test_gspmd_spatial_packed_model config (per-batch ls-1 scales solved
  on the gathered sample), the threshold-folded small XNOR ResNet (the
  main path's form: 7x7 stem, banded pool, layer3 on), and ls-2 x ls-1
  'off' models on the bake and on the int8 route;
* JAX's LeNet-5 engine case (tests/serving/test_spatial_serving.py)
  through the banded InferenceEngine, predict and queued, and its
  input_sharding check.

Training under 'space': tests/test_torch_port_spatial_train.py.
"""

import copy
import sys

import numpy as np
import pytest
import torch

from chip_smoke import band_rows, plant_specials, tail_calls
from tests.test_torch_port_tp import run_world

WORLD = 4
# JAX's own tolerances (tests/parallel/test_spatial.py,
# tests/serving/test_spatial_serving.py). Against JAX's conv the absolute
# part is taken relative to the output's largest magnitude: an output
# near 0 sums terms of that magnitude, and the two frameworks' float32
# convs sum them in other orders (the port's unsharded 7x7 conv here is
# 7.6e-5 from JAX's at values up to 75; each is within 7.1e-5 of a
# float64 conv).
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE_TOL = dict(rtol=1e-5, atol=1e-5)
GEOMETRIES = [(3, 3, 1, 1), (3, 3, 2, 1), (1, 1, 2, 0), (7, 7, 2, 3),
              (5, 5, 1, 2)]
_CLAMP = {'kind': 'symmetric', 'alpha': 2.0}
_LAYER = {'x_quant': 'ls-1', 'w_quant': 'ls-1', 'clamp': _CLAMP}
# JAX's test_gspmd_spatial_packed_model: ('resnet', constructor kw).
JAX_RESNET = dict(
    block='xnor', layer0={'n_in_channels': 16, 'kernel_size': 3,
                          'stride': 1, 'padding': 1, 'bias': False,
                          'maxpool': {'type': 'identity'}},
    layer1=dict(_LAYER), layer2=dict(_LAYER), layer3=dict(_LAYER),
    layer4=dict(_LAYER), nonlins=['prelu', 'prelu'], num_blocks=[1, 1, 1, 1],
    output_classes=10)
# The banded models: (x_quant, w_quant, keywords; None: JAX's config,
# else probes.models.small_config's XNOR ResNet), and the convs that run
# banded at 32 px over 4 bands (the rest run whole).
_SMALL_BANDED = ['conv1', 'layer1_block0.conv1', 'layer1_block0.conv2',
                 'layer2_block0.conv1', 'layer2_block0.shortcut.conv',
                 'layer2_block0.conv2']
MODEL_CASES = {
    'jax_gspmd': ('ls-1', 'ls-1', None),
    'folded': ('ls-1', 'ls-1', {}),
    'off_ls2_bake': ('ls-2', 'ls-1', {'moving_average_mode': 'off'}),
    'off_ls2_int8': ('ls-2', 'ls-1', {'moving_average_mode': 'off',
                                      'sign_compute': 'int8'}),
}
LENET = dict(conv1_filters=4, conv2_filters=16, x_quant='ls-1',
             w_quant='ls-1', clamp=_CLAMP)


def _x(shape: tuple, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _geometry_operands(kh: int, kw: int) -> tuple:
    rng = np.random.default_rng(kh * 10 + kw)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    w = rng.standard_normal((kh, kw, 8, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    return x, w, b


def _model(case: str) -> torch.nn.Module:
    """The case's packed port model on the CPU, seeded and prepared."""
    from quant_tpu_torch.nn import QResNet
    from quant_tpu_torch.probes import models
    xq, wq, kw = MODEL_CASES[case]
    if kw is None:
        def make(x_quant: str, w_quant: str, **kwargs) -> torch.nn.Module:
            return QResNet(**copy.deepcopy(JAX_RESNET), **kwargs)
    else:
        def make(x_quant: str, w_quant: str, **kwargs) -> torch.nn.Module:
            return models.build('xnor', models.small_config(
                'xnor', x_quant, w_quant), **kw, **kwargs)
    return models.seeded_model(make, xq, wq, 'cpu', seed=3)


def _lenet() -> torch.nn.Module:
    from quant_tpu_torch.nn import QLeNet5
    from quant_tpu_torch.probes import models

    def make(x_quant: str, w_quant: str, **kwargs) -> torch.nn.Module:
        return QLeNet5(**LENET, **kwargs)
    return models.seeded_model(make, 'ls-1', 'ls-1', 'cpu', seed=5)


# ---------------------------------------------------------- the world


def _bands(t: np.ndarray, p: int) -> list:
    return np.split(t, p, axis=1)


def _banded_forward(model: torch.nn.Module, x: np.ndarray, mesh) -> tuple:
    """(logits, [(conv, ran banded)]) of a banded model's forward on this
    rank's band of x."""
    from quant_tpu_torch.nn.layers import Conv, QuantConv2d
    from quant_tpu_torch.parallel import band_model, local_band
    band_model(model, mesh)
    ran = []
    hooks = [m.register_forward_hook(
        lambda mod, args, y, name=name: ran.append((name, mod.space.banded)))
        for name, m in model.named_modules()
        if isinstance(m, (Conv, QuantConv2d))]
    logits = model(local_band(torch.from_numpy(x), mesh)).numpy()
    for h in hooks:
        h.remove()
    return logits, ran


def _serve_lenet(rank: int, mesh) -> dict:
    from quant_tpu_torch.nn.layers import Conv, QuantConv2d
    from quant_tpu_torch.parallel import band_model, spatial_sharding
    from quant_tpu_torch.serving.engine import InferenceEngine
    x = _x((8, 28, 28, 1), 7)
    model = band_model(_lenet(), mesh)
    ran = set()
    for name, m in model.named_modules():
        if isinstance(m, (Conv, QuantConv2d)):
            m.register_forward_hook(lambda mod, args, y, name=name: ran.add(
                (name, mod.space.banded)))
    engine = InferenceEngine(model, (28, 28, 1), max_batch=8, device='cpu',
                             input_sharding=spatial_sharding(mesh)).start()
    if rank:
        engine.stop(timeout=60)
        return dict(ran=sorted(ran))
    try:
        got = engine.predict(x)
        futs = [engine.submit(img) for img in x]
        queued = np.stack([f.result(timeout=60) for f in futs])
    finally:
        engine.stop()
    return dict(predict=got, queued=queued, ran=sorted(ran))


def _world4(rank: int) -> dict:
    from torch.distributed.device_mesh import DeviceMesh
    from quant_tpu_torch.parallel import (
        halo_exchange_conv2d, halo_exchange_max_pool2d, local_band,
    )
    mesh = DeviceMesh('cpu', torch.arange(WORLD), mesh_dim_names=('space',))
    mesh2 = DeviceMesh('cpu', torch.arange(WORLD).reshape(2, 2),
                       mesh_dim_names=('data', 'space'))
    out: dict = {'conv': {}, 'errors': {}}
    for kh, kw, s, p in GEOMETRIES:
        x, w, b = (torch.from_numpy(a) for a in _geometry_operands(kh, kw))
        out['conv'][(kh, kw, s, p)] = halo_exchange_conv2d(
            local_band(x, mesh), w, mesh=mesh, stride=s, padding=p,
            bias=b).numpy()
    x = torch.from_numpy(_x((2, 16, 16, 8), 1))
    out['pool'] = halo_exchange_max_pool2d(
        local_band(x, mesh), mesh=mesh, kernel_size=3, stride=2,
        padding=1).numpy()
    w = torch.from_numpy(_x((3, 3, 8, 8), 2))
    y = halo_exchange_conv2d(local_band(x, mesh), w, mesh=mesh, stride=1,
                             padding=1)
    out['chain'] = halo_exchange_conv2d(y, w, mesh=mesh, stride=1,
                                        padding=1).numpy()
    x4, w4 = (torch.from_numpy(_x(s, i)) for s, i in (((4, 16, 16, 8), 3),
                                                       ((3, 3, 8, 16), 4)))
    out['data_space'] = halo_exchange_conv2d(
        local_band(x4, mesh2, batch_axis='data'), w4, mesh=mesh2,
        batch_axis='data', stride=1, padding=1).numpy()
    # The halo conv's input gradient: a band's own rows' gradient plus the
    # halo rows' gradients its neighbours send back.
    xb = local_band(torch.from_numpy(_x((2, 16, 16, 8), 5)),
                    mesh).requires_grad_(True)
    wg = torch.from_numpy(_x((3, 3, 8, 4), 6))
    (halo_exchange_conv2d(xb, wg, mesh=mesh, stride=1, padding=1)
     ** 2).sum().backward()
    out['grad'] = xb.grad.numpy()
    zeros = torch.zeros((1, 16, 16, 4))
    w_valid = torch.zeros((3, 3, 4, 4))
    for name, fn in (
            ('shape-preserving', lambda: halo_exchange_conv2d(
                local_band(zeros, mesh), w_valid, mesh=mesh, stride=1,
                padding=0)),
            ('divide', lambda: local_band(torch.zeros((1, 18, 16, 4)), mesh)),
            ('stride', lambda: halo_exchange_conv2d(
                local_band(torch.zeros((1, 12, 16, 4)), mesh), w_valid,
                mesh=mesh, stride=2, padding=1))):
        try:
            fn()
            out['errors'][name] = None
        except ValueError as e:
            out['errors'][name] = str(e)
    out['models'], out['model_tails'] = {}, {}
    with torch.no_grad():
        for case in MODEL_CASES:
            with tail_calls() as tails:
                out['models'][case] = _banded_forward(
                    _model(case), _x((2, 32, 32, 3), 8), mesh)
            out['model_tails'][case] = tails[0]
    out['lenet'] = _serve_lenet(rank, mesh)
    return out


def _worker() -> None:
    """One rank: python -c '...' <rank> <world> <port> <out> <inputs>."""
    rank, world, port = (int(a) for a in sys.argv[1:4])
    from quant_tpu_torch.parallel import multihost
    multihost.initialize(f'127.0.0.1:{port}', world, rank, device='cpu')
    result = _world4(rank)
    torch.save(result, sys.argv[4])


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('space_world')
    return run_world(tmp, WORLD, tmp / 'unused', 'test_torch_port_spatial')


# ---------------------------------------------------------- the JAX side


@pytest.fixture(scope='module')
def jax_side():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from quant_tpu.ops.conv import conv2d, max_pool2d
    from quant_tpu.parallel.spatial import (
        halo_exchange_conv2d, halo_exchange_max_pool2d, spatial_sharding,
    )
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ('space',))

    def band(a: np.ndarray):
        return jax.device_put(jnp.asarray(a), spatial_sharding(mesh))

    out: dict = {'conv': {}, 'whole': {}}
    for kh, kw, s, p in GEOMETRIES:
        x, w, b = (jnp.asarray(a) for a in _geometry_operands(kh, kw))
        out['conv'][(kh, kw, s, p)] = np.asarray(halo_exchange_conv2d(
            band(x), w, mesh=mesh, stride=s, padding=p, bias=b))
        out['whole'][(kh, kw, s, p)] = np.asarray(conv2d(
            x, w, stride=s, padding=p, bias=b))
    x = jnp.asarray(_x((2, 16, 16, 8), 1))
    out['pool'] = np.asarray(halo_exchange_max_pool2d(
        band(x), mesh=mesh, kernel_size=3, stride=2, padding=1))
    out['pool_whole'] = np.asarray(max_pool2d(x, kernel_size=3, stride=2,
                                              padding=1))
    w = jnp.asarray(_x((3, 3, 8, 8), 2))
    out['chain'] = np.asarray(conv2d(conv2d(x, w, stride=1, padding=1), w,
                                     stride=1, padding=1))
    mesh2 = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(2, 2),
                 ('data', 'space'))
    x4, w4 = (jnp.asarray(_x(s, i)) for s, i in (((4, 16, 16, 8), 3),
                                                 ((3, 3, 8, 16), 4)))
    out['data_space'] = np.asarray(halo_exchange_conv2d(
        jax.device_put(x4, spatial_sharding(mesh2, batch_axis='data')), w4,
        mesh=mesh2, batch_axis='data', stride=1, padding=1))
    return out


def _jax_packed(model: torch.nn.Module, family: str, kw: dict,
                x: np.ndarray) -> np.ndarray:
    """JAX's packed apply of the port model's tree, jitted."""
    import jax
    from quant_tpu.nn import QLeNet5, QResNet
    from quant_tpu_torch.utils.jax_import import to_jax_variables
    cls = QLeNet5 if family == 'lenet' else QResNet
    jm = cls(**copy.deepcopy(kw), inference_mode='packed')
    tree = to_jax_variables(model)
    return np.asarray(jax.jit(lambda v, xb: jm.apply(v, xb, False))(
        tree, x))


# ------------------------------------------------------------ the cases


def _jax_tol(want: np.ndarray) -> dict:
    return dict(rtol=CONV_TOL['rtol'],
                atol=CONV_TOL['atol'] * float(np.abs(want).max()))


@pytest.mark.parametrize('geometry', GEOMETRIES)
def test_halo_conv_matches_jax_and_unsharded(world, jax_side, geometry):
    from quant_tpu_torch.ops.conv import conv2d
    kh, kw, s, p = geometry
    x, w, b = (torch.from_numpy(a) for a in _geometry_operands(kh, kw))
    whole = conv2d(x, w, stride=s, padding=p, bias=b).numpy()
    want = jax_side['conv'][geometry]
    np.testing.assert_allclose(want, jax_side['whole'][geometry], **CONV_TOL)
    for rank, r in enumerate(world):
        got = r['conv'][geometry]
        np.testing.assert_allclose(got, _bands(whole, WORLD)[rank],
                                   **CONV_TOL)
        np.testing.assert_allclose(got, _bands(want, WORLD)[rank],
                                   **_jax_tol(want))


def test_halo_max_pool_equals_jax(world, jax_side):
    np.testing.assert_array_equal(jax_side['pool'], jax_side['pool_whole'])
    for rank, r in enumerate(world):
        np.testing.assert_array_equal(
            r['pool'], _bands(jax_side['pool'], WORLD)[rank])


def test_two_layer_chain(world, jax_side):
    for rank, r in enumerate(world):
        np.testing.assert_allclose(
            r['chain'], _bands(jax_side['chain'], WORLD)[rank], **CHAIN_TOL)


def test_halo_conv_with_batch_axis(world, jax_side):
    want = jax_side['data_space']
    for rank, r in enumerate(world):
        d, s = divmod(rank, 2)
        rows = np.split(want, 2, axis=0)[d]
        np.testing.assert_allclose(r['data_space'],
                                   np.split(rows, 2, axis=1)[s],
                                   **_jax_tol(want))


@pytest.mark.parametrize('match', ['shape-preserving', 'divide', 'stride'])
def test_geometry_validation(world, match):
    for r in world:
        assert r['errors'][match] is not None and match in r['errors'][
            match], r['errors']


def test_halo_conv_gradient_matches_unsharded_autograd(world):
    from quant_tpu_torch.ops.conv import conv2d
    x = torch.from_numpy(_x((2, 16, 16, 8), 5)).requires_grad_(True)
    w = torch.from_numpy(_x((3, 3, 8, 4), 6))
    (conv2d(x, w, stride=1, padding=1) ** 2).sum().backward()
    want = _bands(x.grad.numpy(), WORLD)
    for rank, r in enumerate(world):
        np.testing.assert_allclose(r['grad'], want[rank], **CONV_TOL)


# The kernels' bands: (C, H, stride) of binary convs, as on the card.
BAND_CASES = [(64, 16, 1), (64, 16, 2), (40, 24, 2), (96, 8, 1)]


def _words(shape: tuple, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                         dtype=torch.int32)


@pytest.mark.parametrize('p', [2, 4])
@pytest.mark.parametrize('c,h,s', BAND_CASES)
def test_banded_conv_twins_equal_the_whole_maps_rows(c, h, s, p):
    from quant_tpu_torch.ops import binary_infer as B
    wc, o = -(-c // 32), 24
    g = torch.Generator().manual_seed(c + h)
    args = (_words((3, 3, wc, o), 1), torch.rand(2, generator=g) + 0.1,
            torch.rand(o, generator=g), torch.randn(o, generator=g))
    pargs = (_words((2, 3, 3, wc, o), 2), torch.rand(2, 2, generator=g),
             torch.rand(1, o, generator=g), None)
    kw = dict(in_channels=c, stride=s, padding=1, out_dtype=torch.bfloat16)
    for words, conv, a, extra in (
            (_words((2, h, h, wc), 3), B.xnor_conv2d, args, {}),
            (_words((2, 2, h, h, wc), 4), B.xnor_conv2d_planes, pargs,
             dict(w_group=2))):
        whole = conv(words, *a, **kw, **extra)
        for rank in range(p):
            ext, top, bottom = band_rows(words, rank, p, 3, s, 1)
            got = conv(ext, *a, pad_top=top, pad_bottom=bottom, **kw,
                       **extra)
            rows = whole.shape[-3] // p
            assert torch.equal(got, whole.narrow(-3, rank * rows, rows)), (
                conv.__name__, rank)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('p', [2, 4])
def test_banded_pool_twin_equals_the_whole_maps_rows(dtype, p):
    from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1
    x = plant_specials(torch.randn((2, 16, 12, 24), generator=torch.
                                   Generator().manual_seed(p)).to(dtype), p)
    whole = max_pool_3x3_s2_p1(x)
    for rank in range(p):
        ext, top, _ = band_rows(x, rank, p, 3, 2, 1)
        got = max_pool_3x3_s2_p1(ext, top)
        want = whole[:, rank * (8 // p):(rank + 1) * (8 // p)]
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_pool_band_rules():
    from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1, pool_fusable
    assert pool_fusable((1, 57, 112, 64), 3, 2, 1, pad_top=0)
    assert not pool_fusable((1, 56, 112, 64), 3, 2, 1, pad_top=0)
    assert not pool_fusable((1, 57, 112, 64), 3, 2, 1)
    with pytest.raises(ValueError, match='even'):
        max_pool_3x3_s2_p1(torch.zeros(1, 8, 8, 4), 0)
    with pytest.raises(ValueError, match='pad_top'):
        max_pool_3x3_s2_p1(torch.zeros(1, 8, 8, 4), 2)


def test_raw_zero_edge_control_differs():
    """JAX's exchange fills an fp conv's edge rows with 0.0; a 0.0 packs
    to a +1 bit, not to the zero the binary operand is padded with, so
    raw rows filled so into the binary conv differ from the whole map,
    while the words with the kernel's own top padding agree."""
    from quant_tpu_torch.ops import binary_infer as B
    g = torch.Generator().manual_seed(9)
    act = torch.randn((2, 8, 8, 32), generator=g)
    args = (_words((3, 3, 1, 8), 5), torch.rand(2, generator=g) + 0.1,
            torch.rand(8, generator=g), None)
    kw = dict(in_channels=32, stride=1, padding=1)
    want = B.xnor_conv2d(B.pack_sign_planes(act, 1)[0], *args, **kw)[:, :4]
    ext, top, bottom = band_rows(act, 0, 2, 3, 1, 1)
    right = B.xnor_conv2d(B.pack_sign_planes(ext, 1)[0], *args, pad_top=top,
                          pad_bottom=bottom, **kw)
    assert torch.equal(right, want)
    filled = torch.cat([torch.zeros_like(ext[:, :1]), ext], dim=1)
    wrong = B.xnor_conv2d(B.pack_sign_planes(filled, 1)[0], *args, pad_top=0,
                          pad_bottom=0, **kw)
    assert not torch.equal(wrong, want)
    assert torch.equal(wrong[:, 1:], want[:, 1:])  # only the edge row


@pytest.mark.parametrize('case', list(MODEL_CASES))
def test_banded_packed_model(world, case):
    """Each rank's logits against the unsharded port model's (and, for
    JAX's config, JAX's packed apply), and which convs ran banded: at 32
    px over 4 bands JAX's config bands every conv; the small ResNet's
    7x7 stem and pool leave 2 rows a band at layer1, 1 at layer2's
    output, and layer3's stride gathers the map."""
    model = _model(case)
    x = _x((2, 32, 32, 3), 8)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    if case == 'jax_gspmd':
        np.testing.assert_allclose(
            want, _jax_packed(model, 'resnet', JAX_RESNET, x), **MODEL_TOL)
    convs = [n for n, _ in world[0]['models'][case][1]]
    banded = (convs if case == 'jax_gspmd' else _SMALL_BANDED)
    for r in world:
        logits, ran = r['models'][case]
        np.testing.assert_allclose(logits, want, **MODEL_TOL)
        assert [n for n, b in ran if b] == banded
        assert all(not b for n, b in ran if n not in banded)


def test_banded_forward_takes_no_tail(world):
    """A banded model's blocks keep their tails on the eager ops, the ones
    past the gather too (no binary conv is handed a tail on any rank);
    unbanded, the same model hands each binary conv its tail."""
    for r in world:
        assert r['model_tails'] == {case: 0 for case in MODEL_CASES}
    model = _model('folded')
    with tail_calls() as tails, torch.no_grad():
        model(torch.from_numpy(_x((2, 32, 32, 3), 8)))
    assert tails[0] == 8


def test_banded_engine_serves_lenet_like_jax(world):
    """JAX's engine case: LeNet-5 served with the input banded over 4
    ranks (its VALID conv1 gathers the bands), predict and queued
    requests against JAX's packed apply of the same tree."""
    model = _lenet()
    x = _x((8, 28, 28, 1), 7)
    want = _jax_packed(model, 'lenet', LENET, x)
    got = world[0]['lenet']
    np.testing.assert_allclose(got['predict'], want, **ENGINE_TOL)
    np.testing.assert_allclose(got['queued'], want, **ENGINE_TOL)
    for r in world:  # conv1 gathers the bands: both convs run whole
        assert r['lenet']['ran'] == [('conv1', False), ('conv2', False)]
    assert all(set(r['lenet']) == {'ran'} for r in world[1:])


def test_engine_refuses_input_sharding_without_a_banded_model():
    from quant_tpu_torch.serving.engine import InferenceEngine
    with pytest.raises(ValueError, match='band_model'):
        InferenceEngine(_lenet(), (28, 28, 1), device='cpu',
                        input_sharding=('Shard(1)',))

