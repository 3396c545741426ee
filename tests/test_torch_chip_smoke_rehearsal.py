"""Rehearsal of chip_smoke.py on the CPU, at batch 2.

chip_smoke.py runs only on a CUDA card. Here it runs end to end with the
device set to the CPU, where every kernel wrapper takes its plain twin:
nvcc, the card's name, CUDA events and the launch counters (which only
a CUDA launch bumps) are stood in for, the probe path is cut to toy
sizes, the serving stack to 4 requests with its worker processes
serving the 'lenet_random' spec on the CPU, and the model and recipe
phases to small models, the train phase to small models at batch 2,
the experiment phase to a small MNIST (LeNet-5 at the recipe's widths)
and to small ResNets at 32 px on 8 synthetic images, its torch.profiler
reading (which needs the card's kernels) stood in for.
That catches Python-level breakage of the
script (arguments, shapes, the phases' control flow, the report's keys)
before a run on the card.
"""

import json
import time

import pytest
import torch

import chip_smoke
from quant_tpu_torch import _build
from quant_tpu_torch.ops import pool
from quant_tpu_torch.probes import models

# The model phases' models cut to probes.models.small_config (width 8,
# one block a stage, 32 px; LeNet-5 with 8 and 12 filters): (make,
# input, QuantConv2d count, stem pool launches).
SMALL_MODELS = {
    key: (lambda xq, wq, family=family, **kw: models.build(
        family, models.small_config(family, xq, wq), **kw), hwc, convs, pools)
    for key, family, hwc, convs, pools in (
        ('resnet18', 'xnor', (32, 32, 3), 8, 1),
        ('resnet18_regular', 'regular', (32, 32, 3), 8, 1),
        ('resnet50', 'regular_bottleneck', (32, 32, 3), 12, 1),
        ('lenet', 'lenet', (28, 28, 1), 1, 0))}


def phase_counts() -> list[dict]:
    """The launch counts each model phase expects of its small model."""
    out = []
    for _, build, _, _, _, per_conv in chip_smoke.MODEL_PHASES:
        _, _, convs, pools = SMALL_MODELS[build]
        want = {k: 0 for k in chip_smoke.SERVING_KERNELS
                + chip_smoke.PROBE_KERNELS}
        want.update({k: v * convs for k, v in per_conv.items()})
        want['max_pool_3x3_s2_p1'] = pools
        out.append(want)
    return out



def worker_launches(before: dict, after: dict, per_batch=None) -> dict:
    """The CPU workers launch no kernel: their counts stay as they were."""
    got = {k: after['kernel_launches'][k] - before['kernel_launches'][k]
           for k in after['kernel_launches']}
    assert {'xnor_conv2d', 'pack_sign_planes', 'max_pool_3x3_s2_p1'} <= set(
        got)
    assert not any(got.values()), got
    return got


# The experiment phase's ImageNet recipes narrowed to small_config's
# ResNets (width 8, one block a stage, 10 classes) at 32 px, batch 4.
SMALL_RECIPE = {
    'model.arch_config': {
        'layer0': {'n_in_channels': 8, 'kernel_size': 7, 'stride': 2,
                   'padding': 3, 'bias': False,
                   'maxpool': {'type': 'maxpool2d', 'kernel_size': 3,
                               'stride': 2, 'padding': 1}},
        'num_blocks': [1, 1, 1, 1], 'output_classes': 10},
    'data': {'train_batch_size': 4, 'test_batch_size': 4}}
SMALL_SERVED = {'xnor_conv2d': 8, 'pack_sign_planes': 8,
                'max_pool_3x3_s2_p1': 1}


def small_family(family: str):
    """A builder of small_config models of a family, (x_quant, w_quant,
    **kwargs) as the recipes' builders."""
    def make(x_quant: str, w_quant: str, **kw) -> torch.nn.Module:
        return models.build(family, models.small_config(
            family, x_quant, w_quant), **kw)
    return make


class HostEvent:
    """A CUDA event's stand-in on the host clock."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end: 'HostEvent') -> float:
        return (end.t - self.t) * 1e3


KERNEL_KEYS = {'name', 'route', 'source', 'replaces', 'launches',
               'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
               'library_ms'}


@pytest.fixture
def rehearsal(monkeypatch):
    """chip_smoke on the CPU; yields the expected main-path counts."""
    main = {k: 0 for k in chip_smoke.SERVING_KERNELS
            + chip_smoke.PROBE_KERNELS}
    main.update(xnor_conv2d=16, pack_sign_planes=16,
                max_pool_3x3_s2_p1=1)
    probe = dict(main, **{k: 1 for k in chip_smoke.PROBE_KERNELS})
    # The in-process frontend serves its 4 requests as 2 batches of 2.
    frontend = dict(main, xnor_conv2d=32, pack_sign_planes=32,
                    max_pool_3x3_s2_p1=2)
    # The train phase: each configuration's 10 timed steps launch the
    # teacher's pool once a step; the eval step's 2 batches the pool
    # only; the served small student (8 binary convs) one forward.
    idle = {k: 0 for k in main}
    train_steps = [dict(idle, max_pool_3x3_s2_p1=10)] * 3
    train_eval = dict(idle, max_pool_3x3_s2_p1=2)
    train_serve = dict(idle, xnor_conv2d=8, pack_sign_planes=8,
                       max_pool_3x3_s2_p1=1)
    # The experiment phase: the LeNet-5 artifact's forward, the teacher's
    # run (its eval's pool), the KD student's run (2 steps of the frozen
    # teacher, 1 eval batch), the small ResNet artifact's forward.
    experiment = [dict(idle, xnor_conv2d=1, pack_sign_planes=1),
                  dict(idle, max_pool_3x3_s2_p1=1),
                  dict(idle, max_pool_3x3_s2_p1=3), dict(idle, **SMALL_SERVED)]
    counts = iter([main, frontend, *phase_counts(), *train_steps,
                   train_eval, train_serve, *experiment, probe])
    monkeypatch.setattr(chip_smoke, 'PHASE_MODELS', SMALL_MODELS)
    monkeypatch.setattr(chip_smoke, 'DEVICE', 'cpu')
    monkeypatch.setattr(chip_smoke, 'card_ms',
                        lambda fn, *args, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, 'card_alone_ms',
                        lambda fn, *args, **kw: (fn(), (1.0, 1))[1])
    monkeypatch.setattr(chip_smoke, 'card_line', lambda: 'CPU, 0 W')
    monkeypatch.setattr(chip_smoke, 'MATMUL_SHAPES', ((128, 128, 128),))
    monkeypatch.setattr(chip_smoke, 'ADD_BW_SHAPE', (64, 36))
    # The launcher's route query needs the built library: here the
    # wrapper's own rule stands in, on the CPU tensors' addresses.
    monkeypatch.setattr(chip_smoke, 'pool_route', lambda x, out: (
        pool.vector_bytes(x.shape[-1], x.element_size(), x.data_ptr(),
                          out.data_ptr())))
    monkeypatch.setattr(chip_smoke, 'PROBE_PHASE', (
        ('probe_r2', 'pallas_add', {}),
        ('probe_r3', 'pallas_matmul_int8', {'n': 128, 'inner': 1}),
        ('probe_r3', 'pallas_matmul_bf16_v2', {'n': 128, 'inner': 1}),
        ('probe_r3', 'batch_sweep_model', {'batches': (2,), 'iters': 1}),
    ))
    monkeypatch.setattr(chip_smoke, 'SERVING_REQUESTS', 4)
    monkeypatch.setattr(chip_smoke, 'WORKER_SPEC', {
        'model': 'lenet_random', 'max_batch': 4, 'input_shape': [28, 28, 1]})
    monkeypatch.setattr(chip_smoke, '_worker_launches', worker_launches)
    # The occupancy query needs the built library.
    monkeypatch.setattr(chip_smoke, 'occupancy', lambda dt, *layout: dict(
        registers=len(layout), blocks_per_sm=3))
    monkeypatch.setattr(_build, 'build', lambda verbose=False: {})
    monkeypatch.setattr(chip_smoke, 'TRAIN_MODELS', (
        small_family('xnor'), small_family('regular'), (32, 32, 3), 10))
    for name in ('TRAIN_BATCH', 'TRAIN_CHECK_BATCH', 'REMAT_CHECK_BATCH',
                 'TRAIN_SERVE_BATCH'):
        monkeypatch.setattr(chip_smoke, name, 2)
    monkeypatch.setattr(chip_smoke, 'cuda_event', HostEvent)
    monkeypatch.setattr(chip_smoke, 'EXPERIMENT_MNIST', dict(
        chip_smoke.EXPERIMENT_MNIST, train=128, test=64))
    imagenet = chip_smoke.EXPERIMENT_IMAGENET
    monkeypatch.setattr(chip_smoke, 'EXPERIMENT_IMAGENET', dict(
        imagenet, per_forward=SMALL_SERVED, data=dict(
            imagenet['data'], image_shape=[32, 32, 3], num_classes=10,
            train_size=8, test_size=4)))
    monkeypatch.setattr(chip_smoke, 'EXPERIMENT_OVERRIDES', {
        imagenet['teacher']: SMALL_RECIPE, imagenet['student']: SMALL_RECIPE})
    monkeypatch.setattr(chip_smoke, 'loader_profile', lambda step, state,
                        batches: dict(steps=len(batches), idle_share=None))
    # The small student's bf16 chain is 7-13% of the logit spread from its
    # float32 one (few channels, a 1x1 last map the pool cannot average):
    # its served bf16 logits are held to 20% here, the card's full-width
    # student's to 5% (the float32 chain, held to 2% on both, is 2e-7).
    monkeypatch.setattr(chip_smoke, 'TRAIN_SERVE_BF16_REL_TOL', 0.2)
    monkeypatch.setattr(chip_smoke, 'launch_counts', lambda: next(counts))
    for name, value in (('synchronize', lambda *a: None),
                        ('is_available', lambda: True),
                        ('get_device_name', lambda *a: 'cpu'),
                        ('device_count', lambda: 1),
                        ('reset_peak_memory_stats', lambda *a: None),
                        ('max_memory_allocated', lambda *a: 0),
                        ('_sleep', lambda cycles: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    yield main


def test_chip_smoke_runs_end_to_end_on_cpu(rehearsal, capsys, tmp_path):
    report = tmp_path / 'report.json'
    assert chip_smoke.main(['--batch', '2', '--iters', '1',
                            '--report', str(report)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == 'CPU, 0 W'
    assert json.loads(lines[-1]) == {'ok': True, 'device': {
        'platform': 'gpu', 'kind': 'cpu', 'count': 1}}
    kernels = json.loads(next(ln for ln in lines
                              if ln.startswith('{"kernels"')))['kernels']
    assert {k['name'] for k in kernels} == {
        'xnor_conv2d', 'pack_sign_planes', 'max_pool_3x3_s2_p1',
        'xnor_gemm', 'xnor_conv2d_planes', *chip_smoke.PROBE_KERNELS}
    headline = phase_counts()[0]
    for k in kernels:
        assert KERNEL_KEYS <= set(k), k['name']
        assert k['max_abs_err'] == 0.0, k['name']
        on_main = k['name'] in ('xnor_conv2d', 'pack_sign_planes',
                                'max_pool_3x3_s2_p1')
        assert k['launches'] == (
            rehearsal[k['name']] if on_main else
            headline[k['name']] if k['name'] == 'xnor_conv2d_planes' else
            1 if k['name'] in chip_smoke.PROBE_KERNELS else 0)
    assert headline['xnor_conv2d_planes'] == 8
    # One multi-plane row for each phase that launches the kernel, with
    # the registers and blocks an SM of the instance it takes; a library
    # yardstick only where one pair of scale groups makes the function
    # one conv (ls-T x ls-1).
    planes = {k['phase']: k for k in kernels
              if k['name'] == 'xnor_conv2d_planes'}
    assert list(planes) == [name for name, *_, per_conv in
                            chip_smoke.MODEL_PHASES
                            if 'xnor_conv2d_planes' in per_conv]
    assert len(planes) == 3 and chip_smoke.OFF_PHASE in planes
    for phase, k in planes.items():
        assert k['registers'] == 4 and k['blocks_per_sm'] == 3, phase
        assert (k['library_ms'] is None) == ('ls2' in phase), phase
    conv = next(k for k in kernels if k['name'] == 'xnor_conv2d')
    assert conv['registers'] == 0 and conv['blocks_per_sm'] == 3
    # The producer's row is the main path's (k = 1); the headline phase's
    # k = 2 run stands beside it.
    pack = next(k for k in kernels if k['name'] == 'pack_sign_planes')
    assert pack['model_phase']['phase'] == chip_smoke.MODEL_PHASES[0][0]
    assert pack['model_phase']['launches'] == headline['pack_sign_planes']
    assert {'ms', 'plain_ms', 'bound_ms', 'bound_by'} <= set(
        pack['model_phase'])
    for name, *_ in chip_smoke.MODEL_PHASES:
        assert any(ln.startswith(f'{name}: ') and 'img/s' in ln
                   for ln in lines), name
    assert any(ln.startswith('serving resnet18_xnor_lsT_ls1: ')
               for ln in lines)
    assert any(ln.startswith('16 captured convs') for ln in lines)
    assert "'torch.bfloat16': [2, 4, 8, 16], 'torch.float32': [4, 8, 16]" \
        in next(ln for ln in lines if ln.startswith('pool routes checked'))
    add = next(k for k in kernels if k['name'] == 'add_f32')
    assert add['bandwidth']['shape'] == [64, 36]
    assert {'ms', 'library_ms', 'bound_ms'} <= set(add['bandwidth'])
    assert add['empty_launch_ms'] == 1.0
    report = json.loads(report.read_text())
    phases = {p['name']: p for p in report['model_phases']}
    # The recipes' models serve per-batch scales as written, then
    # calibrated EMA scales, card and CPU alike (here both the CPU).
    assert not hasattr(chip_smoke, 'RECIPE_CHANGES')
    for name in ('resnet50_regular_bottleneck_ls2_ls1', 'lenet5_ls2_ls1',
                 chip_smoke.OFF_PHASE):
        assert phases[name]['moving_average_mode'] == 'off', name
    solves = phases[chip_smoke.OFF_PHASE]['solves']
    assert solves['convs'] == 8
    for rows in ('bf16_rows', 'f32_rows'):
        assert solves[rows]['v1_max_rel_err'] == 0.0
        assert solves[rows]['rows_past_tol'] == 0
    assert [r['model'] for r in report['recipes']] == ['resnet50', 'lenet']
    for r in report['recipes']:
        assert r['ema_max_rel_err'] == 0.0 and r['quantizers'] > 0
        assert r['serving']['requests'] == 16
    train = report['train']
    assert [c['name'] for c in train['configs']] == list(
        chip_smoke.TRAIN_CONFIGS)
    lines_train = [json.loads(ln)['train_phase'] for ln in lines
                   if ln.startswith('{"train_phase"')]
    assert lines_train == train['configs']
    for c in train['configs']:
        assert len(c['losses']) == chip_smoke.TRAIN_STEPS
        assert c['losses'][-1] < c['losses'][0]
        assert set(c['split_ms']) == {'forward', 'teacher', 'backward',
                                      'optimizer'}
        assert c['batch'] == 2 and c['images_per_s'] > 0
        assert c['launches'] == {'max_pool_3x3_s2_p1': 10}
    cpu = train['against_cpu']
    assert cpu['loss_rel_err'] == cpu['grad_rel_err'] == 0.0
    assert cpu['grad_median_leaf_err'] == cpu['grad_worst_leaf_err'] == 0.0
    assert cpu['grad_leaves'] > 40
    assert train['remat']['state_equal'] and train['remat'][
        'loss_rel_err'] == 0.0
    assert train['eval']['launches'] == {'max_pool_3x3_s2_p1': 2}
    assert train['serve']['launches'] == {
        'xnor_conv2d': 8, 'pack_sign_planes': 8, 'max_pool_3x3_s2_p1': 1}
    assert train['serve']['fp32_rel_err'] < 1e-5
    experiment = report['experiment']
    assert [json.loads(ln)['experiment_phase'] for ln in lines
            if ln.startswith('{"experiment_phase"')] == [experiment]
    mnist = experiment['mnist']
    assert mnist['restored_eval_rel_err'] == 0.0
    assert len(mnist['test_metrics']) == 2 and mnist['steps_per_epoch'] == 2
    assert mnist['ms_per_step_loader'] > 0 and mnist[
        'ms_per_step_fixed_batch'] > 0
    runs = experiment['imagenet']['runs']
    assert runs['teacher']['launches'] == {'max_pool_3x3_s2_p1': 1}
    assert runs['student']['launches'] == {'max_pool_3x3_s2_p1': 3}
    assert runs['student']['ms_per_step_fixed_batch'] == train['configs'][
        0]['ms_per_step']
    assert experiment['imagenet']['teacher_equal']
    for served, per_forward in (
            (mnist['serving'], {'xnor_conv2d': 1, 'pack_sign_planes': 1}),
            (experiment['imagenet']['serving'], SMALL_SERVED)):
        assert served['launches_per_forward'] == per_forward
        assert served['requests'] == 16 and served['exit_codes'] == [0]
        assert served['cpu_max_abs_err'] == served['worker_max_abs_err'] == 0
        assert served['worker_tf32_vs_off_max_abs_err'] == 0
        assert served['worker_startup_s'] > 0
    stack = report['serving_stack']
    assert stack['frontend']['batches'] == 2
    assert stack['frontend']['launches'] == {
        'xnor_conv2d': 32, 'pack_sign_planes': 32, 'max_pool_3x3_s2_p1': 2}
    workers = stack['workers']
    assert workers['requests'] == 4 and workers['startup_s'] > 0
    assert workers['failover']['alive'] == [False, True]
    assert workers['failover']['failed_requests'] >= 2
    assert workers['exit_codes'] == [-9, 0]
    for key in ('latency_ms', 'client_latency_ms'):
        assert {'p50', 'p99'} <= set(workers[key])
        assert {'p50', 'p99'} <= set(stack['frontend'][key])


def test_build_report_names_each_kernel():
    """nvcc's -Xptxas -v report parsed into registers and spills a
    kernel, its name demangled with the template arguments."""
    ns = '_ZN39_GLOBAL__N__617c4668_7_xnor_cu_bfe1ff4b'
    planes = (f'{ns}25xnor_conv2d_planes_kernelI13__nv_bfloat16Li1ELi2ELi1E'
              'EEvPKjS3_PKfS5_PKT_PS6_NS_9ConvShapeENS_10PlaneShapeE')
    log = '\n'.join([
        f"ptxas info    : Compiling entry function '{planes}' for 'sm_90a'",
        f'ptxas info    : Function properties for {planes}',
        '    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads',
        'ptxas info    : Used 168 registers, used 1 barriers',
        f'ptxas info    : Function properties for {ns}18xnor_conv2d_kernelIf'
        'EEvPKjS2_PKfS4_PKT_PS5_NS_9ConvShapeE',
        '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        'ptxas info    : Used 150 registers, used 1 barriers',
        f'ptxas info    : Function properties for {ns}16xnor_gemm_kernelEPKj',
        '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        'ptxas info    : Used 128 registers'])
    assert chip_smoke.kernel_resources(log) == {
        'xnor_conv2d_planes_kernel<bf16,1,2,1>': dict(
            spill_stores=8, spill_loads=12, registers=168),
        'xnor_conv2d_kernel<f32>': dict(spill_stores=0, spill_loads=0,
                                        registers=150),
        'xnor_gemm_kernel': dict(spill_stores=0, spill_loads=0,
                                 registers=128)}
    assert chip_smoke.kernel_name('_Z3fooi') == '_Z3fooi'
