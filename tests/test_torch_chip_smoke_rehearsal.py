"""chip_smoke.py rehearsed on the CPU at batch 2 (tests/torch_rehearsal.py):
main() end to end with the experiment (and its pod), TP, spatial,
pipeline and spatial train phases left out (torch_rehearsal.leave_out;
each has its own rehearsal file,
tests/test_torch_chip_smoke_rehearsal_*.py): the kernels against
their twins, the main path, the API phase, the serving stack, the model,
oracle, recipe and train phases, the probe path, the kernels line and
the last line; and the build report's parser.
"""

import json

import chip_smoke
from tests import torch_rehearsal as R

# The phase functions left out, and the kernels line's fields of their
# paths.
LEFT_OUT = ('experiment_phase', 'tp_phase', 'spatial_phase',
            'pipeline_phase', 'spatial_train_phase')
SKIPPED_PATHS = ('tp_launches', 'space_launches', 'pipe_launches',
                 'space_train_launches', 'space_remat_launches')


def test_chip_smoke_runs_end_to_end_on_cpu(monkeypatch, capsys, tmp_path):
    """main() with the parallel and experiment phases left out (their
    own rehearsal files run them): every other phase, the kernels line
    and the last line."""
    R.patch(monkeypatch, [R.MAIN, *R.API, R.FRONTEND, *R.phase_counts(),
                          *R.LLOYD, *R.ORACLE, *R.TRAIN, R.PROBE])
    R.leave_out(monkeypatch, *LEFT_OUT)
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
    headline = R.phase_counts()[0]
    for k in kernels:
        assert R.KERNEL_KEYS <= set(k), k['name']
        assert k['max_abs_err'] == 0.0, k['name']
        on_main = k['name'] in ('xnor_conv2d', 'pack_sign_planes',
                                'max_pool_3x3_s2_p1')
        # xnor_gemm's one path is the TP phase's ring, left out here
        # (its launches: tests/test_torch_chip_smoke_rehearsal_tp.py).
        assert k['launches'] == (
            R.MAIN[k['name']] if on_main else
            headline[k['name']] if k['name'] == 'xnor_conv2d_planes' else
            1 if k['name'] in chip_smoke.PROBE_KERNELS else None)
        assert k['api_launches'] == chip_smoke.API_PER_FORWARD.get(
            k['name'], 0)
        # The paths of the phases left out read null: not measured.
        for key in SKIPPED_PATHS:
            assert k[key] is None, (k['name'], key)
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
    # The lloyd solve against its twin: here both the twin.
    lloyd = solves['lloyd']
    assert lloyd['batch'] == chip_smoke.LLOYD_BATCH and lloyd['convs'] == 8
    assert set(lloyd['checks']) == {'bf16_ls-2', 'bf16_ls-T', 'f32_ls-2',
                                    'f32_ls-T'}
    for check in lloyd['checks'].values():
        assert check == dict(v1_max_rel_err=0.0, rows_past_tol=0,
                             v2_max_rel_err=0.0)
    for timed in lloyd['timed'].values():
        assert timed['launches'] == 8 and timed['bound_ms'] > 0
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
    for c, counts in zip(train['configs'], R.TRAIN):
        assert len(c['losses']) == chip_smoke.TRAIN_STEPS
        assert c['losses'][-1] < c['losses'][0]
        assert set(c['split_ms']) == {'forward', 'teacher', 'backward',
                                      'optimizer'}
        assert c['batch'] == 2 and c['images_per_s'] > 0
        assert c['launches'] == {k: v for k, v in counts.items() if v}
    cpu = train['against_cpu']
    assert cpu['loss_rel_err'] == cpu['grad_rel_err'] == 0.0
    assert cpu['grad_median_leaf_err'] == cpu['grad_worst_leaf_err'] == 0.0
    assert cpu['grad_leaves'] > 40
    assert train['remat']['state_equal'] and train['remat'][
        'loss_rel_err'] == 0.0
    assert train['eval']['launches'] == {'max_pool_3x3_s2_p1': 2}
    assert train['serve']['launches'] == {
        'xnor_conv2d': 8, 'pack_sign_planes': 8, 'max_pool_3x3_s2_p1': 1,
        chip_smoke.TAIL: 8}
    assert train['serve']['fp32_rel_err'] < 1e-5
    tail = report['tail']
    assert [json.loads(ln)['tail_phase'] for ln in lines
            if ln.startswith('{"tail_phase"')] == [tail]
    assert tail['batch'] == 2
    for name, (*_, tails) in R.SMALL_TAIL_MODELS.items():
        for rec in tail[name].values():
            # The CPU's convs run their plain twins: no tail launches.
            assert rec == dict(tails=tails, tail_launches=0, eager_tails=0,
                               bit_equal=True, max_abs_err=0.0), (name, rec)
    oracle = report['oracle']
    assert [(r['oracle'], r['mode'], r['sign_compute'], r['launches'])
            for r in oracle['runs']] == [
                (n, m, s, w) for n, m, s, w in chip_smoke.ORACLE_RUNS]
    for r in oracle['runs']:
        assert r['argmax_equal'] and r['held_to'] == 'reference', r
        if r['mode'] == 'dense':
            assert r['max_abs_err'] <= chip_smoke.ORACLE_DENSE_TOL
            assert r['cpu_max_abs_err'] == 0
        if r['launches']:
            assert set(r['captured'].values()) == {0.0}
            assert set(r['captured']) == set(r['launches'])
    assert oracle['round_trip']['resnet']['keys'] == 100
    assert oracle['round_trip']['lenet']['keys'] == 18
    stack = report['serving_stack']
    assert stack['frontend']['batches'] == 2
    assert stack['frontend']['launches'] == {
        'xnor_conv2d': 32, 'pack_sign_planes': 32, 'max_pool_3x3_s2_p1': 2,
        chip_smoke.TAIL: 32}
    workers = stack['workers']
    assert workers['requests'] == 4 and workers['startup_s'] > 0
    assert workers['failover']['alive'] == [False, True]
    assert workers['failover']['failed_requests'] >= 2
    assert workers['exit_codes'] == [-9, 0]
    for key in ('latency_ms', 'client_latency_ms'):
        assert {'p50', 'p99'} <= set(workers[key])
        assert {'p50', 'p99'} <= set(stack['frontend'][key])
    for name in ('experiment', 'tp', 'spatial', 'pipeline',
                 'spatial_train'):
        assert report[name] is None, name
    api = report['api']
    assert [json.loads(ln)['api_phase'] for ln in lines
            if ln.startswith('{"api_phase"')] == [api]
    assert api['per_forward'] == chip_smoke.API_PER_FORWARD
    assert api['max_abs_err'] == 0.0
    assert api['serving']['requests'] == 16
    assert api['serving']['batches'] == 1
    assert api['serving']['max_abs_err'] <= 1e-6
    assert [g['x_quant'] for g in api['grouped']] == ['ls-1', 'fp']
    for g in api['grouped']:
        # Card and CPU are one CPU here: the step and eval agree exactly.
        assert g['loss_rel_err'] == g['grad_rel_err'] == 0.0
        assert g['state_excess'] == g['eval_rel_err'] == 0.0
        assert g['state_worst'] is None and g['state_rel_err'] == 0.0
        assert g['eval_launches'] == {}
        assert g['inference_mode'] == ['packed', 'packed']
        assert g['groups'] == [2, chip_smoke.API_GROUPED['channels']]
    assert api['serving_import'] == dict(
        libraries=[], processes=[], sockets=0, process_group=False,
        modules=[], engine='quant_tpu_torch.serving.engine')


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
