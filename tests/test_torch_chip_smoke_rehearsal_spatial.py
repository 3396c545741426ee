"""chip_smoke.py's spatial and pipeline phases rehearsed on the CPU
(tests/torch_rehearsal.py): the small ResNet banded over 'space' and its
kernel checks on bands, layer1's blocks as two pipeline stages, each
world of 2 on gloo; and the launches and kernel errors these paths give
the kernels line."""

import json

import chip_smoke
from tests import torch_rehearsal as R


def test_spatial_phase_runs_on_cpu(monkeypatch, capsys):
    R.patch(monkeypatch, [])
    space = chip_smoke.spatial_phase(0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)['spatial_phase'] for ln in lines
            if ln.startswith('{"spatial_phase"')] == [space]
    assert space['per_forward'] == [R.SMALL_SERVED_TP] * 2
    assert space['forwards'][0] == space['forwards'][1] > 1
    # At 32 px over two bands the stem, the pool and layer1-3 band;
    # layer4's stride does not divide its 1-row band: it runs whole.
    assert space['whole'] == ['layer4_block0.conv1',
                              'layer4_block0.shortcut.conv',
                              'layer4_block0.conv2']
    assert space['banded'][0] == 'conv1' and len(space['banded']) == 9
    assert set(space['captured'].values()) == {0.0}
    assert space['calls'][0]['xnor_conv2d pad_top=1'] == 6
    assert space['calls'][1]['xnor_conv2d pad_top=0'] == 6
    assert space['calls'][1]['max_pool_3x3_s2_p1 pad_top=0'] == 1
    assert space['halo_bytes'][0] > space['halo_bytes'][1] > 0
    assert space['f32_max_abs_err'] == space['bf16_max_abs_err'] == 0.0
    for kname, t in space['band_ms'].items():
        assert t['band_pad_top'] == [1, 0] and len(t['bands']) == 2, kname
    checks = space['band_checks']
    assert checks.pop('control_differ') > 0 and set(checks.values()) == {0.0}
    paths = chip_smoke.path_launches(None, None, space, None, None)
    assert paths['space_launches'] == R.SMALL_SERVED_TP
    assert set(chip_smoke.path_errs(None, space, None).values()) == {0.0}


def test_pipeline_phase_runs_on_cpu(monkeypatch, capsys):
    R.patch(monkeypatch, [])
    pipe = chip_smoke.pipeline_phase(0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)['pipeline_phase'] for ln in lines
            if ln.startswith('{"pipeline_phase"')] == [pipe]
    assert pipe['max_abs_err'] == 0.0 and pipe['shape'] == [2, 1, 8, 8, 8]
    assert pipe['eager_abs_err'] == 0.0  # the tails equal the eager ops
    assert pipe['per_microbatch'] == [{'xnor_conv2d': 2,
                                       'pack_sign_planes': 2,
                                       chip_smoke.TAIL: 2}] * 2
    assert pipe['step']['rel_err'] <= chip_smoke.PIPE_STEP_TOL
    assert pipe['step']['summing_diff'] > chip_smoke.PIPE_SUMMING_MIN_DIFF
    # 2 microbatches of 1 binary conv (with its tail) and 1 producer a
    # stage, 2 stages.
    paths = chip_smoke.path_launches(None, None, None, pipe, None)
    assert {k: v for k, v in paths['pipe_launches'].items() if v} == {
        'xnor_conv2d': 4, 'pack_sign_planes': 4, chip_smoke.TAIL: 4}
