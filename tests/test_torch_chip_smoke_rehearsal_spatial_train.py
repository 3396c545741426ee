"""chip_smoke.py's spatial train phase rehearsed on the CPU
(tests/torch_rehearsal.py): small_config's KD pair banded over 'space'
at 64 px in a world of 2 on gloo, its gates and controls, remat on and
off, and the trained state served banded; and the launches and kernel
errors this path gives the kernels line."""

import pytest

import json

import chip_smoke
from tests import torch_rehearsal as R


def test_spatial_train_phase_runs_on_cpu(monkeypatch, capsys):
    R.patch(monkeypatch, [])
    st = chip_smoke.spatial_train_phase(0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)['spatial_train_phase'] for ln in lines
            if ln.startswith('{"spatial_train_phase"')] == [st]
    assert set(st['gates']) == {*chip_smoke.SPACE_STEP_CASES,
                                *(f'{c} remat'
                                  for c in chip_smoke.SPACE_STEP_CASES),
                                'control_input'}
    for recs in st['gates'].values():
        for rec in recs:
            # On the CPU a band's other float32 order stays within the
            # 1e-5 that tests/test_torch_port_spatial_train.py holds; the
            # card's gate is SPACE_STEP_GRAD_TOL.
            assert rec['grad_rel_err'] <= 1e-5
            assert chip_smoke._space_gate_ok(rec)
            # cuDNN off changes nothing on the CPU: no floor.
            assert rec['floor_grad_rel_err'] == 0.0
    assert set(st['controls']) == set(chip_smoke.SPACE_CONTROLS)
    assert min(st['controls'].values()) > chip_smoke.SPACE_CONTROL_MIN_DIFF
    kd = st['kd']
    assert len(kd['losses']) == 2 and max(kd['loss_rel_err']) < 1e-5
    assert kd['captured'] == {'max_pool_3x3_s2_p1': 0.0}
    assert kd['calls'] == [{'max_pool_3x3_s2_p1 pad_top=1': 1},
                           {'max_pool_3x3_s2_p1 pad_top=0': 1}]
    assert len(kd['flips'][0]) == 8
    for kinds in kd['collectives']:
        assert {'halo', 'statistics', 'solves', 'average pool',
                'gradient sum'} <= set(kinds)
    assert set(kd['split_ms'][0]) == {'forward', 'teacher', 'backward',
                                      'optimizer'}
    remat = st['remat']
    assert remat['config'] == chip_smoke.SPACE_REMAT_CONFIG
    for equal in remat['equal']:
        assert equal == {'losses': True, 'grad_digests': True,
                         'digests': True}
    assert len(remat['losses']) == 2
    assert remat['single_losses']['on'] == remat['single_losses']['off']
    # A step's stem pool (the teacher's) and the lloyd solves of the
    # small student's 8 convs, again in the recomputation.
    assert remat['per_step'] == {
        'on': [{'max_pool_3x3_s2_p1': 1, 'lloyd_solve_rows': 16}] * 2,
        'off': [{'max_pool_3x3_s2_p1': 1, 'lloyd_solve_rows': 8}] * 2}
    assert remat['captured'] == {'max_pool_3x3_s2_p1': 0.0}
    # The recomputation re-issues halos, statistics and the ls-2 solves'
    # gathers, equally on both ranks; remat off recomputes nothing, and
    # the forward's and backward's collectives are the same either way.
    on, off = remat['recomputed']['on'], remat['recomputed']['off']
    assert set(on[0]) == {'halo', 'statistics', 'solves'} and off == [{}, {}]
    assert [{k: v['count'] for k, v in r.items()} for r in on] == [
        {k: v['count'] for k, v in on[0].items()}] * 2
    assert remat['collectives']['on'] == remat['collectives']['off']
    assert set(remat['single_ms_per_step']) == {'on', 'off'}
    assert [t['remat'] for t in remat['rounds'][1]] == ['on', 'off']
    served = remat['serve']
    assert served['per_forward'] == [R.SMALL_REMAT_SERVE] * 2
    assert set(served['captured'].values()) == {0.0}
    assert served['calls'][0]['xnor_conv2d_planes pad_top=1'] == 8
    assert served['calls'][1]['xnor_conv2d_planes pad_top=0'] == 8
    assert served['calls'][0]['pack_sign_planes k=2'] == 8
    assert served['f32_max_abs_err'] <= chip_smoke.TP_F32_TOL['atol']
    assert st['evaluate']['max_abs_err'] <= chip_smoke.TP_F32_TOL['atol']
    assert st['evaluate']['metrics']['Loss'] == pytest.approx(
        st['evaluate']['whole_metrics']['Loss'], rel=1e-6)
    # A rank's launches a banded train step (the frozen teacher's pool)
    # and a served banded forward of the state trained with remat.
    paths = chip_smoke.path_launches(None, None, None, None, st)
    assert paths['space_train_launches'] == {'max_pool_3x3_s2_p1': 1}
    assert paths['space_remat_launches'] == R.SMALL_REMAT_SERVE
    assert set(chip_smoke.path_errs(None, None, st).values()) == {0.0}
