"""chip_smoke.py's tensor-parallel phase rehearsed on the CPU
(tests/torch_rehearsal.py): the ring GEMM, the TP-served small ResNet,
the TP step and the MNIST recipe at tensor_parallel 2, each world of 2
on gloo; and the launches and kernel errors this path gives the kernels
line."""

import json

import chip_smoke
from tests import torch_rehearsal as R


def test_tp_phase_runs_on_cpu(monkeypatch, capsys):
    R.patch(monkeypatch, [])
    tp = chip_smoke.tp_phase(0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)['tp_phase'] for ln in lines
            if ln.startswith('{"tp_phase"')] == [tp]
    assert tp['ring']['max_abs_err'] == 0.0
    assert tp['ring']['launches_per_rank'] == [{'xnor_gemm': 2}] * 2
    serving = tp['serving']
    assert serving['per_forward'] == [R.SMALL_SERVED_TP] * 2
    assert serving['forwards'][0] == serving['forwards'][1] > 1
    assert serving['conv_out_channels'] == [4, 8, 16, 32]
    assert set(serving['captured'].values()) == {0.0}
    assert serving['f32_max_abs_err'] == serving['bf16_max_abs_err'] == 0.0
    assert serving['stats'] == {'requests': 2, 'batches': 1}
    step = tp['step']
    assert set(step['cases']) == set(chip_smoke.TP_STEP_CASES)
    assert all(r['worst_excess'] == 0.0 for r in step['cases'].values())
    # The CPU's sums agree: the binary-activation case is within the step
    # tolerance here; the card measures it without a gate.
    assert step['flip_case']['case'] == chip_smoke.TP_FLIP_CASE
    assert step['flip_case']['max_abs_err'] < 1e-5
    assert step['summing_diff'] > chip_smoke.TP_SUMMING_MIN_DIFF
    pod_tp = tp['pod']
    assert set(pod_tp['loss_rel_err']) == {'train', 'test', 'tp2_restored',
                                           'tp2_at_tp1'}
    assert pod_tp['loss_rel_err']['tp2_restored'] == 0.0
    # The kernels line's TP field: a rank's launches a ring call (2
    # xnor_gemm, the kernel's only path) and a TP-served forward.
    paths = chip_smoke.path_launches(None, tp, None, None, None)
    assert paths['tp_launches'] == dict(R.SMALL_SERVED_TP,
                                        xnor_gemm=chip_smoke.TP_WORLD)
    assert set(chip_smoke.path_errs(tp, None, None).values()) == {0.0}
