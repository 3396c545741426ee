"""chip_smoke.py's experiment phase rehearsed on the CPU
(tests/torch_rehearsal.py): the MNIST recipe through the drivers and the
ImageNet KD pair, its student timed against the train phase's first
configuration (run here first, as main runs it). The pod phase within
it has its own file, tests/test_torch_chip_smoke_rehearsal_pod.py."""

import json

import chip_smoke
from tests import torch_rehearsal as R


def test_experiment_phase_runs_on_cpu(monkeypatch, capsys):
    R.patch(monkeypatch, [*R.TRAIN, *R.EXPERIMENT])
    R.leave_out(monkeypatch, 'pod_phase')
    first = chip_smoke.train_phases(0)['configs'][0]
    experiment = chip_smoke.experiment_phase(0, first)
    lines = capsys.readouterr().out.strip().splitlines()
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
    assert runs['student']['ms_per_step_fixed_batch'] == first['ms_per_step']
    assert experiment['imagenet']['teacher_equal']
    for served, per_forward in (
            (mnist['serving'], {'xnor_conv2d': 1, 'pack_sign_planes': 1}),
            (experiment['imagenet']['serving'], R.SMALL_SERVED)):
        assert served['launches_per_forward'] == per_forward
        assert served['requests'] == 16 and served['exit_codes'] == [0]
        assert served['cpu_max_abs_err'] == served['worker_max_abs_err'] == 0
        assert served['worker_cpu_max_abs_err'] == 0
        assert served['worker_startup_s'] > 0
    assert experiment['pod'] is None
