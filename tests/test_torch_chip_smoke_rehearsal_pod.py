"""chip_smoke.py's pod phase (inside the experiment phase) rehearsed on
the CPU (tests/torch_rehearsal.py): the DP step of DP_STEP_CASES at a
world of 2, the MNIST recipe through PodComputePlatform at worlds 1 and
2 and the preempted pod, each on gloo over the CPU."""

import chip_smoke
from tests import torch_rehearsal as R


def test_pod_phase_runs_on_cpu(monkeypatch, tmp_path):
    R.patch(monkeypatch, [])
    pod = chip_smoke.pod_phase(str(tmp_path), 0)
    assert [(w['world'], w['backend']) for w in pod['worlds']] == [
        (1, 'gloo'), (2, 'gloo')]
    for w in pod['worlds']:
        assert w['pod_s'] > 0 and w['single_process']['epoch_s'] > 0
        for part in ('train', 'test'):
            assert w['diffs'][part]['loss_rel_err'] <= chip_smoke.POD_LIMITS[
                w['world']][part][0]
    # A world of 1 is the single process's run.
    assert pod['worlds'][0]['train'] == pod['worlds'][0]['single_train']
    assert set(pod['default_cudnn_spread']) == {'train', 'test'}
    dp_step = pod['dp_step']
    assert set(dp_step['cases']) == set(chip_smoke.DP_STEP_CASES)
    for rec in dp_step['cases'].values():
        assert rec['worst_excess'] == 0.0
        assert rec['local_stats_diff'] > chip_smoke.DP_LOCAL_MIN_DIFF
    preempt = pod['preempt']
    assert 3 < preempt['interrupted_epoch'] < preempt['epochs']
    assert len(preempt['checkpoints']) == preempt['interrupted_epoch']
    assert preempt['ms_per_step'] > 0 and pod['single_process_ms_per_step'] > 0
