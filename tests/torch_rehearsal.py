"""The CPU rehearsal of chip_smoke.py, shared by the
tests/test_torch_chip_smoke_rehearsal_*.py files.

chip_smoke.py runs only on a CUDA card. Here its phases run with the
device set to the CPU, where every kernel wrapper takes its plain twin:
nvcc, the card's name, CUDA events and the launch counters (which only
a CUDA launch bumps) are stood in for, the probe path is cut to toy
sizes, the serving stack to 4 requests with its worker processes
serving the 'lenet_random' spec on the CPU, and the model and recipe
phases to small models, the train phase to small models at batch 2,
the experiment phase to a small MNIST (LeNet-5 at the recipe's widths)
and to small ResNets at 32 px on 8 synthetic images, its torch.profiler
reading (which needs the card's kernels) stood in for, and its pod to a
smaller MNIST, its worlds on gloo over the CPU, and the TP phase to a
small ring GEMM, the small XNOR ResNet served at batch 2 and a smaller
MNIST, its world of 2 on gloo over the CPU, and the spatial and pipeline
phases to that model (banded at 32 px; its layer1 block as both stages
at 2 microbatches of 1 image) and their kernel checks to small bands,
their worlds of 2 on gloo over the CPU, and the spatial train phase to
small_config's KD pair at 64 px and batch 2 in such a world. The oracle
and API phases run as on the card (the oracles are small; the API
phase's ResNet-18 at batch 2), their launch counts stood in for. That
catches Python-level breakage of the script (arguments, shapes, the
phases' control flow, the report's keys) before a run on the card.

Each rehearsal file drives some phases: `patch(monkeypatch, counts)`
applies the stand-ins, with `counts` the launch counts that the patched
`chip_smoke.launch_counts` returns, in the order the phases read them;
`leave_out(monkeypatch, *names)` stands a phase function in by one that
returns None, as a phase that did not run (another file drives it).
"""

import time

import torch

import chip_smoke
from quant_tpu_torch import _build
from quant_tpu_torch.ops import optimal, pool
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


# The tail phase's models cut to small_config's XNOR families (one block
# a stage): 8 and 12 binary convs, each with its block's tail.
SMALL_TAIL_MODELS = {
    'resnet18_xnor_ls1': (lambda xq, wq, **kw: models.build(
        'xnor', models.small_config('xnor', xq, wq), **kw), 'ls-1', 'ls-1',
        {}, 8),
    'resnet50_xnor_ls2_ls1': (lambda xq, wq, **kw: models.build(
        'xnor_bottleneck', models.small_config('xnor_bottleneck', xq, wq),
        **kw), 'ls-2', 'ls-1', {'sign_compute': 'int8'}, 12)}


def phase_counts() -> list[dict]:
    """The launch counts each model phase expects of its small model."""
    out = []
    for _, build, _, _, _, per_conv in chip_smoke.MODEL_PHASES:
        _, _, convs, pools = SMALL_MODELS[build]
        want = {k: 0 for k in chip_smoke.KERNELS}
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


def tp_launches(got: dict, calls: int, per_call: dict) -> dict:
    """The CPU ranks of the TP phase launch no kernel: their counts stay
    0; the card's per-call counts are taken as expected."""
    assert calls > 0 and set(per_call) <= set(got), (got, per_call)
    assert not any(got.values()), got
    return dict(per_call)


# The TP phase's served model: small_config's XNOR ResNet at 32 px.
SMALL_SERVED_TP = {'xnor_conv2d': 8, 'pack_sign_planes': 8,
                   'max_pool_3x3_s2_p1': 1}
SMALL_TP_SERVING = dict(model='small', batch=2, input=[32, 32, 3],
                        classes=10, per_forward=SMALL_SERVED_TP)


# The spatial train phase's pair narrowed to small_config's ResNets at
# 64 px (every block bands over 2 ranks, the controls' input too), batch
# 2, one warm-up step and one timed step, 4 images evaluated; its remat
# part takes one round each way, and the state it trains serves 8
# binary convs a forward.
SMALL_SPACE_TRAIN = dict(model='small', batch=2, input=[64, 64, 3],
                         control_input=[64, 64, 3], classes=10, warmup=1,
                         steps=1, eval_images=4)
SMALL_REMAT_SERVE = {'xnor_conv2d_planes': 8, 'pack_sign_planes': 8,
                     'max_pool_3x3_s2_p1': 1, 'lloyd_solve_rows': 8}


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
                chip_smoke.TAIL: 8, 'max_pool_3x3_s2_p1': 1}


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



# The launch counts the phases read, in order. The main path: 16 binary
# convs, each with its block's tail, 16 producers, 1 pool a forward; the
# probe path one of each probe kernel beside them.
IDLE = {k: 0 for k in chip_smoke.KERNELS}
MAIN = dict(IDLE, xnor_conv2d=16, pack_sign_planes=16,
            max_pool_3x3_s2_p1=1, **{chip_smoke.TAIL: 16})
PROBE = dict(MAIN, **{k: 1 for k in chip_smoke.PROBE_KERNELS})
# The API phase: the package-level model's forward, then each grouped
# block's eval forward (the dense path: nothing).
API = [MAIN, *[IDLE] * len(chip_smoke.API_GROUPED['x_quants'])]
# The in-process frontend serves its 4 requests as 2 batches of 2.
FRONTEND = dict(MAIN, xnor_conv2d=32, pack_sign_planes=32,
                max_pool_3x3_s2_p1=2, **{chip_smoke.TAIL: 32})
# OFF_PHASE's lloyd solves (lloyd_phase): one of each of the small
# model's 8 conv inputs in bf16, then in float32.
LLOYD = [dict(IDLE, lloyd_solve_rows=8)] * 2
# The train phase: each configuration's 10 timed steps launch the
# teacher's pool once a step, and the TPU recipe's the lloyd solve of
# each of the small student's 8 convs twice a step (remat); the eval
# step's 2 batches the pool only; the served small student (8 binary
# convs) one forward.
TRAIN = [*[dict(IDLE, max_pool_3x3_s2_p1=10)] * 2,
         dict(IDLE, max_pool_3x3_s2_p1=10, lloyd_solve_rows=160),
         dict(IDLE, max_pool_3x3_s2_p1=2),
         dict(IDLE, xnor_conv2d=8, pack_sign_planes=8,
              max_pool_3x3_s2_p1=1, **{chip_smoke.TAIL: 8})]
# The experiment phase: the LeNet-5 artifact's forward, the teacher's
# run (its eval's pool), the KD student's run (2 steps of the frozen
# teacher, 1 eval batch), the small ResNet artifact's forward.
EXPERIMENT = [dict(IDLE, xnor_conv2d=1, pack_sign_planes=1),
              dict(IDLE, max_pool_3x3_s2_p1=1),
              dict(IDLE, max_pool_3x3_s2_p1=3), dict(IDLE, **SMALL_SERVED)]
ORACLE = [want for *_, want in chip_smoke.ORACLE_RUNS]


THREADS = 2


class _Threads:
    """torch's intra-op thread count as an attribute, which monkeypatch
    sets and puts back."""

    @property
    def count(self) -> int:
        return torch.get_num_threads()

    @count.setter
    def count(self, n: int) -> None:
        torch.set_num_threads(n)


_THREADS = _Threads()


def patch(monkeypatch, counts: list) -> None:
    """chip_smoke on the CPU (module docstring); `counts` are the launch
    counts chip_smoke.launch_counts returns, one a call, in order."""
    counts = iter(counts)
    # This process and those the phases start (serving workers, pods,
    # gloo ranks) take THREADS threads each: several rehearsal files run
    # at once under xdist, where processes of all cores each only
    # contend; and one count on both sides, since the phases hold a
    # worker's results to this process's bit for bit.
    monkeypatch.setattr(_THREADS, 'count', THREADS)
    monkeypatch.setenv('OMP_NUM_THREADS', str(THREADS))
    monkeypatch.setattr(chip_smoke, 'PHASE_MODELS', SMALL_MODELS)
    monkeypatch.setattr(chip_smoke, 'TAIL_MODELS', SMALL_TAIL_MODELS)
    monkeypatch.setattr(chip_smoke, 'TAIL_INPUT', (32, 32, 3))
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
    monkeypatch.setattr(optimal, 'lloyd_solve_layout',
                        lambda dtype, rows, n, skip=3: dict.fromkeys(
                            optimal.LAYOUT_KEYS, 0))
    monkeypatch.setattr(_build, 'build', lambda verbose=False: {})
    monkeypatch.setattr(chip_smoke, 'TRAIN_MODELS', (
        small_family('xnor'), small_family('regular'), (32, 32, 3), 10))
    for name in ('TRAIN_BATCH', 'TRAIN_CHECK_BATCH', 'REMAT_CHECK_BATCH',
                 'TRAIN_SERVE_BATCH'):
        monkeypatch.setattr(chip_smoke, name, 2)
    monkeypatch.setattr(chip_smoke, 'cuda_event', HostEvent)
    monkeypatch.setattr(chip_smoke, 'EXPERIMENT_MNIST', dict(
        chip_smoke.EXPERIMENT_MNIST, train=128, test=64))
    monkeypatch.setattr(chip_smoke, 'POD_MNIST', dict(
        chip_smoke.POD_MNIST, train=256, test=64))
    imagenet = chip_smoke.EXPERIMENT_IMAGENET
    monkeypatch.setattr(chip_smoke, 'EXPERIMENT_IMAGENET', dict(
        imagenet, per_forward=SMALL_SERVED, data=dict(
            imagenet['data'], image_shape=[32, 32, 3], num_classes=10,
            train_size=8, test_size=4)))
    monkeypatch.setattr(chip_smoke, 'EXPERIMENT_OVERRIDES', {
        imagenet['teacher']: SMALL_RECIPE, imagenet['student']: SMALL_RECIPE})
    monkeypatch.setattr(chip_smoke, 'loader_profile', lambda step, state,
                        batches: dict(steps=len(batches), idle_share=None))
    monkeypatch.setattr(chip_smoke, 'TP_RING_SHAPE', (64, 256, 32))
    monkeypatch.setattr(chip_smoke, 'TP_SERVING', SMALL_TP_SERVING)
    monkeypatch.setattr(chip_smoke, 'TP_ITERS', 1)
    monkeypatch.setattr(chip_smoke, 'TP_POD_MNIST', dict(
        chip_smoke.TP_POD_MNIST, test=64))
    monkeypatch.setattr(chip_smoke, '_tp_launches', tp_launches)
    monkeypatch.setattr(chip_smoke, 'PAR_ITERS', 1)
    monkeypatch.setattr(chip_smoke, 'PIPE_MICROBATCHES', 2)
    monkeypatch.setattr(chip_smoke, 'BAND_CONVS', ((64, 8, 1), (64, 8, 2)))
    monkeypatch.setattr(chip_smoke, 'BAND_PLANES', (64, 8, 1))
    monkeypatch.setattr(chip_smoke, 'BAND_POOL_SHAPE', (2, 8, 8, 64))
    monkeypatch.setattr(chip_smoke, 'BAND_CHECK_BATCH', 2)
    monkeypatch.setattr(chip_smoke, 'SPACE_TRAIN', SMALL_SPACE_TRAIN)
    monkeypatch.setattr(chip_smoke, 'SPACE_REMAT_SERVE', SMALL_REMAT_SERVE)
    monkeypatch.setattr(chip_smoke, 'SPACE_REMAT_ROUNDS', ('on', 'off'))
    # On the CPU the MNIST recipe's 4 TP steps move its test loss by
    # 4.4e-3 from tp = 1 (tied max-pool windows after the binary conv2
    # break the other way under another float order), the card's 3.8e-4:
    # the rehearsal holds the test loss to 5e-2, the card to 2e-3.
    monkeypatch.setattr(chip_smoke, 'TP_POD_LIMITS', dict(
        chip_smoke.TP_POD_LIMITS, test=5e-2))
    # The small student's bf16 chain is 7-13% of the logit spread from its
    # float32 one (few channels, a 1x1 last map the pool cannot average):
    # its served bf16 logits are held to 20% here, the card's full-width
    # student's to 5% (the float32 chain, held to 2% on both, is 2e-7).
    monkeypatch.setattr(chip_smoke, 'TRAIN_SERVE_BF16_REL_TOL', 0.2)
    monkeypatch.setattr(chip_smoke, 'launch_counts',
                        lambda: dict(next(counts)))
    for name, value in (('synchronize', lambda *a: None),
                        ('is_available', lambda: True),
                        ('get_device_name', lambda *a: 'cpu'),
                        ('device_count', lambda: 1),
                        ('reset_peak_memory_stats', lambda *a: None),
                        ('max_memory_allocated', lambda *a: 0),
                        ('_sleep', lambda cycles: None)):
        monkeypatch.setattr(torch.cuda, name, value)


def leave_out(monkeypatch, *names: str) -> None:
    """chip_smoke's phase functions `names` return None: those phases
    do not run (main reads their paths' kernels-line fields as null)."""
    for name in names:
        monkeypatch.setattr(chip_smoke, name, lambda *args, **kw: None)
