"""The train configurations of the ImageNet KD recipes, and where the
time of their train step goes on the card.

`CONFIGS` are the three configurations chip_smoke.py's train phase
trains; `build`, `make_state` and `make_step` give their student and
teacher, train state and KD train step. Run as a module, it takes
warm-up steps of each, records `steps` train steps under torch.profiler
and prints one JSON line a configuration: the card's kernel time a step
by class (convolutions, GEMMs, elementwise, reductions, sorts, copies,
the optimizer, other), the top kernels, and the step's time back to
back (CUDA events) beside it, so the card's idle share shows, and the
host's top operators by their own time.

With `--space P` the step runs banded over P gloo ranks on the card
(parallel.band_model, the teacher too; one process a rank, launched by
this one), as chip_smoke.py's spatial train phase runs it; rank 0 is
profiled and prints. `--remat on|off` overrides the configuration's
remat.

Usage: python -m quant_tpu_torch.probes.train_profile [--config NAME]
           [--batch 256] [--steps 3] [--top 12] [--out PATH]
           [--space P] [--remat on|off]
"""

import argparse
import contextlib
import functools
import json
import os
import re
import socket
import subprocess
import sys
from typing import Any, Callable, Optional

import numpy as np
import torch

from quant_tpu_torch import train as T
from quant_tpu_torch.probes import models
from quant_tpu_torch.train.kd import make_teacher_apply
from quant_tpu_torch.train.metrics import init_metric_state

# The student of examples/imagenet/imagenet_ls1_kd.yaml at full width
# (bench_resnet18: ResNet-18, XNOR blocks, 224 px, 1000 classes) with
# moving_average_mode 'off', and a frozen regular fp ResNet-18 teacher
# in train mode (imagenet_teacher, imagenet_fp.yaml), both seeded: the
# teacher's checkpoint is not in the repo. name: (recipe, x_quant,
# w_quant, student options, the teacher's dtype).
CONFIGS = {
    'ls1_kd': ('examples/imagenet/imagenet_ls1_kd.yaml', 'ls-1', 'ls-1',
               {}, None),
    'ls1_kd_bf16_remat': (
        'examples/imagenet/imagenet_ls1_kd.yaml with the TPU recipe\'s '
        'train_dtype, remat and teacher_dtype', 'ls-1', 'ls-1',
        {'train_dtype': 'bfloat16', 'remat': True}, 'bfloat16'),
    'ls2_ls1_kd_tpu': (
        'examples/imagenet/imagenet_ls1_weight_ls2_activation_kd_tpu.yaml',
        'ls-2', 'ls-1', {'train_dtype': 'bfloat16', 'remat': True,
                         'solver_mode': 'lloyd'}, 'bfloat16'),
}
# Adam lr 2e-4 under linear_lr to 2e-7 over 240 epochs of ImageNet's
# 5,005 batches of 256; pure KD at temperature 1.
OPTIMIZATION = {
    'optimizer': {'algorithm': 'adam', 'lr': 2e-4, 'weight_decay': 0},
    'lr_scheduler': {'scheduler': 'linear_lr', 'min_lr': 2e-7}}
EPOCHS, STEPS_PER_EPOCH = 240, 5005
KD = dict(temperature=1.0, teacher_correction=False)
# Kernel classes by name, first match wins.
CLASSES = (
    ('optimizer', r'adam|multi_tensor|foreach'),
    ('conv', r'conv|cudnn|xmma|implicit|wgrad|dgrad|fprop|winograd|fft'),
    ('gemm', r'gemm|cutlass|cublas|sm90_'),
    ('sort', r'sort|radix|scan'),
    ('reduction', r'reduce|norm|mean|sum'),
    ('copy', r'copy|Memcpy|Memset|cat|transpose|permute'),
    ('elementwise', r'elementwise|vectorized|unrolled|where|index'),
)


def kernel_class(name: str) -> str:
    for cls, pattern in CLASSES:
        if re.search(pattern, name, re.IGNORECASE):
            return cls
    return 'other'


def build(config: str, seed: int, device: str = 'cuda',
          make: Callable = models.bench_resnet18,
          teacher_make: Callable = models.imagenet_teacher,
          **overrides: Any) -> tuple[torch.nn.Module, torch.nn.Module]:
    """(student, teacher) of a configuration, each from torch's default
    init and probes.models.seed_state on the CPU, moved to `device`, in
    eval mode. `make` and `teacher_make` build them (x_quant, w_quant,
    **kwargs), as the recipes' builders; `overrides` replace the
    configuration's student options (e.g. remat=False)."""
    _, x_quant, w_quant, options, teacher_dtype = CONFIGS[config]
    student = models.seeded_model(
        make, x_quant, w_quant, 'cpu', seed, prepare=False,
        moving_average_mode='off', inference_mode='dense',
        **{**options, **overrides})
    dt = ({'train_dtype': teacher_dtype, 'eval_dtype': teacher_dtype}
          if teacher_dtype else {})
    teacher = models.seeded_model(
        teacher_make, 'fp', 'fp', 'cpu', seed + 1000, prepare=False,
        moving_average_mode='off', inference_mode='dense', **dt)
    return student.to(device), teacher.to(device)


def make_state(student: torch.nn.Module) -> T.TrainState:
    """The recipes' optimizer over the student, at step 0."""
    spec, _ = T.make_optimizer(OPTIMIZATION, EPOCHS, STEPS_PER_EPOCH)
    return T.TrainState.create(student, spec)


def make_step(teacher: torch.nn.Module,
              phase_hook: Optional[Callable[[str], None]] = None,
              mesh: Any = None) -> Callable:
    """The KD train step against the frozen teacher in train mode; over
    `mesh` where given (make_train_step's)."""
    return T.make_train_step(functools.partial(T.kd_criterion, **KD),
                             make_teacher_apply(teacher, train_mode=True),
                             phase_hook=phase_hook, mesh=mesh)


def profile(config: str, batch: int, steps: int, top: int, seed: int = 0,
            warmup: int = 2, mesh: Any = None,
            **overrides: Any) -> Optional[dict[str, Any]]:
    """Profile `steps` train steps of `config` at `batch` on the card;
    banded over `mesh` (this rank's band; every rank steps, rank 0 is
    profiled and the others return None)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from quant_tpu_torch.parallel import band_model, local_band

    student, teacher = build(config, seed, **overrides)
    if mesh is not None:
        band_model(student, mesh)
        band_model(teacher, mesh)
    state, step = make_state(student), make_step(teacher, mesh=mesh)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (batch, 224, 224, 3), dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, batch)).cuda()
    if mesh is not None:
        x = local_band(x, mesh)
    leader = mesh is None or mesh.get_local_rank() == 0
    metric = init_metric_state()
    for _ in range(warmup):
        step(state, x, y, metric)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with (torch_profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) if leader
          else contextlib.nullcontext()) as prof:
        start.record()
        for _ in range(steps):
            step(state, x, y, metric)
        end.record()
        torch.cuda.synchronize()
    if not leader:
        return None
    kernels: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] = kernels.get(evt.name, 0.0) + (
                evt.device_time_total / 1e3 / steps)
    if not kernels:
        raise RuntimeError('the profiler saw no device time')
    classes: dict[str, float] = {}
    for name, ms in kernels.items():
        cls = kernel_class(name)
        classes[cls] = classes.get(cls, 0.0) + ms
    busy = sum(kernels.values())
    step_ms = start.elapsed_time(end) / steps
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return dict(config=config, batch=batch, steps=steps,
                space=1 if mesh is None else mesh.size(),
                remat=bool(student.remat),
                ms_per_step=step_ms, kernel_ms_per_step=busy,
                idle_share=max(0.0, 1 - busy / step_ms),
                class_ms=dict(sorted(classes.items(), key=lambda kv: -kv[1])),
                top_kernels=[dict(name=n[:120], ms=ms, cls=kernel_class(n))
                             for n, ms in ranked],
                top_host=[dict(name=e.key[:120],
                               ms=e.self_cpu_time_total / 1e3 / steps,
                               calls=e.count / steps) for e in host[:top]],
                card=torch.cuda.get_device_name(0))


def _banded_rank(args: argparse.Namespace) -> int:
    """One rank of `--space P`: joins the gloo world on the card and
    profiles each configuration banded (rank 0 prints)."""
    from torch.distributed.device_mesh import DeviceMesh

    from quant_tpu_torch.parallel import multihost

    os.environ[multihost.BACKEND_ENV] = 'gloo'
    multihost.initialize(f'127.0.0.1:{args.port}', args.space, args.rank,
                         device='cuda')
    mesh = DeviceMesh('cuda', torch.arange(args.space),
                      mesh_dim_names=('space',))
    try:
        for name in args.names:
            line = profile(name, args.batch, args.steps, args.top,
                           mesh=mesh, **args.overrides)
            if line is not None:
                _emit(json.dumps(line), args.out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _launch(argv: list[str], world: int, timeout: float = 1800.0) -> int:
    """Run `world` ranks of this module with argv and their rank and a
    free port; the largest exit code (every rank killed past timeout)."""
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, '-m', __spec__.name, *argv,
                               '--rank', str(r), '--port', str(port)])
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(p.returncode for p in procs)


def _emit(line: str, out: Optional[str]) -> None:
    print(line, flush=True)
    if out:
        with open(out, 'a') as f:
            f.write(line + '\n')


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--config', choices=list(CONFIGS) + ['all'],
                    default='all')
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--top', type=int, default=12)
    ap.add_argument('--out', default=None)
    ap.add_argument('--space', type=int, default=1,
                    help='band the step over this many gloo ranks')
    ap.add_argument('--remat', choices=('on', 'off'), default=None)
    ap.add_argument('--rank', type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument('--port', type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('train_profile: no CUDA device', file=sys.stderr)
        return 2
    if args.space > 1 and args.rank is None:
        return _launch(sys.argv[1:] if argv is None else argv, args.space)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args.names = list(CONFIGS) if args.config == 'all' else [args.config]
    args.overrides = ({} if args.remat is None
                      else {'remat': args.remat == 'on'})
    if args.space > 1:
        return _banded_rank(args)
    for name in args.names:
        _emit(json.dumps(profile(name, args.batch, args.steps, args.top,
                                 **args.overrides)), args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
