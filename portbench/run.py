"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything is found by name from BENCHMARK.json at the checkout's root:
the cell's configuration (`file`, under portbench/configs/), its
traffic mix (portbench/traffic/<traffic>.json, whose `driver` names the
general driver in portbench/drivers/), the limits of its comparison
(portbench/limits/<cell>.json) and each per-layer metric's reader
(portbench/metrics/<metric>.py). The run draws its weights and inputs
from the seed on the card, warms up, measures for --seconds (with
--trace 1 under the profiler, for at most the mix's trace_seconds),
holds what the window produced to the plain reference, and prints one
JSON line last: end-to-end metrics with --trace 0, per-layer metrics
with --trace 1.

It refuses to run (exit 2, no result) without as many CUDA devices as
the cell asks for, and fails (exit 1, no result) if JAX or the JAX
package was loaded. Build and kernel caches stay inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import ModuleType  # noqa: E402
from typing import Any, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
CACHE = ROOT / 'build' / 'portbench'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'quant_tpu')


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no JAX through a
    library; the checkout's root on the path in place of this folder
    (whose module names would hide the standard library's)."""
    sys.path[:] = [p for p in sys.path if Path(p or '.').resolve() != BENCH]
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'cuda_cache')):
        os.environ[var] = str(CACHE / sub)
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / 'BENCHMARK.json')


def cell(bench: dict, name: str) -> dict:
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise SystemExit(f'no workload {name!r} in BENCHMARK.json')


def config(bench: dict, name: str) -> dict:
    entry = next(c for c in bench['configs'] if c['name'] == name)
    return load_json(ROOT / entry['file'])


def traffic(name: str) -> dict:
    return load_json(BENCH / 'traffic' / f'{name}.json')


def limits(cell_name: str) -> dict:
    return load_json(BENCH / 'limits' / f'{cell_name}.json')


def _module(path: Path, name: str) -> ModuleType:
    spec_ = importlib.util.spec_from_file_location(name, path)
    if spec_ is None or spec_.loader is None:
        raise ImportError(f'cannot load {path}')
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return importlib.import_module(f'portbench.drivers.{name}')


def reader(metric: str) -> ModuleType:
    return _module(BENCH / 'metrics' / f'{metric}.py',
                   'portbench.metrics.' + metric.replace('.', '_'))


def applies(metric: dict, cell_name: str) -> bool:
    return 'workloads' not in metric or cell_name in metric['workloads']


def e2e_value(e2e: dict[str, float], name: str) -> float:
    """A driver's end-to-end reading of `name`; a name that BENCHMARK.json
    splits by cells (`train_img_per_s.bf16`) reads the driver's quantity
    before the first dot."""
    return e2e[name] if name in e2e else e2e[name.split('.')[0]]


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


def card(device_index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', f'--id={device_index}',
             '--query-gpu=name,power.limit', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi unavailable ({e})'


class Context:
    """What a per-layer metric's reader reads: the run's outcome, its
    trace and the configuration it ran."""

    def __init__(self, config: dict, traffic: dict, outcome: Any):
        self.config, self.traffic, self.outcome = config, traffic, outcome
        self.trace = outcome.trace


def result(bench: dict, w: dict, outcome: Any, trace: bool, device: dict,
           config_: dict, traffic_: dict) -> dict:
    """The result line's object, keys in the contract's order, the
    numbers compared last."""
    metrics: dict[str, dict] = {}
    if trace:
        ctx = Context(config_, traffic_, outcome)
        for m in bench['per_layer']:
            if applies(m, w['name']):
                value = reader(m['name']).read(ctx)
                if value is not None:
                    metrics[m['name']] = {'value': value, 'unit': m['unit']}
        device = {**device, 'busy_s': outcome.trace.busy_s,
                  'window_s': outcome.trace.window_s}
    else:
        for m in bench['end_to_end']:
            if applies(m, w['name']):
                metrics[m['name']] = {'value': e2e_value(outcome.e2e,
                                                         m['name']),
                                      'unit': m['unit']}
    line: dict[str, Any] = {'correct': outcome.correct,
                            'attempted': outcome.attempted,
                            'failed': outcome.failed, 'metrics': metrics,
                            'device': device}
    if trace:
        line['breakdown'] = outcome.trace.breakdown
    line['check'] = {c.name: {'value': c.value, 'limit': c.limit}
                     for c in outcome.checks}
    return line


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    bench = spec()
    w = cell(bench, args.workload)

    import torch
    if not torch.cuda.is_available():
        print('portbench: no CUDA device', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w['chips']:
        print(f"portbench: {w['name']} needs {w['chips']} CUDA devices, "
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    from portbench import harness

    config_, traffic_ = config(bench, w['config']), traffic(w['traffic'])
    print(f'card: {card()}', flush=True)
    run = harness.Run(config=config_, traffic=traffic_,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device('cuda'),
                      t0=T0, limits=limits(w['name']))
    outcome = driver(traffic_['driver']).run(run)
    print(f'launches of the port kernels a unit: {outcome.launches}; '
          f'units {outcome.units}', flush=True)
    found = forbidden_modules()
    if found:
        print(f'portbench: loaded in this process: {found}', file=sys.stderr)
        return 1
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': w['chips'],
              'memory_peak_bytes': outcome.memory_peak_bytes}
    line = result(bench, w, outcome, bool(args.trace), device, config_,
                  traffic_)
    for c in outcome.checks:
        print(f'check {c.name} {c.value!r} limit {c.limit!r} '
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(f'check failed {outcome.failed} of {outcome.attempted}',
          file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
