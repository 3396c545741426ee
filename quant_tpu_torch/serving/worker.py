"""Serving worker process: one InferenceEngine behind the socket RPC (port
of quant_tpu/serving/worker.py).

Launched once per process (`python -c 'from quant_tpu_torch.serving.worker
import main; main()' --spec spec.json --port-file P`); builds the model
from the spec, wraps it in an EngineServer and serves until a shutdown
op arrives. The bound port is written to --port-file once listening.
The worker prepares and serves its model with TF32 off
(device.full_precision), the float32 of the JAX package.

Spec (JSON):
  model: 'lenet_random'    — seeded LeNet-5 (4 and 4 filters, ls-1 x
                             ls-1, per-batch activation scales), packed
                             weights exported;
         'resnet18_random' — seeded XNOR ResNet-18 (224 px, 1000 classes,
                             double shortcut, PReLU, clamp alpha 2, ls-1 x
                             ls-1, EMA and weight scales 0.5), bf16 chain,
                             sign_compute 'int8', exported, threshold
                             folded and stripped;
         'experiment'      — a trained experiment directory
                             (config.yaml + its latest checkpoint),
                             packed and BN-folded where the family allows
                             at start-up (needs input_shape);
         'artifact'        — a prepared artifact (serving/prepare.py):
                             the stripped packed variables load as they
                             are, no export work (input_shape from its
                             serving.yaml unless given).
  experiment_dir, artifact_dir: for 'experiment' and 'artifact'.
  seed: weight seed of the *_random models (one torch.Generator), so
        every worker of one seed serves identical variables.
  device: 'cuda' (default) or 'cpu'; a worker whose device is missing
        exits non-zero.
  input_shape, max_batch, batch_buckets, max_wait_ms, warmup: engine
        knobs.

Unlike the JAX worker, the 'experiment' spec has no dense fallback: a
packed export that fails raises and the worker exits non-zero, since a
dense model would serve without the packed kernels.

`spawn_engine_workers` is the parent's helper: starts n workers, waits
for their ports and returns (procs, clients).
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

from quant_tpu_torch.device import full_precision

def _seeded_model(kind: str, spec: dict) -> torch.nn.Module:
    """The spec's model on the CPU, from one generator seeded by spec
    'seed', prepared for serving."""
    from quant_tpu_torch.nn import export
    from quant_tpu_torch.nn.layers import QuantConv2d
    from quant_tpu_torch.nn.lenet import QLeNet5
    from quant_tpu_torch.ops.quantize import solve_scales
    from quant_tpu_torch.probes.models import bench_resnet18

    gen = torch.Generator().manual_seed(int(spec.get('seed', 0)))
    if kind == 'lenet_random':
        model = QLeNet5(conv1_filters=int(spec.get('conv1_filters', 4)),
                        conv2_filters=int(spec.get('conv2_filters', 4)),
                        x_quant='ls-1', w_quant='ls-1', device='cpu',
                        generator=gen)
        # The weight scales training caches (JAX's init leaves zeros,
        # which would serve one logit row for every image).
        conv = model.conv2
        conv.w_vs = solve_scales('ls-1', torch.movedim(conv.kernel, -1, 0))
        return export.export_packed_variables(model)
    model = bench_resnet18('ls-1', 'ls-1', moving_average_mode='eval_only',
                           eval_dtype=torch.bfloat16, sign_compute='int8',
                           device='cpu', generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, QuantConv2d):
                m.w_vs.fill_(0.5)
                m.x_quantizer.ema.fill_(0.5)
                # One tracked batch: the threshold fold requires it.
                m.x_quantizer.ema_count.fill_(1)
    export.export_packed_variables(model)
    if not export.fold_for_serving(model)[1]:
        raise RuntimeError('resnet18_random: the threshold fold did not '
                           'apply')
    return export.strip_for_deployment(model)


@full_precision()
def build_engine_from_spec(spec: dict) -> 'object':
    """Construct the InferenceEngine a worker serves (the model prepared
    under device.full_precision; `main` serves under it too)."""
    from quant_tpu_torch.device import resolve_device
    from quant_tpu_torch.serving.engine import InferenceEngine

    kind = spec.get('model', 'lenet_random')
    if kind not in ('experiment', 'artifact', 'lenet_random',
                    'resnet18_random'):
        raise ValueError(f'unknown model spec {kind!r}')
    device = resolve_device(spec.get('device', 'cuda'))
    if kind == 'experiment':
        from quant_tpu_torch.nn import export
        from quant_tpu_torch.serving.prepare import (
            serve_packed, load_experiment_model,
        )
        model, _, _ = load_experiment_model(spec['experiment_dir'], device)
        export.export_packed_variables(serve_packed(model))
        export.fold_for_serving(model)
        input_shape = tuple(spec['input_shape'])
    elif kind == 'artifact':
        from quant_tpu_torch.serving.prepare import load_serving_artifact
        model, art_shape = load_serving_artifact(spec['artifact_dir'],
                                                 device)
        input_shape = tuple(spec.get('input_shape', art_shape))
    else:
        default_shape = ((28, 28, 1) if kind == 'lenet_random'
                         else (224, 224, 3))
        input_shape = tuple(spec.get('input_shape', default_shape))
        model = _seeded_model(kind, spec).to(device)
    return InferenceEngine(model, input_shape,
                           max_batch=int(spec.get('max_batch', 32)),
                           batch_buckets=spec.get('batch_buckets'),
                           max_wait_ms=float(spec.get('max_wait_ms', 2.0)),
                           device=device)


@full_precision()
def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--spec', required=True,
                        help='JSON spec file (see module docstring)')
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=0)
    parser.add_argument('--port-file', default=None,
                        help='write the bound port here once listening')
    parser.add_argument('--secret-file', default=None,
                        help='file holding the shared RPC secret '
                             '(REQUIRED for a non-loopback --host)')
    args = parser.parse_args(argv)

    from quant_tpu_torch.serving.rpc import EngineServer

    # The file's bytes are the secret, verbatim (no stripping: the
    # spawner writes raw bytes, and both sides must derive one HMAC key).
    secret = (pathlib.Path(args.secret_file).read_bytes()
              if args.secret_file else None)
    spec = json.loads(pathlib.Path(args.spec).read_text())
    engine = build_engine_from_spec(spec)
    if spec.get('warmup', True):
        engine.warmup()
    server = EngineServer(engine, host=args.host, port=args.port,
                          secret=secret)
    server.start()
    if args.port_file:
        tmp = args.port_file + '.tmp'
        pathlib.Path(tmp).write_text(str(server.address[1]))
        os.replace(tmp, args.port_file)  # atomic: no partial reads
    server.wait_for_shutdown()
    server.stop()


def spawn_engine_workers(n: int, spec: dict,
                         env: Optional[dict] = None,
                         timeout: float = 180.0,
                         secret: Optional[bytes] = None) -> tuple:
    """Start n worker processes; returns (procs, clients) once every
    worker listens. The caller owns shutdown (client.shutdown_server(),
    then proc.wait()). If a worker fails to come up, every worker already
    started is killed and reaped before the error propagates."""
    from quant_tpu_torch.serving.rpc import RemoteEngineClient

    tmp = tempfile.mkdtemp(prefix='qtt_serve_')
    spec_path = pathlib.Path(tmp) / 'spec.json'
    spec_path.write_text(json.dumps(spec))
    secret_args: list[str] = []
    if secret is not None:
        sf = pathlib.Path(tmp) / 'secret'
        sf.write_bytes(secret)
        sf.chmod(0o600)
        secret_args = ['--secret-file', str(sf)]
    procs: list = []
    clients: list = []
    port_files = []
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    try:
        for i in range(n):
            pf = str(pathlib.Path(tmp) / f'port{i}')
            port_files.append(pf)
            # -c, not -m: runpy would warn re-importing a module the
            # parent already imported.
            procs.append(subprocess.Popen(
                [sys.executable, '-c',
                 'from quant_tpu_torch.serving.worker import main; main()',
                 '--spec', str(spec_path), '--port-file', pf,
                 *secret_args],
                env=full_env,
                cwd=str(pathlib.Path(__file__).resolve().parents[2])))
        deadline = time.monotonic() + timeout
        ports = []
        for pf, proc in zip(port_files, procs):
            while not os.path.exists(pf):
                if proc.poll() is not None:
                    raise RuntimeError(
                        f'serving worker exited rc={proc.returncode} '
                        f'before listening')
                if time.monotonic() > deadline:
                    raise TimeoutError('serving worker did not start')
                time.sleep(0.1)
            ports.append(int(pathlib.Path(pf).read_text()))
        for p in ports:
            clients.append(RemoteEngineClient('127.0.0.1', p,
                                              secret=secret))
    except BaseException:
        for c in clients:
            try:
                c.stop()
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
        for p in procs:
            try:
                p.kill()
                p.wait(timeout=10)  # reap: no zombies in the parent
            except (OSError, subprocess.TimeoutExpired):
                pass
        raise
    return procs, clients


if __name__ == '__main__':
    main()
