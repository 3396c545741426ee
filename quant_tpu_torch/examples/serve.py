"""Serving demo: a packed binary model behind the batching inference
engine (port of examples/serve.py).

    python -m quant_tpu_torch.examples.serve [--device cpu] \\
        [--config <experiments/.../config.yaml> --checkpoint <.../checkpoint_N>]
        [--requests 64] [--workers N [--artifact DIR | --experiment DIR]]

Without a config it serves the seeded packed ls-1 XNOR ResNet-18
(`probes.models.seeded_serving_resnet18`; a throughput and integration
demo). With a config (and optionally a checkpoint) it builds that model,
packs, folds and strips it, and serves a bf16 chain. Requests go in as
single images; the engine batches them into its buckets. With
--workers N it serves from N worker processes behind the socket RPC and
a least-loaded frontend: a prepared artifact (serving/prepare.py), an
experiment directory, or the seeded ResNet-18.
"""

import argparse
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import yaml


def _report(outs: list, dt: float, stats: dict, prefix: str) -> None:
    print(f'{len(outs)} requests{prefix} in {dt:.2f}s '
          f'({len(outs) / dt:.1f} req/s), batches={stats["batches"]}')
    # Latencies are recorded after the futures resolve; with few requests
    # the window may still be empty when the main thread reads stats.
    lat = stats.get('latency_ms')
    if lat:
        print(f'latency p50/p99 = {lat["p50"]:.1f}/{lat["p99"]:.1f} ms')


def _serve_multiprocess(args: argparse.Namespace) -> list:
    """N engine processes behind the socket RPC and a least-loaded
    frontend."""
    from quant_tpu_torch.serving.engine import ServingFrontend
    from quant_tpu_torch.serving.worker import spawn_engine_workers

    shape = [args.image_size, args.image_size, 3]
    if args.artifact:
        meta = yaml.safe_load(
            (Path(args.artifact) / 'serving.yaml').read_text())
        shape = list(meta['input_shape'])
        spec = {'model': 'artifact', 'artifact_dir': args.artifact}
    elif args.experiment:
        spec = {'model': 'experiment', 'experiment_dir': args.experiment,
                'input_shape': shape}
    else:
        spec = {'model': 'resnet18_random', 'input_shape': shape, 'seed': 0}
    spec.update(max_batch=64, device=args.device)
    secret = (Path(args.secret_file).read_bytes() if args.secret_file
              else None)
    print(f'spawning {args.workers} engine processes...')
    procs, clients = spawn_engine_workers(args.workers, spec,
                                          secret=secret)
    frontend = ServingFrontend(clients).start()
    try:
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        futs = [frontend.submit(rng.standard_normal(shape).astype(
            np.float32)) for _ in range(args.requests)]
        outs = [f.result(timeout=600) for f in futs]
        stats = frontend.stats
        _report(outs, time.perf_counter() - t0, stats,
                f' over {args.workers} processes')
        print('per-engine requests:',
              [s['requests'] for s in stats['engines']])
    finally:
        for c in clients:
            c.shutdown_server()
        frontend.stop()
        for p in procs:
            p.wait(timeout=60)
    return outs


def _model(args: argparse.Namespace) -> torch.nn.Module:
    """The served model on the CPU: packed, folded, stripped, bf16."""
    from quant_tpu_torch.nn import export
    from quant_tpu_torch.serving.prepare import serve_packed
    from quant_tpu_torch.train.task import (
        _restore_into, init_model_variables,
    )
    from quant_tpu_torch.utils.checkpoints import restore_checkpoint

    if not args.config:
        from quant_tpu_torch.probes.models import seeded_serving_resnet18
        model = seeded_serving_resnet18('cpu', 0)
    else:
        with open(args.config) as f:
            model_cfg = yaml.safe_load(f)['model']
        model = init_model_variables(model_cfg['architecture'],
                                     model_cfg.get('arch_config', {}), 0,
                                     'cpu')
        if args.checkpoint:
            _restore_into(model, restore_checkpoint(Path(args.checkpoint)))
        # Pack every quantized weight once, fold BN where the family
        # allows and strip the fp32 masters.
        export.export_packed_variables(serve_packed(model))
        export.fold_for_serving(model)
        export.strip_for_deployment(model)
    model.eval_dtype = torch.bfloat16
    return model


def main(argv: Optional[Sequence[str]] = None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, default=None,
                        help='experiment config.yaml defining the model')
    parser.add_argument('--checkpoint', type=str, default=None)
    parser.add_argument('--requests', type=int, default=64)
    parser.add_argument('--image-size', type=int, default=224)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--workers', type=int, default=0,
                        help='>0: serve across N engine processes behind '
                             'the socket RPC with least-loaded dispatch')
    parser.add_argument('--experiment', type=str, default=None,
                        help='with --workers: experiment dir every '
                             'worker loads (defaults to the seeded '
                             'packed ResNet-18)')
    parser.add_argument('--artifact', type=str, default=None,
                        help='with --workers: serve a prepared artifact '
                             'dir (quant_tpu_torch.serving.prepare)')
    parser.add_argument('--secret-file', type=str, default=None,
                        help='with --workers: shared RPC secret file, '
                             'which turns on the HMAC handshake')
    args = parser.parse_args(argv)

    if args.workers > 0:
        return _serve_multiprocess(args)

    from quant_tpu_torch.device import resolve_device
    from quant_tpu_torch.serving.engine import InferenceEngine

    device = resolve_device(args.device)
    model = _model(args).to(device)
    # The stem's kernel (HWIO) gives the images' channels.
    shape = (args.image_size, args.image_size, model.conv1.kernel.shape[2])
    engine = InferenceEngine(model, shape, max_batch=64, device=device)
    engine.warmup()
    engine.start()
    try:
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        futs = [engine.submit(rng.standard_normal(shape).astype(np.float32))
                for _ in range(args.requests)]
        outs = [f.result(timeout=600) for f in futs]
        _report(outs, time.perf_counter() - t0, engine.stats, '')
        print('first logits:', np.asarray(outs[0])[:5])
    finally:
        engine.stop()
    return outs


if __name__ == '__main__':
    main()
