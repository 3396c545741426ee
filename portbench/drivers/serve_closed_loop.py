"""Batch inference, one stream in a closed loop: forwards of `batch`
images dispatched back to back, each on the next of `pool_batches`
distinct batches drawn on the device from the seed, with no host sync
inside the window. The logits of a sample of the forwards, drawn from
the seed (the first forward of each pool batch, then each forward with
probability `check_share`, at most `check_cap` of them), are kept and,
once the window has closed, each image's are held to the reference's.
The allocator is handed back as many blocks of the logits' size before
the window, so keeping them allocates nothing inside it.

Traffic parameters: batch, pool_batches, warmup_units, check_share,
check_cap, trace_seconds.
End-to-end: serve_img_per_s, the images whose logits completed in the
window over its seconds; setup_s, from the process's start to the
window's.
"""

import random
import time

import torch

from portbench import harness, judge, port, state
from portbench.reference import resnet as reference


def run(r: harness.Run) -> harness.Outcome:
    cfg, tr, dev = r.config, r.traffic, r.device
    batch, pool = int(tr['batch']), int(tr['pool_batches'])
    gen = state.generator(r.seed, dev)
    weights = state.serve_state(cfg, gen, dev)
    images = state.images(gen, dev, pool, batch, cfg['image_size'],
                          cfg['in_channels'])
    model = port.serving_model(cfg, weights, dev)
    forward = port.serve_forward(model)
    for i in range(int(tr['warmup_units'])):
        out = forward(images[i % pool])
    cap, share = int(tr['check_cap']), float(tr['check_share'])
    blocks = [torch.empty_like(out) for _ in range(cap)]
    del blocks, out
    harness.synchronize(dev)
    setup_s = time.perf_counter() - r.t0

    pick = random.Random(r.seed)
    kept: dict[int, list[torch.Tensor]] = {b: [] for b in range(pool)}
    n_kept = [0]

    def unit(i: int) -> None:
        out = forward(images[i % pool])
        if n_kept[0] < cap and (i < pool or pick.random() < share):
            kept[i % pool].append(out)
            n_kept[0] += 1

    launches_before = port.launch_counts()
    n, secs, trace = harness.measured(r, unit)
    launches = {k: (v - launches_before.get(k, 0)) // n
                for k, v in port.launch_counts().items()}
    peak = harness.memory_peak_bytes(dev)
    del model, forward
    harness.free(dev)

    worst = torch.zeros((), device=dev)
    failed = 0
    with harness.reference_precision():
        for b in range(pool):
            if not kept[b]:
                continue
            want = reference.serve_logits(cfg, weights, images[b])
            err = judge.logit_errors(torch.stack(kept[b]), want)
            err = torch.where(err.isfinite(), err, torch.inf)
            worst = torch.maximum(worst, err.max())
            failed += int((err > r.limits['logit_err']).sum())
    return harness.Outcome(
        kind='serve',
        e2e={'serve_img_per_s': n * batch / secs, 'setup_s': setup_s},
        attempted=n_kept[0] * batch, failed=failed,
        checks=[harness.Check('logit_err', float(worst),
                              r.limits['logit_err'])],
        units=n, batch=batch, memory_peak_bytes=peak, launches=launches,
        trace=trace)
