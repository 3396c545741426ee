"""`op_ms.conv.train.bf16` (ms): device milliseconds a step in the kernels
of the `conv` class (counts.CLASSES: cuDNN's convs, not the port's binary
convs), in the traced window.
Read in the training cells whose student trains in bfloat16
(BENCHMARK.json lists them); it moves `train_img_per_s.bf16`."""

from portbench import counts


def read(ctx):
    o = ctx.outcome
    if o.kind != 'train' or not o.units:
        return None
    s = counts.class_seconds(ctx.trace.kernels, ('conv',))
    return None if s is None else 1e3 * s / o.units
