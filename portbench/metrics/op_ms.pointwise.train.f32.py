"""`op_ms.pointwise.train.f32` (ms): device milliseconds a step in the
`elementwise`, `reduction` and `copy` classes of counts.CLASSES (PyTorch's
eager pointwise kernels, reductions and copies), in the traced window.
Read in the training cells whose student trains in float32
(BENCHMARK.json lists them); it moves `train_img_per_s.f32`."""

from portbench import counts


def read(ctx):
    o = ctx.outcome
    if o.kind != 'train' or not o.units:
        return None
    s = counts.class_seconds(ctx.trace.kernels, counts.POINTWISE_CLASSES)
    return None if s is None else 1e3 * s / o.units
