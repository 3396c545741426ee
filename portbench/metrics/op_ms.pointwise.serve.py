"""`op_ms.pointwise.serve` (ms): device milliseconds a forward in the
`elementwise`, `reduction` and `copy` classes of counts.CLASSES (PyTorch's
eager pointwise kernels, reductions and copies), in the traced window."""

from portbench import counts


def read(ctx):
    o = ctx.outcome
    if o.kind != 'serve' or not o.units:
        return None
    s = counts.class_seconds(ctx.trace.kernels, counts.POINTWISE_CLASSES)
    return None if s is None else 1e3 * s / o.units
