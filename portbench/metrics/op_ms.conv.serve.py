"""`op_ms.conv.serve` (ms): device milliseconds a forward in the kernels
of the `conv` class (counts.CLASSES: cuDNN's convs, not the port's binary
convs), in the traced window."""

from portbench import counts


def read(ctx):
    o = ctx.outcome
    if o.kind != 'serve' or not o.units:
        return None
    s = counts.class_seconds(ctx.trace.kernels, ('conv',))
    return None if s is None else 1e3 * s / o.units
