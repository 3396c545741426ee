"""`roofline.binary_conv` (%): the least time of the binary convs' work
(counts.binary_conv_bound_s, each conv bound by its bytes or its int8
operations) over the device time of the kernels that do it, matched by
name (counts.BINARY_CONV_PATTERN: the producer and the conv, or a kernel
that merges them), in the traced window."""

from portbench import counts


def read(ctx):
    o = ctx.outcome
    if o.kind != 'serve' or not o.units:
        return None
    spent = counts.class_seconds(ctx.trace.kernels, ('binary_conv',))
    if not spent:
        return None
    bound = o.units * counts.binary_conv_bound_s(ctx.config, o.batch)
    return 100.0 * bound / spent
