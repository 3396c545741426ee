"""`idle_share.serve` (%): the share of the traced window in which no
operation ran on the device: 1 - the union of the device operations'
intervals over the window."""


def read(ctx):
    o = ctx.outcome
    t = ctx.trace
    if o.kind != 'serve' or not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
