"""`mfu.serve` (%): the served forward's share of the card's peak: the
least time of the model's own work at peak (counts.serve_peak_s: binary
convs at the int8 peak, the stem, shortcuts and fc at the chain dtype's),
for every image the traced window completed, over the window's seconds."""

from portbench import counts


def read(ctx):
    o = ctx.outcome
    if o.kind != 'serve' or not o.units:
        return None
    work_s = o.units * o.batch * counts.serve_peak_s(ctx.config)
    return 100.0 * work_s / ctx.trace.window_s
