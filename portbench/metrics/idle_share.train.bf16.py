"""`idle_share.train.bf16` (%): the share of the traced window in which no
operation ran on the device: 1 - the union of the device operations'
intervals over the window.
Read in the training cells whose student trains in bfloat16
(BENCHMARK.json lists them); it moves `train_img_per_s.bf16`."""


def read(ctx):
    o = ctx.outcome
    t = ctx.trace
    if o.kind != 'train' or not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
