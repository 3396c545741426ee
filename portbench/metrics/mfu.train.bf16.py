"""`mfu.train.bf16` (%): the train step's share of the card's peak: the least
time of the model's work at peak (counts.train_peak_s: 3 x the student's
forward and the teacher's forward, every conv dense, at the train
dtypes' peaks), for every image the traced window stepped, over the
window's seconds.
Read in the training cells whose student trains in bfloat16
(BENCHMARK.json lists them); it moves `train_img_per_s.bf16`."""

from portbench import counts


def read(ctx):
    o = ctx.outcome
    if o.kind != 'train' or not o.units:
        return None
    work_s = o.units * o.batch * counts.train_peak_s(ctx.config)
    return 100.0 * work_s / ctx.trace.window_s
