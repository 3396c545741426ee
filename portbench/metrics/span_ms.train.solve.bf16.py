"""`span_ms.train.solve.bf16` (ms): device milliseconds a step in the
device operations launched inside every `solve` span, in the forward and
in remat's recomputation: the activation and weight solves (lloyd's for
ls-2), read from spans.py's pass, run after the traced window and warmed
as far as the window ran, and not from the window itself (spans.py's
docstring). Read in the training cells whose student trains in bfloat16
(BENCHMARK.json lists them); it moves `train_img_per_s.bf16`."""

from portbench import spans


def read(ctx):
    return spans.read_role(ctx, 'train', 'solve', 'bf16')
