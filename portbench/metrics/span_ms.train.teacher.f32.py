"""`span_ms.train.teacher.f32` (ms): device milliseconds a step in the
device operations launched inside the `train.teacher` phase: the frozen
teacher's forward and the KD loss, read from spans.py's pass, run after
the traced window and warmed as far as the window ran, and not from the
window itself (spans.py's docstring). Read in the training cells whose
student trains in float32 (BENCHMARK.json lists them); it moves
`train_img_per_s.f32`."""

from portbench import spans


def read(ctx):
    return spans.read_role(ctx, 'train', 'train.teacher', 'f32')
