"""`span_ms.serve.qconv` (ms): device milliseconds a forward in the
device operations launched inside all `qconv` spans: each quantized
conv's producer (sign packing), its binary kernel, casts and bias, read
from spans.py's pass, run after the traced window and warmed as far as
the window ran, and not from the window itself (spans.py's docstring).
Read in the serving cells (BENCHMARK.json lists them); it moves
`serve_img_per_s`."""

from portbench import spans


def read(ctx):
    return spans.read_role(ctx, 'serve', 'qconv')
