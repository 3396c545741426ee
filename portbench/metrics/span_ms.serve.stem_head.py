"""`span_ms.serve.stem_head` (ms): device milliseconds a forward in the
device operations launched inside the `stem` span (input cast, stem
conv, BN, ReLU, pool) and the `head` span (global pool, fc, the cast to
float32 logits), read from spans.py's pass, run after the traced window
and warmed as far as the window ran, and not from the window itself
(spans.py's docstring). Read in the serving cells (BENCHMARK.json lists
them); it moves `serve_img_per_s`."""

from portbench import spans


def read(ctx):
    return spans.read_role(ctx, 'serve', 'stem_head')
