"""`span_ms.serve.block_self` (ms): device milliseconds a forward in the
device operations launched inside `block` spans outside their `qconv`
spans: the blocks' BN, nonlinearities, shortcuts, residual adds and
casts, read from spans.py's pass, run after the traced window and warmed
as far as the window ran, and not from the window itself (spans.py's
docstring). Read in the serving cells (BENCHMARK.json lists them); it
moves `serve_img_per_s`."""

from portbench import spans


def read(ctx):
    return spans.read_role(ctx, 'serve', 'block_self')
