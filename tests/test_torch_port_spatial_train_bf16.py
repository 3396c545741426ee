"""The one-process train step of JAX's `_flagship(tiny=True)` (ls-2
activations with lloyd solves, ls-1 weights, the bf16 chain) in the port
against JAX's op-by-op step, the reference that
tests/test_torch_port_spatial_train.py holds the banded flagship step
to through one process's.

JAX's step runs under jax.disable_jit, where every op rounds to bf16 as
PyTorch's eager ops do (under jit XLA fuses ops and skips roundings:
another bf16 program, 16% of the largest gradient apart). Model, seeded
weights and images are tests/test_torch_port_spatial_train.py's (64 px,
BATCH images).
"""

import numpy as np
import torch

from tests.test_torch_port_dp import _grad_tree, _leaves
from tests.test_torch_port_spatial_train import (
    BATCH, BF16_GRAD_TOL, BF16_STATE_TOL, CASES, LOSS_RTOL, _worst,
    inputs, model_kwargs, port_model, seeded_tree)

CASE = 'flagship'


def test_flagship_tiny_step_matches_jax_op_by_op():
    """The loss within LOSS_RTOL, every gradient within BF16_GRAD_TOL of
    the largest gradient element (the bf16 reductions of biases and
    PReLU slopes sum in another order: measured 8.0e-3, a slope), the
    batch_stats and quant_state the step writes within BF16_STATE_TOL."""
    import jax
    import jax.numpy as jnp
    from quant_tpu.nn import QResNet
    from quant_tpu.train import losses as jlosses
    from quant_tpu_torch import train as T
    from quant_tpu_torch.utils.jax_import import to_jax_variables

    tree = seeded_tree(model_kwargs(CASE), 'xnor', list(CASES).index(CASE))
    x, y = (a[:BATCH] for a in inputs(CASE))
    jm = QResNet(**model_kwargs(CASE))

    def loss_for(params: dict) -> tuple:
        out, mut = jm.apply({**tree, 'params': params}, jnp.asarray(x),
                            True, mutable=['batch_stats', 'quant_state'])
        return jlosses.cross_entropy(out, jnp.asarray(y)), mut

    with jax.disable_jit():
        (want_loss, mut), want = jax.value_and_grad(
            loss_for, has_aux=True)(tree['params'])
    model = port_model(model_kwargs(CASE), 'xnor', tree).train()
    loss = T.get_loss_fn('cross_entropy')(model(torch.from_numpy(x)),
                                          torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    got = _leaves(_grad_tree(model))
    want = _leaves(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    assert _worst(got, want) <= BF16_GRAD_TOL
    state = to_jax_variables(model)
    for part in ('batch_stats', 'quant_state'):
        g = _leaves(state[part])
        w = _leaves(jax.tree.map(np.asarray, mut[part]))
        assert set(g) == set(w), part
        for path, leaf in w.items():
            np.testing.assert_allclose(g[path], leaf, **BF16_STATE_TOL,
                                       err_msg=f'{part} {path}')
