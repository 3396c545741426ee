"""The port's bf16 train chain (train_dtype, the TPU recipe's knob)
against JAX's op-by-op execution.

The reference is JAX's value_and_grad under jax.disable_jit: every op
rounds to bf16 as PyTorch's eager ops do (under jit XLA fuses ops and
skips roundings: another bf16 program). The model is
probes.models.small_config's XNOR ResNet (ls-1 x ls-1, width 8, 32 px),
seeded by probes.models.seed_state, batch 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from quant_tpu.nn import QResNet as JQResNet
from quant_tpu.train import losses as jlosses
from quant_tpu_torch import train as T
from quant_tpu_torch.probes import models
from quant_tpu_torch.utils.jax_import import to_jax_variables
from tests.test_torch_port_train_step import images, leaves, port_grads

# bf16 chain against JAX's op-by-op apply: every op rounds to bf16 on
# both sides, but the convs and the gradients' reductions (a bias's, a
# PReLU slope's: bf16 sums over N, H, W) sum in another order, so a
# bf16 rounding can land an ulp (2^-8) apart (measured: most leaves
# equal, conv biases 3%, slopes 6%). A leaf whose true gradient is 0 (a
# conv bias before a BN) holds bf16 noise of either side's own: the
# floor is BF16_GRAD_FLOOR of the whole gradient's norm.
BF16_LOSS_RTOL = 2e-2
BF16_GRAD_RTOL, BF16_GRAD_FLOOR = 0.1, 1e-3


def test_bf16_train_chain_matches_jax_op_by_op():
    """train_dtype bf16 (the TPU recipe's knob): the chain in bf16, the
    solves, BN reductions, parameters, gradients and logits in float32,
    against JAX's op-by-op value_and_grad (BF16_LOSS_RTOL, a gradient
    leaf within BF16_GRAD_RTOL of its norm plus the floor)."""
    cfg = dict(models.small_config('xnor', 'ls-1', 'ls-1'),
               train_dtype='bfloat16')
    model = models.build('xnor', cfg, device='cpu',
                         generator=torch.Generator().manual_seed(0))
    models.seed_state(model, torch.Generator().manual_seed(1))
    variables = to_jax_variables(model)
    x, y = images('xnor', n=2)
    jm = JQResNet(**{**cfg, 'train_dtype': jnp.bfloat16})

    def loss_for(params: dict) -> jax.Array:
        out, _ = jm.apply({**variables, 'params': params}, jnp.asarray(x),
                          True, mutable=['batch_stats', 'quant_state'])
        assert out.dtype == jnp.float32
        return jlosses.cross_entropy(out, jnp.asarray(y))

    with jax.disable_jit():
        want_loss, want_grads = jax.value_and_grad(loss_for)(
            variables['params'])
    model.train()
    out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    loss = T.get_loss_fn('cross_entropy')(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=BF16_LOSS_RTOL)
    got, want = leaves(port_grads(model)), leaves(want_grads)
    floor = BF16_GRAD_FLOOR * np.sqrt(sum(np.sum(w.astype(np.float64) ** 2)
                                          for w in want.values()))
    for name, w in want.items():
        assert got[name].dtype == w.dtype == np.float32
        err = np.linalg.norm(got[name] - w)
        assert err <= BF16_GRAD_RTOL * np.linalg.norm(w) + floor, (
            name, err, np.linalg.norm(w))
