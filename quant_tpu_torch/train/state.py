"""Train state (port of quant_tpu/train/state.py).

JAX threads one pytree (step, params, batch_stats, quant_state,
opt_state) through a pure step. Here the model's parameters and buffers
are the params and state, the torch.optim optimizer holds the optimizer
state, and the step counts the updates made (the schedule's input).
"""

from dataclasses import dataclass

import torch

from quant_tpu_torch.train.optim import OptimizerSpec


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    tx: OptimizerSpec
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module,
               tx: OptimizerSpec) -> 'TrainState':
        """Step 0, the optimizer built over the model's parameters."""
        return cls(model=model, optimizer=tx.init(model), tx=tx)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device
