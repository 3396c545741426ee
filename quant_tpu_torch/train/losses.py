"""Classification losses (port of quant_tpu/train/losses.py).

Each takes (output, target) where output is what the model emits (raw
logits for cross_entropy, log-probabilities for nll_loss and kl_div:
LeNet-5 ends in log_softmax) and returns the batch mean. The per-sample
forms ride along as `.per_sample`, for the eval step's masked metrics.
"""

from typing import Callable

import torch


def _cross_entropy_per_sample(output: torch.Tensor,
                              target: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(output, dim=-1)
    return -torch.gather(logp, -1, target[:, None])[:, 0]


def cross_entropy(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy over raw logits."""
    return _cross_entropy_per_sample(output, target).mean()


def _nll_per_sample(output: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
    return -torch.gather(output, -1, target[:, None])[:, 0]


def nll_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Negative log likelihood over log-probabilities."""
    return _nll_per_sample(output, target).mean()


def _kl_elements(output: torch.Tensor,
                 target_probs: torch.Tensor) -> torch.Tensor:
    return target_probs * (torch.log(torch.clamp(target_probs, min=1e-12))
                           - output)


def _kl_per_sample(output: torch.Tensor,
                   target_probs: torch.Tensor) -> torch.Tensor:
    # A row's mean over classes, so a masked mean over rows equals the
    # element mean restricted to the valid rows.
    return _kl_elements(output, target_probs).mean(dim=-1)


def kl_div(output: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """KL(target || output), output in log space, mean over all elements
    (torch F.kl_div's reduction='mean')."""
    return _kl_elements(output, target_probs).mean()


cross_entropy.per_sample = _cross_entropy_per_sample  # type: ignore
nll_loss.per_sample = _nll_per_sample  # type: ignore
kl_div.per_sample = _kl_per_sample  # type: ignore

_LOSSES: dict[str, Callable] = {
    'cross_entropy': cross_entropy,
    'nll_loss': nll_loss,
    'kl_div': kl_div,
}


def get_loss_fn(loss: str) -> Callable:
    """The loss of a config's `model.loss`."""
    try:
        return _LOSSES[loss]
    except KeyError:
        raise ValueError(f'Loss function {loss} is not supported.')
