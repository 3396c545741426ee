"""Classification metrics (port of quant_tpu/train/metrics.py).

A metric state is a dict of device scalars that each step updates
without a host synchronization; `MetricAccumulator.compute` reads it
back once, with the reference's metric names.
"""

from dataclasses import dataclass, field

import torch

_NAMES = ('loss_sum', 'top1', 'topk', 'count')


def init_metric_state() -> dict[str, torch.Tensor]:
    """Zeroed float32 accumulators; the first update moves them to its
    output's device."""
    return {name: torch.zeros((), dtype=torch.float32) for name in _NAMES}


def _hits(output: torch.Tensor, target: torch.Tensor,
          k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row: the target ranks first; it ranks among the top k. A
    class ranks before the target if its output is larger, or equal
    with a lower index: argmax's first maximum and lax.top_k's order of
    ties (torch.topk orders ties as it likes)."""
    t_out = torch.gather(output, -1, target[:, None])
    idx = torch.arange(output.shape[-1], device=output.device)
    rank = ((output > t_out) | ((output == t_out)
                                & (idx < target[:, None]))).sum(dim=-1)
    return rank < 1, rank < k


def _on(state: dict[str, torch.Tensor],
        device: torch.device) -> dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in state.items()}


def update_metric_state(state: dict[str, torch.Tensor], loss: torch.Tensor,
                        output: torch.Tensor, target: torch.Tensor,
                        k: int = 5) -> dict[str, torch.Tensor]:
    """The state after one batch; `loss` is the batch-mean loss."""
    state = _on(state, output.device)
    n = output.shape[0]
    top1, topk = _hits(output.detach(), target, k)
    return {
        'loss_sum': state['loss_sum'] + loss.detach().float() * n,
        'top1': state['top1'] + top1.sum(),
        'topk': state['topk'] + topk.sum(),
        'count': state['count'] + n,
    }


def update_metric_state_masked(state: dict[str, torch.Tensor],
                               per_sample_loss: torch.Tensor,
                               output: torch.Tensor, target: torch.Tensor,
                               k: int = 5) -> dict[str, torch.Tensor]:
    """The state after one batch, rows with target < 0 (padding) left
    out of every accumulator."""
    state = _on(state, output.device)
    valid = target >= 0
    vf = valid.to(torch.float32)
    safe_t = torch.where(valid, target, torch.zeros_like(target))
    top1, topk = _hits(output.detach(), safe_t, k)
    return {
        'loss_sum': state['loss_sum']
        + (per_sample_loss.detach().float() * vf).sum(),
        'top1': state['top1'] + (top1 & valid).sum(),
        'topk': state['topk'] + (topk & valid).sum(),
        'count': state['count'] + vf.sum(),
    }


@dataclass
class MetricAccumulator:
    """Host-side wrapper with the reference's metric names."""

    k: int = 5
    state: dict = field(default_factory=init_metric_state)

    def reset(self) -> None:
        self.state = init_metric_state()

    def compute(self) -> dict[str, float]:
        s = {name: float(v) for name, v in self.state.items()}
        n = max(s['count'], 1.0)
        return {
            'Loss': s['loss_sum'] / n,
            'Top-1 Accuracy': s['top1'] / n,
            f'Top-{self.k} Accuracy': s['topk'] / n,
        }
