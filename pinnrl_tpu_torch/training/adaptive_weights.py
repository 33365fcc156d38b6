"""Adaptive loss weighting (LRW / RBW) as state transitions on the device.

The port of ``pinnrl_tpu.training.adaptive_weights``. The running averages
and the previous weights live in an ``AdaptiveWeightState`` of device
tensors that the trainer carries from step to step; ``update`` branches with
``torch.where`` on the ``initialized`` flag, so no transition reads a
device value back to the host.

- RBW (relative-error based): an EMA of the component losses, normalized
  to weights, then EMA-smoothed against the previous weights.
- LRW (learning-rate / gradient based): an EMA of the per-component
  gradient norms, weights proportional to their inverses. The trainer takes
  the norms from one ``torch.autograd.grad`` per component.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch


@dataclass
class AdaptiveWeightState:
    running: torch.Tensor  # EMA of the losses (rbw) or gradient norms (lrw)
    weights: torch.Tensor
    prev_weights: torch.Tensor
    initialized: torch.Tensor  # bool, 0-d


class AdaptiveLossWeights:
    """The strategy and its constants; ``update`` is a pure transition."""

    def __init__(self, strategy: str = "rbw", alpha: float = 0.9, eps: float = 1e-5,
                 initial_weights: Optional[Sequence[float]] = None, num_components: int = 3,
                 device: str | torch.device = "cpu") -> None:
        self.strategy = strategy.lower()
        if self.strategy not in ("lrw", "rbw"):
            raise ValueError(f"strategy must be lrw|rbw, got {strategy!r}")
        self.alpha = float(alpha)
        self.eps = float(eps)
        self.num_components = num_components
        self.device = torch.device(device)
        if initial_weights is not None:
            self.initial_weights = torch.tensor(list(initial_weights), dtype=torch.float32,
                                                device=self.device)
        else:
            self.initial_weights = torch.ones(num_components, device=self.device) / num_components

    def init(self) -> AdaptiveWeightState:
        n = self.num_components
        return AdaptiveWeightState(
            running=torch.zeros(n, device=self.device),
            weights=self.initial_weights.clone(),
            prev_weights=self.initial_weights.clone(),
            initialized=torch.zeros((), dtype=torch.bool, device=self.device),
        )

    def update(self, state: AdaptiveWeightState, values: torch.Tensor) -> AdaptiveWeightState:
        """``values``: the per-component losses (rbw) or gradient norms (lrw)."""
        first = ~state.initialized
        running = torch.where(first, values,
                              self.alpha * state.running + (1 - self.alpha) * values)
        if self.strategy == "lrw":
            inv = 1.0 / (running + self.eps)
            new_w = inv / torch.sum(inv)
        else:  # rbw: a higher loss gets a higher weight, EMA-smoothed
            new_w = running / (torch.sum(running) + self.eps)
            new_w = torch.where(first, new_w,
                                self.alpha * state.prev_weights + (1 - self.alpha) * new_w)
        weights = torch.where(first, self.initial_weights, new_w)
        return AdaptiveWeightState(
            running=running,
            weights=weights,
            prev_weights=weights,
            initialized=torch.ones((), dtype=torch.bool, device=self.device),
        )

    def get_weights(self, state: AdaptiveWeightState) -> torch.Tensor:
        return state.weights
