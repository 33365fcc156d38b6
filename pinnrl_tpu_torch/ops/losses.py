"""Loss reductions: mse / mae / huber over difference arrays, mean-reduced."""

from __future__ import annotations

import torch


def apply_loss_fn(diff: torch.Tensor, loss_function: str = "mse", huber_delta: float = 1.0):
    """Reduce a difference array (residual, prediction - target) to a scalar."""
    if loss_function == "mse":
        return torch.mean(diff**2)
    if loss_function == "mae":
        return torch.mean(torch.abs(diff))
    if loss_function == "huber":
        ad = torch.abs(diff)
        quad = 0.5 * diff**2
        lin = huber_delta * (ad - 0.5 * huber_delta)
        return torch.mean(torch.where(ad <= huber_delta, quad, lin))
    raise ValueError(f"Unknown loss_function {loss_function!r}; valid: mse|mae|huber")


def relative_l2(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12):
    """Relative L2 error ||pred - target|| / ||target||."""
    num = torch.sqrt(torch.sum((pred - target) ** 2))
    den = torch.sqrt(torch.sum(target**2))
    return num / (den + eps)
