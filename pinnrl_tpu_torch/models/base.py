"""Shared model utilities: activation registry and parameter counting.

The activations follow flax's definitions, not torch's defaults: flax's
``nn.gelu`` is the tanh approximation, so ``"gelu"`` here is too.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
import torch.nn.functional as F

ACTIVATIONS: Dict[str, Callable] = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "sin": torch.sin,
    "elu": F.elu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "softplus": F.softplus,
}


def get_activation(name: str) -> Callable:
    """Activation name -> function."""
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError as exc:
        raise ValueError(
            f"Unknown activation {name!r}; valid: {sorted(ACTIVATIONS)}"
        ) from exc


def count_parameters(params: torch.nn.Module | Mapping[str, torch.Tensor]) -> int:
    """Total trainable scalars of a module or a name -> tensor mapping."""
    if isinstance(params, torch.nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    return int(sum(p.numel() for p in params.values()))


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal (±2σ), variance 1/fan_in.

    ``weight`` is torch-layout (out, in); the stddev is corrected for the
    truncation as ``jax.nn.initializers.variance_scaling`` does.
    """
    fan_in = weight.shape[1]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(
            weight, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
        )
    return weight


def dense(in_dim: int, out_dim: int, generator: torch.Generator) -> torch.nn.Linear:
    """``nn.Linear`` with flax ``nn.Dense`` defaults (lecun-normal, zero bias)."""
    layer = torch.nn.Linear(in_dim, out_dim)
    lecun_normal_(layer.weight, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer
