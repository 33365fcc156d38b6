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


def layer_norm(norm: torch.nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm(x)``; inside a ``torch.func`` transform, the same function in
    plain ops (two-pass variance, as torch's). torch's fused layer_norm has
    a forward-mode rule that is wrong from the second order on (nested
    ``torch.func.jvp`` gives wrong u_xx), while plain ops nest exactly; the
    fused op stays where no transform is active (one launch, not six)."""
    if not torch._C._are_functorch_transforms_active():
        return norm(x)
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + norm.eps) * norm.weight + norm.bias


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


class Dense(torch.nn.Linear):
    """``nn.Linear`` that promotes its input and parameters to a common
    dtype, as flax's ``nn.Dense`` does: float32 features into float64
    weights give float64, where ``nn.Linear`` raises."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if x.dtype != w.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w, b = x.to(dt), w.to(dt), b.to(dt)
        return F.linear(x, w, b)


def dense(in_dim: int, out_dim: int, generator: torch.Generator) -> Dense:
    """A ``Dense`` with flax ``nn.Dense`` defaults (lecun-normal, zero bias)."""
    layer = Dense(in_dim, out_dim)
    lecun_normal_(layer.weight, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer
