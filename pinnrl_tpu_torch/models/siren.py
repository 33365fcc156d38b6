"""SIREN: sinusoidal representation network, as ``pinnrl_tpu.models.siren``.

Layers compute ``sin(omega_0 (x W + b))`` through the hand-written CUDA
kernel on CUDA tensors (``ops/kernels/siren.py``), at any width. SIREN
initialisation: first layer U[-1/fan_in, 1/fan_in], the other layers and
the final ``Dense`` U[+-sqrt(6/fan_in)/omega_0], zero biases, drawn from the
caller's ``torch.Generator``.

Names follow flax's tree so the bridge is a rename: ``SIRENLayer_i.kernel``
keeps flax's (in, out) layout (the kernel's W), ``Dense_0`` is an
``nn.Linear`` with torch's (out, in) weight.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def _siren_init(shape, omega_0: float, is_first: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[-bound, bound] of ``shape`` = (fan_in, fan_out), flax's kernel layout."""
    fan_in = shape[0]
    bound = (1.0 / fan_in) if is_first else (math.sqrt(6.0 / fan_in) / omega_0)
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class SIRENLayer(nn.Module):
    """One fused sin(omega_0 (x W + b)) layer."""

    def __init__(self, in_dim: int, features: int, omega_0: float = 30.0, is_first: bool = False,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.omega_0 = float(omega_0)
        self.kernel = nn.Parameter(_siren_init((in_dim, features), omega_0, is_first, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from pinnrl_tpu_torch.ops.kernels.siren import siren_layer

        return siren_layer(x, self.kernel, self.bias, self.omega_0)


class SIREN(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, hidden_dims: Sequence[int] = (124,) * 7,
                 omega_0: float = 30.0, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.n_hidden = len(hidden_dims)
        widths = [input_dim, *hidden_dims]
        for i in range(self.n_hidden):
            self.add_module(f"SIRENLayer_{i}", SIRENLayer(widths[i], widths[i + 1], omega_0,
                                                          is_first=(i == 0), generator=generator))
        self.Dense_0 = nn.Linear(widths[-1], output_dim)
        with torch.no_grad():
            self.Dense_0.weight.copy_(_siren_init((widths[-1], output_dim), omega_0, False,
                                                  generator).t())
            self.Dense_0.bias.zero_()

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = getattr(self, f"SIRENLayer_{i}")(x)
        return self.Dense_0(x)
