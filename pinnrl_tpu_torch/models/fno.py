"""Point-wise Fourier Neural Operator, as ``pinnrl_tpu.models.fno``.

Inputs are (x, t) coordinates; the spectral convolution acts along the
hidden CHANNEL axis: ``torch.fft.rfft`` over the features, a learnable
complex (modes x modes) mixing of the lowest modes, zero-padding, ``irfft``
(the JAX package's ``use_dft_matmul=False`` branch; its default, the same
transform as four real matmuls against DFT bases, exists for the TPU's
matrix unit and computes the same function). ``torch.fft`` nests under
``torch.func.jvp``, so the residual of a PDE reaches any order through it.

Submodules carry flax's names (``Dense_0, Dense_1`` lift, ``FNOBlock_i``
with ``SpectralConv_0`` (``w_re``, ``w_im``), ``Dense_0`` and
``LayerNorm_0``, then ``Dense_2, Dense_3`` project), so the parameter bridge
carries them as they are. LayerNorm uses flax's eps 1e-6 in plain ops
inside ``torch.func`` transforms (``models/base.layer_norm``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pinnrl_tpu_torch.models.base import dense, get_activation, layer_norm


class SpectralConv(nn.Module):
    """Channel-spectral convolution: rfft -> truncated complex mix -> irfft."""

    def __init__(self, hidden_dim: int, modes: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.hidden_dim = int(hidden_dim)
        n_freq = self.hidden_dim // 2 + 1
        self.modes = min(int(modes), n_freq)
        scale = 1.0 / (self.hidden_dim * max(self.modes, 1))
        shape = (self.modes, self.modes)
        self.w_re = nn.Parameter(scale * torch.randn(shape, generator=generator))
        self.w_im = nn.Parameter(scale * torch.randn(shape, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_freq = self.hidden_dim // 2 + 1
        low = torch.fft.rfft(x, dim=-1)[..., :self.modes]
        mixed = low @ torch.complex(self.w_re, self.w_im).to(low.dtype)
        pad = mixed.new_zeros(mixed.shape[:-1] + (n_freq - self.modes,))
        return torch.fft.irfft(torch.cat([mixed, pad], dim=-1), n=self.hidden_dim, dim=-1)


class FNOBlock(nn.Module):
    """LayerNorm(x + act(SpectralConv(x) + Dense(x)))."""

    def __init__(self, hidden_dim: int, modes: int, activation: str = "gelu",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.act = get_activation(activation)
        self.SpectralConv_0 = SpectralConv(hidden_dim, modes, generator)
        self.Dense_0 = dense(hidden_dim, hidden_dim, generator)
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.SpectralConv_0(x) + self.Dense_0(x)
        return layer_norm(self.LayerNorm_0, x + self.act(h))


class FNONetwork(nn.Module):
    """lift (two Dense with act between) -> N FNO blocks -> project."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dim: int = 256,
        num_blocks: int = 4,
        modes: int = 16,
        activation: str = "gelu",
        dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        # dropout is taken and applied nowhere, as in the JAX package.
        self.act = get_activation(activation)
        self.num_blocks = int(num_blocks)
        self.Dense_0 = dense(input_dim, hidden_dim, generator)
        self.Dense_1 = dense(hidden_dim, hidden_dim, generator)
        for i in range(self.num_blocks):
            self.add_module(f"FNOBlock_{i}", FNOBlock(hidden_dim, modes, activation, generator))
        self.Dense_2 = dense(hidden_dim, hidden_dim // 2, generator)
        self.Dense_3 = dense(hidden_dim // 2, output_dim, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.Dense_1(self.act(self.Dense_0(x)))
        for i in range(self.num_blocks):
            x = getattr(self, f"FNOBlock_{i}")(x)
        return self.Dense_3(self.act(self.Dense_2(x)))
