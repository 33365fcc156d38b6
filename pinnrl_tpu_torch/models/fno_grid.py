"""Gridded 2D Fourier Neural Operator, as ``pinnrl_tpu.models.fno_grid``.

The field-to-field FNO of Li et al. 2021: inputs are whole fields on a
regular grid, (B, H, W, C); each block's spectral convolution is a 2D
``torch.fft.rfft2`` whose two low-frequency corner blocks (positive and
negative x-frequencies, one-sided y) are mixed per mode by learnable complex
weights, then ``irfft2`` (the JAX package's ``use_fft=True`` branch; its
default, the truncated DFT as matmuls, exists because FFT gradients do not
lower on its TPU backend, and computes the same function). The retained
modes do not depend on the grid, so weights trained at one resolution
evaluate at another.

The weights' shape follows the grid they are made for, as flax's init does:
``mx = min(modes_x, H // 2)``, ``my = min(modes_y, W // 2 + 1)``, stored as
``w_real`` / ``w_imag`` of shape (2, mx, my, C, O). A grid that would need
other mode counts is refused. Submodules carry flax's names (``Dense_0,
Dense_1`` lift, ``GridFNOBlock_i`` with ``SpectralConv2d_0`` and
``Dense_0``, ``Dense_2, Dense_3`` project).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pinnrl_tpu_torch.models.base import dense, gelu


def _modes(modes_x: int, modes_y: int, h: int, w: int):
    return min(modes_x, h // 2), min(modes_y, w // 2 + 1)


class SpectralConv2d(nn.Module):
    """rfft2 -> per-mode complex weights on the two corner blocks -> irfft2."""

    def __init__(self, in_channels: int, out_channels: int, modes_x: int, modes_y: int,
                 grid: Sequence[int], generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.out_channels = int(out_channels)
        self.modes_x, self.modes_y = int(modes_x), int(modes_y)
        mx, my = _modes(self.modes_x, self.modes_y, *grid)
        scale = 1.0 / (in_channels * out_channels)
        shape = (2, mx, my, in_channels, out_channels)
        self.w_real = nn.Parameter(scale * torch.randn(shape, generator=generator))
        self.w_imag = nn.Parameter(scale * torch.randn(shape, generator=generator))

    def forward(self, v: torch.Tensor) -> torch.Tensor:  # v: (B, H, W, C)
        b, h, w, _ = v.shape
        mx, my = _modes(self.modes_x, self.modes_y, h, w)
        if (mx, my) != tuple(self.w_real.shape[1:3]):
            raise ValueError(f"a {h}x{w} grid keeps {mx}x{my} modes; the weights hold "
                             f"{tuple(self.w_real.shape[1:3])}")
        v_hat = torch.fft.rfft2(v, dim=(1, 2))  # (B, H, W//2+1, C)
        wc = torch.complex(self.w_real, self.w_imag).to(v_hat.dtype)
        low = torch.einsum("bxyc,xyco->bxyo", v_hat[:, :mx, :my], wc[0])
        high = torch.einsum("bxyc,xyco->bxyo", v_hat[:, h - mx:, :my], wc[1])
        zeros = v_hat.new_zeros
        out = torch.cat([low, zeros((b, h - 2 * mx, my, self.out_channels)), high], dim=1)
        out = torch.cat([out, zeros((b, h, w // 2 + 1 - my, self.out_channels))], dim=2)
        return torch.fft.irfft2(out, s=(h, w), dim=(1, 2))


class GridFNOBlock(nn.Module):
    """gelu(SpectralConv2d(v) + Dense(v)) + v (the Dense a 1x1 convolution)."""

    def __init__(self, channels: int, modes_x: int, modes_y: int, grid: Sequence[int],
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.SpectralConv2d_0 = SpectralConv2d(channels, channels, modes_x, modes_y, grid,
                                               generator)
        self.Dense_0 = dense(channels, channels, generator)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        return gelu(self.SpectralConv2d_0(v) + self.Dense_0(v)) + v


class GridFNO2D(nn.Module):
    """lift -> N spectral blocks -> project; (B, H, W, in) -> (B, H, W, out).
    ``grid`` is the (H, W) the weights are made for (see the module
    docstring); ``coord_features`` appends the (x, y) in [0, 1]^2 of each
    cell to the input channels."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        width: int = 32,
        modes: int = 12,
        num_blocks: int = 4,
        coord_features: bool = True,
        grid: Sequence[int] = (48, 48),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.coord_features = bool(coord_features)
        self.num_blocks = int(num_blocks)
        lift_in = in_channels + (2 if self.coord_features else 0)
        self.Dense_0 = dense(lift_in, width, generator)
        self.Dense_1 = dense(width, width, generator)
        for i in range(self.num_blocks):
            self.add_module(f"GridFNOBlock_{i}",
                            GridFNOBlock(width, modes, modes, tuple(grid), generator))
        self.Dense_2 = dense(width, width, generator)
        self.Dense_3 = dense(width, out_channels, generator)

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = a.shape
        if self.coord_features:
            xs = torch.linspace(0.0, 1.0, h, dtype=a.dtype, device=a.device)
            ys = torch.linspace(0.0, 1.0, w, dtype=a.dtype, device=a.device)
            X, Y = torch.meshgrid(xs, ys, indexing="ij")
            coords = torch.stack([X, Y], dim=-1)[None].expand(b, h, w, 2)
            a = torch.cat([a, coords], dim=-1)
        v = gelu(self.Dense_1(self.Dense_0(a)))
        for i in range(self.num_blocks):
            v = getattr(self, f"GridFNOBlock_{i}")(v)
        return self.Dense_3(gelu(self.Dense_2(v)))
