"""Residual MLP, as ``pinnrl_tpu.models.resnet``: Dense -> act, then
``num_blocks`` of act(x + LN(Dense(act(LN(Dense x))))), then a Dense head.

Submodules carry flax's names (``Dense_0`` input, ``ResNetBlock_i`` with
``Dense_0, LayerNorm_0, Dense_1, LayerNorm_1``, ``Dense_1`` head), so the
parameter bridge is a rename. LayerNorm uses flax's eps 1e-6 and runs in
plain ops inside ``torch.func`` transforms (``models/base.layer_norm``): the
residual goes through the generic engine (nested jvp), where torch's fused
layer_norm is wrong from the second order on.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pinnrl_tpu_torch.models.base import dense, get_activation, layer_norm


class ResNetBlock(nn.Module):
    def __init__(self, hidden_dim: int, activation: str = "tanh",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.act = get_activation(activation)
        self.Dense_0 = dense(hidden_dim, hidden_dim, generator)
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.Dense_1 = dense(hidden_dim, hidden_dim, generator)
        self.LayerNorm_1 = nn.LayerNorm(hidden_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(layer_norm(self.LayerNorm_0, self.Dense_0(x)))
        h = layer_norm(self.LayerNorm_1, self.Dense_1(h))
        return self.act(x + h)


class ResNet(nn.Module):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dim: int = 512,
        num_blocks: int = 7,
        activation: str = "tanh",
        dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if dropout > 0.0:
            raise NotImplementedError("dropout is not ported yet (ROADMAP item 12)")
        self.act = get_activation(activation)
        self.num_blocks = int(num_blocks)
        self.Dense_0 = dense(input_dim, hidden_dim, generator)
        for i in range(self.num_blocks):
            self.add_module(f"ResNetBlock_{i}", ResNetBlock(hidden_dim, activation, generator))
        self.Dense_1 = dense(hidden_dim, output_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.Dense_0(x))
        for i in range(self.num_blocks):
            x = getattr(self, f"ResNetBlock_{i}")(x)
        return self.Dense_1(x)
