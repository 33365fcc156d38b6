"""Plain MLP PINN backbone: [Dense -> LayerNorm -> act] x L -> Dense."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pinnrl_tpu_torch.models.base import dense, get_activation, layer_norm


class FeedForwardNetwork(nn.Module):
    """MLP with optional LayerNorm (flax eps 1e-6) per hidden layer."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dims: Sequence[int] = (128,) * 7,
        activation: str = "tanh",
        dropout: float = 0.0,
        layer_norm: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if dropout > 0.0:
            raise NotImplementedError("dropout is not ported yet (ROADMAP item 12)")
        self.act = get_activation(activation)
        self.layer_norm = bool(layer_norm)
        self.n_hidden = len(hidden_dims)
        widths = [input_dim, *hidden_dims]
        for i in range(self.n_hidden):
            self.add_module(f"Dense_{i}", dense(widths[i], widths[i + 1], generator))
            if self.layer_norm:
                self.add_module(f"LayerNorm_{i}", nn.LayerNorm(widths[i + 1], eps=1e-6))
        self.add_module(f"Dense_{self.n_hidden}", dense(widths[-1], output_dim, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = getattr(self, f"Dense_{i}")(x)
            if self.layer_norm:
                x = layer_norm(getattr(self, f"LayerNorm_{i}"), x)
            x = self.act(x)
        return getattr(self, f"Dense_{self.n_hidden}")(x)
