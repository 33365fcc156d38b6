"""Self-attention PINN, as ``pinnrl_tpu.models.attention``.

Each collocation point is its own length-1 sequence, so the softmax over
one key is identically 1 and a block acts as a gated MLP; the whole
multi-head Q/K/V computation is kept all the same, as the JAX package
computes it (and a gridded input would need it). Submodules carry flax's
names (``Dense_0`` input, ``SelfAttention_i`` with ``Dense_0..3`` and
``LayerNorm_0``, ``FeedForwardBlock_i`` with ``Dense_0, Dense_1,
LayerNorm_0``, ``Dense_1`` head), so the parameter bridge carries them as
they are. Every Dense kernel is drawn from normal(0.02) with a zero bias.
LayerNorm uses flax's eps 1e-6 in plain ops inside ``torch.func``
transforms (``models/base.layer_norm``): the residuals run through the
generic engine (nested jvp).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pinnrl_tpu_torch.models.base import Dense, get_activation, layer_norm

_INIT_STD = 0.02


def _dense(in_dim: int, out_dim: int, generator: Optional[torch.Generator]) -> Dense:
    layer = Dense(in_dim, out_dim)
    with torch.no_grad():
        layer.weight.normal_(0.0, _INIT_STD, generator=generator)
        layer.bias.zero_()
    return layer


class SelfAttention(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int = 4,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.hidden_dim, self.num_heads = int(hidden_dim), int(num_heads)
        for i in range(4):  # query, key, value, out-projection
            self.add_module(f"Dense_{i}", _dense(hidden_dim, hidden_dim, generator))
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head_dim = self.hidden_dim // self.num_heads

        def split(h):
            return h.reshape(*h.shape[:-1], self.num_heads, 1, head_dim)

        q, k, v = (split(getattr(self, f"Dense_{i}")(x)) for i in range(3))
        scores = torch.einsum("...hqd,...hkd->...hqk", q, k) / math.sqrt(head_dim)
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("...hqk,...hkd->...hqd", attn, v).reshape(*x.shape[:-1], self.hidden_dim)
        return layer_norm(self.LayerNorm_0, x + self.Dense_3(out))


class FeedForwardBlock(nn.Module):
    """Dense 4h -> act -> Dense h, then LayerNorm of the residual sum."""

    def __init__(self, hidden_dim: int, activation: str = "gelu",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.act = get_activation(activation)
        self.Dense_0 = _dense(hidden_dim, 4 * hidden_dim, generator)
        self.Dense_1 = _dense(4 * hidden_dim, hidden_dim, generator)
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(self.LayerNorm_0, x + self.Dense_1(self.act(self.Dense_0(x))))


class AttentionNetwork(nn.Module):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dim: int = 124,
        num_layers: int = 4,
        num_heads: int = 4,
        activation: str = "gelu",
        dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        # dropout is taken and applied nowhere, as in the JAX package.
        self.num_layers = int(num_layers)
        self.Dense_0 = _dense(input_dim, hidden_dim, generator)
        for i in range(self.num_layers):
            self.add_module(f"SelfAttention_{i}", SelfAttention(hidden_dim, num_heads, generator))
            self.add_module(f"FeedForwardBlock_{i}",
                            FeedForwardBlock(hidden_dim, activation, generator))
        self.Dense_1 = _dense(hidden_dim, output_dim, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.Dense_0(x)
        for i in range(self.num_layers):
            x = getattr(self, f"SelfAttention_{i}")(x)
            x = getattr(self, f"FeedForwardBlock_{i}")(x)
        return self.Dense_1(x)
