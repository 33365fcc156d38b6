"""Autoencoder as a PINN function approximator, as
``pinnrl_tpu.models.autoencoder``: an encoder maps the coordinates to a
latent code, a decoder maps the code to the solution.

encoder: [Dense -> LayerNorm -> act] over ``hidden_dims``, then
``to_latent``; decoder: the same over the reversed widths, then
``to_output``. Submodules carry flax's names (``encoder_layers_i``,
``encoder_norms_i``, ``to_latent``, ``decoder_layers_i``,
``decoder_norms_i``, ``to_output``), so the parameter bridge is a rename.
LayerNorm uses flax's eps 1e-6 and runs in plain ops inside ``torch.func``
transforms (``models/base.layer_norm``). ``dropout`` is taken and applied
nowhere, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pinnrl_tpu_torch.models.base import dense, get_activation, layer_norm


class AutoEncoder(nn.Module):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dims: Sequence[int] = (124, 248, 124),
        latent_dim: int = 64,
        activation: str = "relu",
        dropout: float = 0.0,
        layer_norm: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.act = get_activation(activation)
        self.layer_norm = bool(layer_norm)
        self.n_hidden = len(hidden_dims)
        enc = [input_dim, *hidden_dims]
        for i in range(self.n_hidden):
            self.add_module(f"encoder_layers_{i}", dense(enc[i], enc[i + 1], generator))
            if self.layer_norm:
                self.add_module(f"encoder_norms_{i}", nn.LayerNorm(enc[i + 1], eps=1e-6))
        self.to_latent = dense(enc[-1], latent_dim, generator)
        dec = [latent_dim, *reversed(hidden_dims)]
        for i in range(self.n_hidden):
            self.add_module(f"decoder_layers_{i}", dense(dec[i], dec[i + 1], generator))
            if self.layer_norm:
                self.add_module(f"decoder_norms_{i}", nn.LayerNorm(dec[i + 1], eps=1e-6))
        self.to_output = dense(dec[-1], output_dim, generator)

    def _stack(self, x: torch.Tensor, part: str) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = getattr(self, f"{part}_layers_{i}")(x)
            if self.layer_norm:
                x = layer_norm(getattr(self, f"{part}_norms_{i}"), x)
            x = self.act(x)
        return x

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.to_latent(self._stack(x, "encoder"))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.to_output(self._stack(z, "decoder"))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.encode(x))
