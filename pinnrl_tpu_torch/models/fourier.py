"""Fourier-feature network: ``[sin(s x B), cos(s x B)]`` then an MLP trunk.

``B ~ N(0, scale^2)`` is a fixed (registered-buffer) projection, the
counterpart of the flax ``constants`` collection; ``s = 2 pi`` when periodic.
With ``trainable_features`` B is the parameter ``FourierFeatures_0.B``
instead (flax's ``params`` collection) and takes gradients. Batched inputs
go through the hand-written CUDA kernel (``ops/kernels/fourier_feats.py``)
on a CUDA tensor.

With ``feature_seed`` the basis is the JAX package's: its unit normal draws
``jax.random.normal(PRNGKey(feature_seed), (in_dim, mapping_size))``, bit
for bit from the threefry replica (``utils/prng.py``), scaled here exactly
as JAX scales them. Without it the basis comes from the model's generator.

The trunk is [Dense -> LayerNorm -> act -> Dropout] x L -> Dense, or with
``modified`` the modified MLP of Wang, Teng & Perdikaris: two encoder
streams u = act(enc_u(x)), v = act(enc_v(x)) of the embedding x gate every
layer, h <- (1 - z) u + z v with z = Dropout(act(LayerNorm(gate_i(h)))),
h starting at x; the hidden widths must be equal.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from pinnrl_tpu_torch.models.base import dense, dropout, get_activation, layer_norm
from pinnrl_tpu_torch.utils import prng


def feature_basis(seed: int, in_dim: int, mapping_size: int) -> torch.Tensor:
    """The unit normal basis JAX draws from ``PRNGKey(seed)``, (in_dim, m) f32."""
    return torch.from_numpy(prng.normal(prng.PRNGKey(seed), (int(in_dim), int(mapping_size))))


class FourierFeatures(nn.Module):
    def __init__(
        self,
        in_dim: int,
        mapping_size: int = 512,
        scale: float | tuple = 4.0,
        periodic: bool = True,
        generator: Optional[torch.Generator] = None,
        feature_seed: Optional[int] = None,
        trainable: bool = False,
    ) -> None:
        super().__init__()
        self.periodic = bool(periodic)
        s = torch.as_tensor(scale, dtype=torch.float32)
        if s.ndim == 1 and s.shape[0] != in_dim:
            raise ValueError(f"anisotropic scale needs {in_dim} entries, got {s.shape[0]}")
        if s.ndim == 1:
            s = s[:, None]  # one scale per input dimension (row of B)
        if feature_seed is not None:
            unit = feature_basis(feature_seed, in_dim, mapping_size)
        else:
            unit = torch.randn(in_dim, mapping_size, generator=generator)
        B = s * unit
        if trainable:
            self.B = nn.Parameter(B)
        else:
            self.register_buffer("B", B)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 2:
            from pinnrl_tpu_torch.ops.kernels.fourier_feats import fourier_features

            return fourier_features(x, self.B, self.periodic)
        proj = x @ self.B
        if self.periodic:
            proj = 2.0 * math.pi * proj
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class FourierNetwork(nn.Module):
    """Fourier embedding + the plain or the modified trunk.

    Submodules carry flax's names (``FourierFeatures_0``, ``Dense_i``,
    ``LayerNorm_i``; modified: ``enc_u``, ``enc_v``, ``gate_i``,
    ``LayerNorm_i`` and the head ``Dense_0``) so the parameter bridge is a
    rename. LayerNorm uses flax's eps 1e-6 (torch's default is 1e-5).
    """

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dims: Sequence[int] = (512,) * 4,
        mapping_size: int = 512,
        scale: float | tuple = 4.0,
        periodic: bool = True,
        activation: str = "tanh",
        dropout: float = 0.0,
        layer_norm: bool = True,
        modified: bool = False,
        trainable_features: bool = False,
        feature_seed: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.act = get_activation(activation)
        self.layer_norm = bool(layer_norm)
        self.dropout = float(dropout)
        self.modified = bool(modified)
        self.n_hidden = len(hidden_dims)
        self.FourierFeatures_0 = FourierFeatures(
            input_dim, mapping_size, scale, periodic, generator=generator,
            feature_seed=feature_seed, trainable=trainable_features,
        )
        if self.modified:
            if len(set(hidden_dims)) != 1:
                raise ValueError(
                    f"modified MLP needs uniform hidden widths, got {tuple(hidden_dims)}")
            width = hidden_dims[0]
            self.enc_u = dense(2 * mapping_size, width, generator)
            self.enc_v = dense(2 * mapping_size, width, generator)
            for i in range(self.n_hidden):
                self.add_module(f"gate_{i}", dense(2 * mapping_size if i == 0 else width, width,
                                                   generator))
                if self.layer_norm:
                    self.add_module(f"LayerNorm_{i}", nn.LayerNorm(width, eps=1e-6))
            self.Dense_0 = dense(width, output_dim, generator)
            return
        widths = [2 * mapping_size, *hidden_dims]
        for i in range(self.n_hidden):
            self.add_module(f"Dense_{i}", dense(widths[i], widths[i + 1], generator))
            if self.layer_norm:
                self.add_module(f"LayerNorm_{i}", nn.LayerNorm(widths[i + 1], eps=1e-6))
        self.add_module(f"Dense_{self.n_hidden}", dense(widths[-1], output_dim, generator))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.FourierFeatures_0(x)
        if self.modified:
            u = self.act(self.enc_u(x))
            v = self.act(self.enc_v(x))
            h = x
            for i in range(self.n_hidden):
                z = getattr(self, f"gate_{i}")(h)
                if self.layer_norm:
                    z = layer_norm(getattr(self, f"LayerNorm_{i}"), z)
                z = dropout(self.act(z), self.dropout, deterministic, generator)
                h = (1.0 - z) * u + z * v
            return self.Dense_0(h)
        for i in range(self.n_hidden):
            x = getattr(self, f"Dense_{i}")(x)
            if self.layer_norm:
                x = layer_norm(getattr(self, f"LayerNorm_{i}"), x)
            x = dropout(self.act(x), self.dropout, deterministic, generator)
        return getattr(self, f"Dense_{self.n_hidden}")(x)
