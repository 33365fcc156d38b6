"""Fourier-feature network: ``[sin(s x B), cos(s x B)]`` then an MLP trunk.

``B ~ N(0, scale^2)`` is a fixed (registered-buffer) projection, the
counterpart of the flax ``constants`` collection; ``s = 2 pi`` when periodic.
Batched inputs go through the hand-written CUDA kernel
(``ops/kernels/fourier_feats.py``) on a CUDA tensor.

With ``feature_seed`` the basis is the JAX package's: its unit normal draws
``jax.random.normal(PRNGKey(feature_seed), (in_dim, mapping_size))`` are
shipped as data in ``config/feature_bases.json`` (threefry cannot be drawn
without JAX), and scaled here exactly as JAX scales them.
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path
from typing import Optional, Sequence

import torch
from torch import nn

from pinnrl_tpu_torch.models.base import dense, get_activation, layer_norm

_BASES_JSON = Path(__file__).resolve().parents[1] / "config" / "feature_bases.json"


@functools.lru_cache(maxsize=None)
def _shipped_bases() -> dict:
    return json.loads(_BASES_JSON.read_text())


def feature_basis(seed: int, in_dim: int, mapping_size: int) -> torch.Tensor:
    """The unit normal basis JAX draws from ``PRNGKey(seed)``, (in_dim, m) f32."""
    key = f"seed{int(seed)}_{int(in_dim)}x{int(mapping_size)}"
    rows = _shipped_bases().get(key)
    if rows is None:
        raise NotImplementedError(
            f"no shipped Fourier basis {key!r} in config/feature_bases.json "
            f"(have {sorted(_shipped_bases())}); other feature seeds are ROADMAP item 12"
        )
    return torch.tensor(rows, dtype=torch.float32)


class FourierFeatures(nn.Module):
    def __init__(
        self,
        in_dim: int,
        mapping_size: int = 512,
        scale: float | tuple = 4.0,
        periodic: bool = True,
        generator: Optional[torch.Generator] = None,
        feature_seed: Optional[int] = None,
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
    """Fourier embedding + [Dense -> LayerNorm -> act] x L -> Dense.

    Submodules carry flax's names (``FourierFeatures_0``, ``Dense_i``,
    ``LayerNorm_i``) so the parameter bridge is a rename. LayerNorm uses
    flax's eps 1e-6 (torch's default is 1e-5).
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
        if modified:
            raise NotImplementedError(
                "the modified-MLP Fourier trunk is not ported yet (ROADMAP item 12)"
            )
        if trainable_features:
            raise NotImplementedError(
                "trainable Fourier features are not ported yet (ROADMAP item 12)"
            )
        if dropout > 0.0:
            raise NotImplementedError("dropout is not ported yet (ROADMAP item 12)")
        self.act = get_activation(activation)
        self.layer_norm = bool(layer_norm)
        self.n_hidden = len(hidden_dims)
        self.FourierFeatures_0 = FourierFeatures(
            input_dim, mapping_size, scale, periodic, generator=generator,
            feature_seed=feature_seed,
        )
        widths = [2 * mapping_size, *hidden_dims]
        for i in range(self.n_hidden):
            self.add_module(f"Dense_{i}", dense(widths[i], widths[i + 1], generator))
            if self.layer_norm:
                self.add_module(f"LayerNorm_{i}", nn.LayerNorm(widths[i + 1], eps=1e-6))
        self.add_module(f"Dense_{self.n_hidden}", dense(widths[-1], output_dim, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.FourierFeatures_0(x)
        for i in range(self.n_hidden):
            x = getattr(self, f"Dense_{i}")(x)
            if self.layer_norm:
                x = layer_norm(getattr(self, f"LayerNorm_{i}"), x)
            x = self.act(x)
        return getattr(self, f"Dense_{self.n_hidden}")(x)
