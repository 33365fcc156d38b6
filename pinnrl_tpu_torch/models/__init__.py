"""Model factory and the ``PINNModel`` apply wrapper.

``PINNModel`` holds an ``nn.Module`` and exposes the JAX package's pure
``apply(params, x, deterministic=True)`` contract: ``params`` is a name ->
tensor mapping of the trainable parameters (``model.params``), and buffers
such as a fixed Fourier basis come from the module. Inputs are mapped
affinely from the PDE domain to [-1, 1]^d (optionally in a co-moving frame)
before the network, and an optional ``output_transform(z, out)`` runs in
physical coordinates after it.

``deterministic=False`` turns dropout on, its masks drawn from the
``generator`` the caller passes (no path of the trainer does, as in the JAX
package). A deep ensemble's parameters carry a leading member axis on every
leaf (``is_ensemble_params``); ``apply`` then returns the members' mean
prediction, and ``model.ensemble``, once a trainer sets it, holds them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from pinnrl_tpu_torch.config import Config, ModelConfig, _asdict, resolve_device
from pinnrl_tpu_torch.models.attention import AttentionNetwork
from pinnrl_tpu_torch.models.autoencoder import AutoEncoder
from pinnrl_tpu_torch.models.base import count_parameters
from pinnrl_tpu_torch.models.feedforward import FeedForwardNetwork
from pinnrl_tpu_torch.models.fno import FNONetwork
from pinnrl_tpu_torch.models.fourier import FourierNetwork
from pinnrl_tpu_torch.models.resnet import ResNet
from pinnrl_tpu_torch.models.siren import SIREN

__all__ = [
    "PINNModel",
    "create_module",
    "AttentionNetwork",
    "AutoEncoder",
    "FeedForwardNetwork",
    "FNONetwork",
    "FourierNetwork",
    "ResNet",
    "SIREN",
    "count_parameters",
    "PORTED_ARCHITECTURES",
]

PORTED_ARCHITECTURES = ("attention", "autoencoder", "feedforward", "fno", "fourier", "resnet",
                        "siren")


def _parse_scale(v):
    """Fourier-feature scale: float, per-input-dim sequence, or "a:b" string."""
    if isinstance(v, str):
        parts = v.split(":")
        return tuple(float(p) for p in parts) if len(parts) > 1 else float(v)
    if isinstance(v, (list, tuple)):
        return tuple(float(p) for p in v)
    return float(v)


def create_module(model_cfg: ModelConfig, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build the torch module for a ModelConfig (on the CPU; move it after)."""
    arch = model_cfg.architecture
    ap = model_cfg.arch_params
    common = dict(input_dim=model_cfg.input_dim, output_dim=model_cfg.output_dim)
    if arch == "feedforward":
        return FeedForwardNetwork(
            hidden_dims=tuple(model_cfg.hidden_dims),
            activation=model_cfg.activation,
            dropout=model_cfg.dropout,
            layer_norm=model_cfg.layer_norm,
            generator=generator,
            **common,
        )
    if arch == "fourier":
        return FourierNetwork(
            hidden_dims=tuple(model_cfg.hidden_dims),
            mapping_size=int(ap.get("mapping_size", 512)),
            scale=_parse_scale(ap.get("scale", 4.0)),
            periodic=bool(ap.get("periodic", True)),
            modified=bool(ap.get("modified", False)),
            trainable_features=bool(ap.get("trainable_features", False)),
            feature_seed=ap.get("feature_seed"),
            activation=model_cfg.activation,
            dropout=model_cfg.dropout,
            layer_norm=model_cfg.layer_norm,
            generator=generator,
            **common,
        )
    if arch == "resnet":
        return ResNet(
            hidden_dim=model_cfg.hidden_dim,
            num_blocks=model_cfg.num_blocks,
            activation=model_cfg.activation,
            dropout=model_cfg.dropout,
            generator=generator,
            **common,
        )
    if arch == "siren":
        return SIREN(
            hidden_dims=tuple(model_cfg.hidden_dims),
            omega_0=float(ap.get("omega_0", 30.0)),
            generator=generator,
            **common,
        )
    if arch == "fno":
        return FNONetwork(
            hidden_dim=int(ap.get("hidden_dim", 256)),
            num_blocks=int(ap.get("num_blocks", 4)),
            modes=int(ap.get("modes", 16)),
            activation=model_cfg.activation if model_cfg.activation != "tanh" else "gelu",
            dropout=model_cfg.dropout,
            generator=generator,
            **common,
        )
    if arch == "attention":
        return AttentionNetwork(
            hidden_dim=int(ap.get("hidden_dim", 124)),
            num_layers=int(ap.get("num_layers", ap.get("num_blocks", 4))),
            num_heads=int(ap.get("num_heads", 4)),
            activation=model_cfg.activation if model_cfg.activation != "tanh" else "gelu",
            dropout=model_cfg.dropout,
            generator=generator,
            **common,
        )
    if arch == "autoencoder":
        return AutoEncoder(
            hidden_dims=tuple(model_cfg.hidden_dims),
            latent_dim=int(ap.get("latent_dim", 64)),
            activation=model_cfg.activation,
            dropout=model_cfg.dropout,
            layer_norm=model_cfg.layer_norm,
            generator=generator,
            **common,
        )
    raise ValueError(f"Unknown architecture {arch!r}; valid: {PORTED_ARCHITECTURES}")


class PINNModel:
    """Architecture factory + pure apply wrapper.

    Initialisation draws from a ``torch.Generator`` seeded with ``seed`` (on
    the CPU, so a seed gives the same weights on every device); it is not
    bit-identical to flax's init — the bridge carries JAX weights over.
    """

    def __init__(
        self,
        config: Config | ModelConfig,
        seed: int = 0,
        device: Optional[str | torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        model_cfg = config.model if isinstance(config, Config) else config
        self.config = model_cfg
        self.architecture_name = model_cfg.architecture
        if device is None:
            device = config.device if isinstance(config, Config) else resolve_device("cuda")
        self.device = torch.device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        self.module = create_module(model_cfg, gen).to(self.device)

        if isinstance(config, Config):
            lo = [d[0] for d in config.pde.domain] + [config.pde.time_domain[0]]
            hi = [d[1] for d in config.pde.domain] + [config.pde.time_domain[1]]
        else:
            lo = [0.0] * model_cfg.input_dim
            hi = [1.0] * model_cfg.input_dim
        self._in_lo = torch.tensor(lo, dtype=torch.float32, device=self.device)
        self._in_scale = 2.0 / (
            torch.tensor(hi, dtype=torch.float32, device=self.device) - self._in_lo
        )
        mf = model_cfg.arch_params.get("moving_frame_speed")
        self._frame_speed = float(mf) if mf is not None else None
        # u(z) = g(z, net(z)) in physical coordinates (e.g. hard IC).
        self.output_transform: Optional[Callable] = None
        self._leaf_ndim = {k: p.ndim for k, p in self.module.named_parameters()}
        # A deep ensemble's stacked parameters (leading member axis), set by
        # the trainer or load_state; None for one model.
        self.ensemble: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters by flax-compatible name: the module's,
        or an ensemble's stacked leaves."""
        if self.ensemble is not None:
            return dict(self.ensemble)
        return dict(self.module.named_parameters())

    @property
    def constants(self) -> Dict[str, torch.Tensor]:
        """The module's fixed buffers (e.g. ``FourierFeatures_0.B``)."""
        return dict(self.module.named_buffers())

    def is_ensemble_params(self, params) -> bool:
        return any(params[k].ndim == n + 1 for k, n in self._leaf_ndim.items() if k in params)

    def map_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """Physical (x_1..x_d, t) -> network input in [-1, 1]^(d+1)."""
        if self._frame_speed is not None:
            xs, t = x[..., :-1], x[..., -1:]
            x = torch.cat([xs - self._frame_speed * t, t], dim=-1)
        return (x - self._in_lo) * self._in_scale - 1.0

    def _net(self, params, x: torch.Tensor, deterministic: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        kwargs = {} if deterministic else {"deterministic": False, "generator": generator}
        return torch.func.functional_call(self.module, dict(params), (x,), kwargs)

    def apply(self, params, x: torch.Tensor, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Pure forward pass: ``x`` is (..., input_dim). Stacked ensemble
        parameters give the mean of the members' predictions."""
        w = self.map_inputs(x)
        if self.is_ensemble_params(params):
            members = next(iter(params.values())).shape[0]
            out = torch.stack([
                self._net({k: v[m] for k, v in params.items()}, w, deterministic, generator)
                for m in range(members)]).mean(dim=0)
        else:
            out = self._net(params, w, deterministic, generator)
        if self.output_transform is not None:
            out = self.output_transform(x, out)
        return out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params, x)

    def count_parameters(self) -> int:
        return count_parameters(self.module)

    def save_state(self, path: str) -> None:
        """The weights as ``.npz``, keyed by flax path (``params/Dense_0/kernel``,
        ``constants/FourierFeatures_0/B``: ``models/bridge.py``'s rules; an
        ensemble's stacked leaves), and the model config beside it
        (``.json``), as the JAX package's ``final_model.msgpack`` and its
        sidecar."""
        from pinnrl_tpu_torch.models.bridge import flat_flax_arrays

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        state = {**self.module.state_dict(), **(self.ensemble or {})}
        with open(path, "wb") as f:
            np.savez(f, **flat_flax_arrays(state, self._leaf_ndim))
        path.with_suffix(".json").write_text(json.dumps(_asdict(self.config), indent=2, default=str))

    def load_state(self, path: str) -> None:
        """Load weights that ``save_state`` wrote."""
        from pinnrl_tpu_torch.models.bridge import state_from_flat_flax

        with np.load(path) as data:
            state = state_from_flat_flax({k: data[k] for k in data.files})
        if self.is_ensemble_params({k: v for k, v in state.items() if k in self._leaf_ndim}):
            self.ensemble = {k: state.pop(k).to(self.device) for k in self._leaf_ndim}
            self.module.load_state_dict(state, strict=False)
            return
        self.ensemble = None
        self.module.load_state_dict(state, strict=True)
