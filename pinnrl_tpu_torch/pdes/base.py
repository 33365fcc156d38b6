"""PDE problem base class: physics, BC/IC targets, sampling, loss assembly.

The counterpart of ``pinnrl_tpu.pdes.base``. A PDE subclass writes its
residual against ``u`` / ``directional_derivative`` / ``laplacian``; ``u``
is the stacked-jet :class:`BundleView` where the model supports it and the
batched scalar network otherwise (the generic engine, nested jvp:
``ops/derivatives.py``), so the residual runs batched over the collocation
points either way. A PDE posed as an auxiliary system (``system_size`` k >
1: Cahn-Hilliard's mixed form, KdV's first-order form) writes
``residual_pointwise_system`` against the batched restriction of the
network to its first k channels, and its residual is (N, k). Randomness
comes from an explicit ``torch.Generator`` instead of a PRNG key; where a
test must feed JAX's draws, the public function takes the draws and hands
them as tensors to a deterministic helper (``_periodic_terms``,
``_neumann_terms``, ``_validate_on``).

The ``random`` initial condition is JAX's fixed random Fourier series,
drawn bit for bit by the threefry replica (``utils/prng.py``).

Inverse and data modes: the coefficients named in ``trainable_parameters``
are 0-d float32 tensors on the PDE's device (``init_coeffs``, seeded from
the initial guesses), which the trainer optimizes with the network and
passes to every loss; ``coeff`` hands the live tensor to the residual, so
the gradient reaches it. Observations (``set_observations``: an ``.npz``
path, a dict, an (x, t, u) tuple or a The Well spec ``{"source": "well",
"name": ..., ...}`` (``datasets.load_well_slice``'s arguments) through
``observation_data``, or ``generate_synthetic_observations`` at the true
coefficients) add the data term, which draws nothing.

The loss's optional terms, as the JAX package computes them: the
finite-difference smoothness penalty (``loss_weights.smoothness``), the
gPINN penalty (``loss_weights.gpinn``: mean over points of |dr/dz|^2, one
``torch.func.jvp`` of the batched residual per input axis on the nested-jvp
engine) and the hard-IC output transform (``hard_ic_transform``). None of
them draws, so the generator's stream is JAX's order of draws.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pinnrl_tpu_torch.config import PDESettings, TrainingConfig, resolve_device
from pinnrl_tpu_torch.ops.derivatives import (
    _tangent,
    derivative_bundle,
    make_scalar_fn,
    value_and_derivative,
)
from pinnrl_tpu_torch.ops.losses import apply_loss_fn
from pinnrl_tpu_torch.sampling import (
    sample_adaptive,
    sample_residual_based,
    sample_stratified,
    sample_uniform,
)
from pinnrl_tpu_torch.sampling.strategies import _bounds
from pinnrl_tpu_torch.utils import prng

Coeffs = Dict[str, torch.Tensor]

# Populated by @register_pde; maps pde_type -> class.
PDE_CLASSES: Dict[str, type] = {}
_ALIASES = {
    "heatequation": "heat",
    "waveequation": "wave",
    "burgersequation": "burgers",
    "kdvequation": "kdv",
    "convectionequation": "convection",
    "allencahn": "allen_cahn",
    "cahnhilliard": "cahn_hilliard",
    "blackscholes": "black_scholes",
    "pendulumequation": "pendulum",
}
def random_ic_basis(seed: int, n_modes: int, dimension: int):
    """(W (dimension, n_modes), phase (n_modes,), amp (n_modes,)) float32:
    the random Fourier series JAX draws for the ``random`` IC from
    ``split(PRNGKey(seed), 3)`` (W scaled by 4, phase uniform in [0, 2 pi),
    amp by 1/sqrt(n_modes), as JAX does)."""
    n_modes, dimension = int(n_modes), int(dimension)
    k_w, k_p, k_a = prng.split(prng.PRNGKey(seed), 3)
    f32 = np.float32
    W = prng.normal(k_w, (dimension, n_modes)) * f32(4.0)
    phase = prng.uniform(k_p, (n_modes,), maxval=2 * np.pi)
    amp = prng.normal(k_a, (n_modes,)) / np.sqrt(f32(n_modes))
    return tuple(torch.from_numpy(np.asarray(a, f32)) for a in (W, phase, amp))


def register_pde(cls):
    PDE_CLASSES[cls.pde_type] = cls
    return cls


def _default_generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


class PDEBase:
    """Base PDE problem."""

    pde_type = "base"
    default_parameters: Dict[str, Any] = {}
    system_size: int = 1
    spatial_orders: Tuple[int, ...] = (1, 2)
    temporal_orders: Tuple[int, ...] = (1,)
    bundle_compatible: bool = True

    def __init__(self, settings: PDESettings, training: Optional[TrainingConfig] = None,
                 device: Optional[str] = None) -> None:
        self.settings = settings
        self.training = training
        # Where the PDE builds what it holds itself (a reference trajectory).
        self.device = torch.device(resolve_device(device))
        self.dimension = int(settings.dimension)
        self.domain = [(float(lo), float(hi)) for lo, hi in settings.domain]
        self.time_domain = (float(settings.time_domain[0]), float(settings.time_domain[1]))
        self.parameters: Dict[str, Any] = {**self.default_parameters, **(settings.parameters or {})}
        # Inverse problems: the true values stay in ``self.parameters``; the
        # initial guesses seed the coefficients ``init_coeffs`` returns.
        self.trainable_parameters = list(settings.trainable_parameters or [])
        self._true_parameters = {k: float(self.parameters[k]) for k in self.trainable_parameters}
        self._initial_guesses = {
            k: float((settings.parameter_initial_guesses or {}).get(k, self.parameters[k]))
            for k in self.trainable_parameters
        }
        # Observations (x (N, d), t (N, 1), u (N, k)) for the data term.
        self.observations: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
        if settings.observation_data is not None:
            self._load_observation_data(settings.observation_data)

        self.boundary_conditions: Dict[str, Callable] = {}
        for bc_type, bc_params in (settings.boundary_conditions or {}).items():
            self.boundary_conditions[bc_type] = self._create_boundary_condition(
                bc_type, bc_params or {}
            )
        if settings.initial_condition:
            self.boundary_conditions["initial"] = self._create_boundary_condition(
                "initial", settings.initial_condition
            )
        self._fast_bundle_fn = None
        self._fused_residual_loss = None

    @staticmethod
    def create(pde_type: str, settings: PDESettings, training: Optional[TrainingConfig] = None,
               device: Optional[str] = None):
        """Name-based factory; ``device`` as ``resolve_device`` reads it (the
        card unless the caller asks for the CPU)."""
        key = pde_type.lower().replace("-", "_").replace(" ", "_")
        key = {"heat_2d": "heat", "heat2d": "heat"}.get(key, key)
        key = _ALIASES.get(key, key)
        if key not in PDE_CLASSES:
            raise ValueError(f"Unknown PDE type {pde_type!r}; valid: {sorted(PDE_CLASSES)}")
        return PDE_CLASSES[key](settings, training, device=device)

    # ------------------------------------------------------------------ #
    # Coefficients
    # ------------------------------------------------------------------ #

    def init_coeffs(self) -> Coeffs:
        """The trainable coefficients, 0-d float32 tensors on the PDE's
        device, seeded from the initial guesses."""
        return {k: torch.tensor(v, dtype=torch.float32, device=self.device)
                for k, v in self._initial_guesses.items()}

    def coeff(self, coeffs: Optional[Coeffs], name: str, default: Any = None):
        if coeffs is not None and name in coeffs:
            return coeffs[name]
        if name in self.parameters:
            val = self.parameters[name]
            return val if isinstance(val, (list, tuple)) else float(val)
        if default is not None:
            return default
        raise KeyError(f"PDE parameter {name!r} not configured and no default")

    def canonicalize_coeffs(self, coeffs: Dict[str, float]) -> Dict[str, float]:
        """The canonical representative of identified coefficients where the
        PDE fixes a parameter only up to a symmetry (Black-Scholes' sigma
        enters as sigma^2). Identity by default."""
        return dict(coeffs)

    @property
    def true_parameters(self) -> Dict[str, float]:
        return dict(self._true_parameters)

    def get_trainable_parameter_values(self, coeffs: Coeffs) -> Dict[str, float]:
        return {k: float(v.detach()) for k, v in coeffs.items()}

    # ------------------------------------------------------------------ #
    # Physics
    # ------------------------------------------------------------------ #

    def residual_pointwise(self, u, z: torch.Tensor, coeffs: Optional[Coeffs]) -> torch.Tensor:
        raise NotImplementedError

    def residual_pointwise_system(self, uvec, z: torch.Tensor,
                                  coeffs: Optional[Coeffs]) -> torch.Tensor:
        """The residual vector of an auxiliary system, batched: ``uvec``
        maps z (N, d+1) to the first ``system_size`` channels (N, k); returns
        (N, k) (dynamics and compatibility residuals)."""
        raise NotImplementedError

    def exact_solution(self, x: torch.Tensor, t: torch.Tensor, coeffs: Optional[Coeffs] = None):
        return None

    def attach_fast_bundle(self, model, enable: str | bool = "auto") -> bool:
        """Attach the stacked-jet residual path for ``model``; returns
        whether it is active."""
        from pinnrl_tpu_torch.ops import jet_mlp

        if enable in (False, "off", "false"):
            self._fast_bundle_fn = None
            return False
        if enable == "on":
            enable = True
        ok = self.bundle_compatible and self.system_size == 1 and jet_mlp.supports(model, self)
        if not ok:
            if enable is True:
                raise ValueError(
                    "stacked_jet=true but the PDE/model pair does not support "
                    f"the fast bundle path (pde={self.pde_type}, "
                    f"arch={model.config.architecture})"
                )
            self._fast_bundle_fn = None
            return False
        self._fast_bundle_fn = jet_mlp.make_bundle_fn(
            model,
            self.dimension,
            spatial_order=max(self.spatial_orders, default=0),
            temporal_order=max(self.temporal_orders, default=0),
        )
        return True

    def attach_fused_residual_kernel(self, model, enable: str | bool = "auto") -> bool:
        """Attach the fused residual-loss kernel (ops/kernels/fused_step.py):
        hand-written CUDA kernels compute the (causally weighted) mean r^2
        and its parameter gradient. On CPU tensors the same callable runs its plain version."""
        from pinnrl_tpu_torch.ops.kernels import fused_step

        if enable in (False, "off", "false"):
            self._fused_residual_loss = None
            return False
        if not fused_step.supports(model, self, self.training):
            if enable is True or enable == "on":
                raise ValueError(
                    "fused residual kernel requested but unsupported for "
                    f"pde={self.pde_type}, arch={model.config.architecture}"
                )
            self._fused_residual_loss = None
            return False
        self._fused_residual_loss = fused_step.make_fused_residual_loss(model, self)
        return True

    def _scalar_u(self, apply_fn: Callable, params):
        """The batched scalar restriction of the network (channel 0)."""
        return make_scalar_fn(apply_fn, params)

    def compute_residual(self, apply_fn, params, x, t, coeffs: Optional[Coeffs] = None) -> torch.Tensor:
        """Batched residual: (N, system_size) for an auxiliary system, else
        (N, 1) through the stacked-jet bundle when it is attached or the
        generic engine (nested jvp of the network; also for an ensemble's
        stacked parameters)."""
        z = torch.cat([x, t], dim=-1)
        if self.system_size > 1:
            k = self.system_size

            def uvec(zz: torch.Tensor) -> torch.Tensor:
                return apply_fn(params, zz).reshape(zz.shape[0], -1)[:, :k]

            return self.residual_pointwise_system(uvec, z, coeffs).reshape(-1, k)
        model = getattr(apply_fn, "__self__", None)
        ensemble = model is not None and model.is_ensemble_params(params)
        # An ensemble's stacked parameters: the mean predictor's residual,
        # through the generic engine (the bundle evaluates one network).
        if self._fast_bundle_fn is not None and not ensemble:
            from pinnrl_tpu_torch.ops.jet_mlp import BundleView

            value, streams = self._fast_bundle_fn(params, z)
            return self.residual_pointwise(BundleView(value, streams), z, coeffs).reshape(-1, 1)
        u = self._scalar_u(apply_fn, params)
        return self.residual_pointwise(u, z, coeffs).reshape(-1, 1)

    def residual_score(self, apply_fn, params, x, t, coeffs: Optional[Coeffs] = None) -> torch.Tensor:
        """Per-point residual magnitude, shape (N,): RAR pool scoring and the
        RL reward. Channels of a system residual are l2-collapsed. Callers
        run it under ``torch.no_grad()``."""
        r = self.compute_residual(apply_fn, params, x, t, coeffs)
        if r.ndim == 2 and r.shape[1] > 1:
            return torch.sqrt(torch.sum(r * r, dim=1))
        return torch.abs(r.reshape(-1))

    def compute_derivatives(self, apply_fn: Callable, params, x: torch.Tensor, t: torch.Tensor,
                            spatial_derivatives=(1, 2),
                            temporal_derivatives=(1,)) -> Dict[str, torch.Tensor]:
        """The JAX package's derivative dictionary (``u``, ``dt``/``dt2``,
        ``dx``/``dx2``.. in 1-D, ``dx1``, ``dx1x1``.. in N-D, ``laplacian``
        with order 2), each (N, 1), batched over the points through the
        derivative engine (nested jvp of the network's channel 0)."""
        u = self._scalar_u(apply_fn, params)
        z = torch.cat([x, t], dim=-1)
        bundle = derivative_bundle(u, z, self.dimension, tuple(spatial_derivatives),
                                   tuple(temporal_derivatives))
        return {k: v.reshape(-1, 1) for k, v in bundle.items()}

    # ------------------------------------------------------------------ #
    # BC / IC targets
    # ------------------------------------------------------------------ #

    def _create_boundary_condition(self, bc_type: str, params: Dict[str, Any]) -> Callable:
        if bc_type in ("left", "right"):
            bc_type = "dirichlet"
        if bc_type == "dirichlet":
            if params.get("type") == "exact":
                if not self.settings.exact_solution:
                    raise ValueError(
                        f"{self.pde_type}: boundary type 'exact' requires an "
                        "exact_solution config block"
                    )
                return lambda x, t: self.exact_solution(x, t)
            value = float(params.get("value", 0.0) or 0.0)
            return lambda x, t: torch.full_like(x[:, 0:1], value)
        if bc_type in ("neumann", "periodic"):
            # Enforced structurally in _boundary_loss: the Neumann target is
            # the outward normal derivative's; periodic has none.
            value = float(params.get("value", 0.0) or 0.0) if bc_type == "neumann" else 0.0
            return lambda x, t: torch.full_like(x[:, 0:1], value)
        if bc_type == "initial":
            return self._create_initial_condition(params)
        return lambda x, t: torch.zeros_like(x[:, 0:1])

    def _create_initial_condition(self, params: Dict[str, Any]) -> Callable:
        ic_type = params.get("type", "sine")
        if ic_type == "exact":
            if not self.settings.exact_solution:
                raise ValueError(
                    f"{self.pde_type}: initial type 'exact' requires an "
                    "exact_solution config block"
                )
            return lambda x, t: self.exact_solution(x, t)
        if ic_type in ("sine", "sin", "sin_exp_decay"):
            A = float(params.get("amplitude", 1.0))
            k = float(params.get("frequency", 1.0))
            return lambda x, t: A * torch.sin(k * torch.pi * x[:, 0:1])
        if ic_type == "tanh":
            eps = float(params.get("epsilon", 0.1))
            return lambda x, t: torch.tanh(x[:, 0:1] / eps)
        if ic_type == "gaussian":
            mean = float(params.get("mean", params.get("center", 0.0)))
            std = float(params.get("std", params.get("sigma", 0.1)))
            A = float(params.get("amplitude", 1.0))
            return lambda x, t: A * torch.exp(-((x[:, 0:1] - mean) ** 2) / (2 * std**2))
        if ic_type == "fixed":
            value = float(params.get("value", 0.0))
            return lambda x, t: torch.full_like(x[:, 0:1], value)
        if ic_type == "random":
            # A fixed random Fourier series of the coordinates, JAX's draws.
            amplitude = float(params.get("amplitude", 0.1))
            W, phase, amp = (a.to(self.device) for a in random_ic_basis(
                int(params.get("seed", 0)), int(params.get("n_modes", 16)), self.dimension))

            def random_ic(x, t):
                feats = torch.sin(x[:, : self.dimension] @ W + phase)
                return amplitude * (feats @ amp).reshape(-1, 1)

            return random_ic
        if ic_type == "small_angle":
            theta0 = float(params.get("initial_angle", 0.5))
            return lambda x, t: torch.full_like(x[:, 0:1], theta0)
        if ic_type == "option":
            strike = float(params.get("strike", params.get("strike_price", 100.0)))
            if params.get("option_type", "call") == "call":
                return lambda x, t: torch.clamp(x[:, 0:1] - strike, min=0.0)
            return lambda x, t: torch.clamp(strike - x[:, 0:1], min=0.0)
        return lambda x, t: torch.zeros_like(x[:, 0:1])

    # ------------------------------------------------------------------ #
    # Sampling
    # ------------------------------------------------------------------ #

    def generate_collocation_points(self, generator: torch.Generator, num_points: int,
                                    strategy: str = "uniform",
                                    residual_fn: Optional[Callable] = None,
                                    score_fn: Optional[Callable] = None, **kwargs):
        """Strategy dispatcher. Extra ``kwargs`` go to RAR (``pool_factor``,
        ``uniform_floor``, ``power``: the RAD hyper-parameters)."""
        if strategy == "uniform":
            return sample_uniform(generator, num_points, self.domain, self.time_domain)
        if strategy == "stratified":
            return sample_stratified(generator, num_points, self.domain, self.time_domain)
        if strategy == "residual_based":
            return sample_residual_based(generator, num_points, self.domain, self.time_domain,
                                         residual_fn=residual_fn, **kwargs)
        if strategy == "adaptive":
            return sample_adaptive(generator, num_points, self.domain, self.time_domain,
                                   score_fn=score_fn)
        raise ValueError(f"Unknown sampling strategy {strategy!r}")

    # ------------------------------------------------------------------ #
    # Observations (inverse and data modes)
    # ------------------------------------------------------------------ #

    def _load_observation_data(self, spec: Any) -> None:
        """An ``.npz`` path with keys x, t, u, a dict of arrays, an (x, t, u)
        tuple, or a The Well spec (``{"source": "well", ...}``: the rest are
        ``load_well_slice``'s arguments)."""
        if isinstance(spec, dict) and spec.get("source") == "well":
            from pinnrl_tpu_torch.datasets import load_well_slice

            arrs = load_well_slice(**{k: v for k, v in spec.items() if k != "source"})
            self.set_observations(arrs["x"], arrs["t"], arrs["u"])
            return
        if isinstance(spec, str):
            with np.load(spec) as data:
                self.set_observations(data["x"], data["t"], data["u"])
            return
        if isinstance(spec, dict):
            self.set_observations(spec["x"], spec["t"], spec["u"])
            return
        if isinstance(spec, (tuple, list)) and len(spec) == 3:
            self.set_observations(*spec)
            return
        raise ValueError(f"Unsupported observation_data spec: {type(spec)}")

    def set_observations(self, x, t, u) -> None:
        """Arrays or tensors -> float32 tensors on the PDE's device, shaped
        (N, d), (N, 1) and (N, k)."""
        kw = dict(dtype=torch.float32, device=self.device)
        x = torch.as_tensor(x, **kw).reshape(-1, self.dimension)
        t = torch.as_tensor(t, **kw).reshape(-1, 1)
        u = torch.as_tensor(u, **kw).reshape(x.shape[0], -1)
        self.observations = (x, t, u)

    def generate_synthetic_observations(self, generator: torch.Generator, num_points: int = 200,
                                        noise: float = 0.0) -> None:
        """Uniform points from ``generator``, the exact solution there at the
        TRUE coefficients (``coeffs=None`` reads the configured values), plus
        Gaussian noise of standard deviation ``noise`` from ``generator``."""
        x, t = sample_uniform(generator, num_points, self.domain, self.time_domain)
        u = self.exact_solution(x, t, coeffs=None)
        if u is None:
            raise ValueError(f"{self.pde_type}: no exact solution to synthesize observations from")
        if noise > 0:
            u = u + noise * torch.randn(u.shape, generator=generator, device=generator.device)
        self.set_observations(x, t, u)

    def _compute_data_loss(self, apply_fn: Callable, params) -> Optional[torch.Tensor]:
        """The observation misfit; None without observations."""
        if self.observations is None:
            return None
        x_obs, t_obs, u_obs = self.observations
        pred = apply_fn(params, torch.cat([x_obs, t_obs], dim=-1)).reshape(u_obs.shape[0], -1)
        return self._loss(pred - u_obs)

    def _bc_counts(self, n_colloc: int) -> Tuple[int, int]:
        """(num_boundary_points, num_initial_points) as configured; sized
        from the collocation batch when unconfigured."""
        n_b = n_i = 0
        if self.training is not None:
            n_b = int(getattr(self.training, "num_boundary_points", 0) or 0)
            n_i = int(getattr(self.training, "num_initial_points", 0) or 0)
        if n_b <= 0:
            n_b = max(n_colloc // 10, 16)
        if n_i <= 0:
            n_i = max(n_colloc // 5, 16)
        return n_b, n_i

    def _space_bounds(self, device):
        """The spatial bounds as tensors, cached per device (building them
        is a host-to-device copy, which would make every step wait)."""
        lo, hi = _bounds(self.domain, self.time_domain, device)
        return lo[:-1], hi[:-1]

    def _uniform(self, generator, n: int, lo, hi):
        u = torch.rand((n, lo.shape[0]), generator=generator, device=generator.device)
        return lo + (hi - lo) * u

    def _sample_boundary_time(self, generator: torch.Generator, n: int) -> torch.Tensor:
        lo, hi = self.time_domain
        u = torch.rand((n, 1), generator=generator, device=generator.device)
        return lo + (hi - lo) * u

    def _sample_face(self, generator: torch.Generator, n: int, axis: int, face_val: float):
        """n points on one face: the pinned coordinate at the face value."""
        los, his = self._space_bounds(generator.device)
        x = self._uniform(generator, n, los, his)
        x[:, axis] = face_val
        return x

    def _sample_boundary_points(self, generator: torch.Generator, n: int):
        """Fresh boundary points, ``n`` split evenly across the 2*dim faces."""
        per_face = max(n // (2 * self.dimension), 1)
        xs, ts = [], []
        for axis in range(self.dimension):
            for face_val in self.domain[axis]:
                xs.append(self._sample_face(generator, per_face, axis, face_val))
                ts.append(self._sample_boundary_time(generator, per_face))
        return torch.cat(xs, dim=0), torch.cat(ts, dim=0)

    def _sample_initial_points(self, generator: torch.Generator, n: int):
        """Fresh spatial points at ``time_domain[0]``."""
        los, his = self._space_bounds(generator.device)
        x = self._uniform(generator, n, los, his)
        return x, torch.full((n, 1), self.time_domain[0], dtype=torch.float32, device=x.device)

    # ------------------------------------------------------------------ #
    # Loss assembly
    # ------------------------------------------------------------------ #

    def _loss(self, diff: torch.Tensor) -> torch.Tensor:
        lf, delta = "mse", 1.0
        if self.training is not None:
            lf = getattr(self.training, "loss_function", "mse")
            delta = float(getattr(self.training, "huber_delta", 1.0))
        return apply_loss_fn(diff, lf, delta)

    def causal_eps(self) -> float:
        """``training.causal_eps`` (0 without a training config)."""
        return float(getattr(self.training, "causal_eps", 0.0) or 0.0) if self.training else 0.0

    def _residual_loss(self, residual: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Residual reduction; with ``training.causal_eps > 0`` points are
        sorted by time and weighted w_i = exp(-eps * sum_{t_j < t_i} r_j^2 / N)
        (weights carry no gradient)."""
        eps = self.causal_eps()
        if eps <= 0.0:
            return self._loss(residual)
        if residual.ndim == 2 and residual.shape[1] > 1:
            r2 = torch.sum(residual**2, dim=1)
        else:
            r2 = residual.reshape(-1) ** 2
        order = torch.argsort(t.reshape(-1), stable=True)
        r2_sorted = r2[order]
        n = r2_sorted.shape[0]
        cum_prev = torch.cumsum(r2_sorted, dim=0) - r2_sorted
        w = torch.exp(-eps * cum_prev / n).detach()
        return torch.sum(w * r2_sorted) / torch.clamp(torch.sum(w), min=1e-12)

    def _training_mode(self) -> str:
        return getattr(self.training, "mode", "forward") if self.training else "forward"

    def _loss_weights(self) -> Dict[str, float]:
        if self.training is None:
            return {}
        return dict(getattr(self.training, "loss_weights", {}) or {})

    def _periodic_loss(self, u_scalar, generator: torch.Generator, n: int) -> torch.Tensor:
        """True periodicity: opposite-face value and first-derivative
        matching per axis, on ``n // (2 dim)`` fresh points per axis (free
        coordinates uniform, times from ``_sample_boundary_time``)."""
        per_axis = max(n // (2 * self.dimension), 1)
        los, his = self._space_bounds(generator.device)
        draws = []
        for _axis in range(self.dimension):
            free = self._uniform(generator, per_axis, los, his)
            draws.append((free, self._sample_boundary_time(generator, per_axis)))
        return self._periodic_terms(u_scalar, draws)

    def _periodic_terms(self, u_scalar, draws) -> torch.Tensor:
        """The periodic loss on given draws: per axis, ``(free, t)`` with
        ``free`` (n, dim) and ``t`` (n, 1). The low and high faces go through
        the network as one batch, and one jvp gives value and derivative."""
        loss = torch.zeros((), device=draws[0][0].device)
        for axis, (free, t_ax) in enumerate(draws):
            n = free.shape[0]
            z = torch.cat([torch.cat([free, t_ax], dim=1)] * 2, dim=0)
            z[:n, axis] = self.domain[axis][0]
            z[n:, axis] = self.domain[axis][1]
            u, du = value_and_derivative(u_scalar, z, axis)
            loss = loss + self._loss(u[:n] - u[n:])
            loss = loss + self._loss(du[:n] - du[n:])
        return loss

    def _neumann_loss(self, u_scalar, bc_func: Callable, generator: torch.Generator,
                      n: int) -> torch.Tensor:
        """The outward normal derivative matched to the target on ``n //
        (2 dim)`` fresh points per face, drawn as ``_sample_boundary_points``
        draws them: per axis, the low face then the high, each x then t."""
        per_face = max(n // (2 * self.dimension), 1)
        draws = []
        for axis in range(self.dimension):
            for face_val in self.domain[axis]:
                x_f = self._sample_face(generator, per_face, axis, face_val)
                draws.append((x_f, self._sample_boundary_time(generator, per_face)))
        return self._neumann_terms(u_scalar, bc_func, draws)

    def _neumann_terms(self, u_scalar, bc_func: Callable, draws) -> torch.Tensor:
        """The Neumann loss on given draws: ``[(x_f, t_f), ...]`` per face in
        ``_neumann_loss``'s order. Every face goes through one jvp, each row
        with its face's outward normal as tangent (-e_axis on the low face,
        +e_axis on the high), which gives the outward normal derivative."""
        faces = [torch.cat([x_f, t_f], dim=1) for x_f, t_f in draws]
        normals = [(-1.0 if i % 2 == 0 else 1.0) * _tangent(z_f, i // 2)
                   for i, z_f in enumerate(faces)]
        z = torch.cat(faces, dim=0)
        du_dn = torch.func.jvp(u_scalar, (z,), (torch.cat(normals, dim=0),))[1].reshape(-1, 1)
        loss = torch.zeros((), device=z.device)
        start = 0
        for x_f, t_f in draws:
            stop = start + x_f.shape[0]
            loss = loss + self._loss(du_dn[start:stop] - bc_func(x_f, t_f))
            start = stop
        return loss

    def _boundary_loss(self, apply_fn, params, generator: torch.Generator, n_b: int) -> torch.Tensor:
        """Every registered (non-initial) boundary condition on fresh points,
        in the order of the BC dict; periodic and Neumann conditions in their
        structural forms."""
        loss = torch.zeros((), device=generator.device)
        u_scalar = self._scalar_u(apply_fn, params)
        for bc_type, bc_func in self.boundary_conditions.items():
            if bc_type == "initial":
                continue
            if bc_type == "neumann":
                loss = loss + self._neumann_loss(u_scalar, bc_func, generator, n_b)
                continue
            if bc_type == "periodic":
                loss = loss + self._periodic_loss(u_scalar, generator, n_b)
                continue
            x_b, t_b = self._sample_boundary_points(generator, n_b)
            u_b = apply_fn(params, torch.cat([x_b, t_b], dim=-1)).reshape(x_b.shape[0], -1)[:, 0:1]
            loss = loss + self._loss(u_b - bc_func(x_b, t_b))
        return loss

    def compute_loss(self, apply_fn, params, x: torch.Tensor, t: torch.Tensor,
                     coeffs: Optional[Coeffs] = None,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """All loss components on fresh BC/IC points drawn from ``generator``.

        The residual term goes through the fused kernel whenever it is
        attached and no live coefficients are given (``coeffs`` empty, as the
        JAX package gates it), validation included (there the kernel skips
        its reverse pass); with causal weighting the points reach it sorted
        by time. The data term, on the observations, comes after every draw.
        """
        lw = self._loss_weights()
        generator = generator if generator is not None else _default_generator(x.device)
        use_fused = (
            self._fused_residual_loss is not None
            and not coeffs
            and x.dtype == torch.float32
            and all(p.dtype == torch.float32 for p in params.values())
        )
        if use_fused:
            z = torch.cat([x, t], dim=-1)
            if self.causal_eps() > 0.0:
                # The kernel weights the points in the order given: sort by
                # time here, outside it, as the JAX package does in XLA.
                z = torch.index_select(z, 0, torch.argsort(t.reshape(-1), stable=True))
            residual_loss = self._fused_residual_loss(params, z)
        else:
            residual = self.compute_residual(apply_fn, params, x, t, coeffs)
            residual_loss = self._residual_loss(residual, t)

        n_b, n_i = self._bc_counts(x.shape[0])
        boundary_loss = self._boundary_loss(apply_fn, params, generator, n_b)

        x_i, t_i = self._sample_initial_points(generator, n_i)
        u_initial = apply_fn(params, torch.cat([x_i, t_i], dim=-1)).reshape(x_i.shape[0], -1)[:, 0:1]
        ic_fn = self.boundary_conditions.get("initial")
        u_target_i = ic_fn(x_i, t_i) if ic_fn is not None else torch.zeros_like(u_initial)
        initial_loss = self._loss(u_initial - u_target_i)

        zero = torch.zeros((), device=x.device)
        data_loss = self._compute_data_loss(apply_fn, params)
        smoothness_loss = gpinn_loss = zero
        if float(lw.get("smoothness", 0.0)) > 0:
            smoothness_loss = self._fd_smoothness(apply_fn, params, x, t)
        if float(lw.get("gpinn", 0.0)) > 0:
            gpinn_loss = self._gpinn_loss(apply_fn, params, x, t, coeffs)
        return self._assemble_total(residual_loss, boundary_loss, initial_loss, smoothness_loss,
                                    zero if data_loss is None else data_loss, gpinn_loss)

    def _fd_smoothness(self, apply_fn, params, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The finite-difference gradient-magnitude penalty: per space axis,
        mean |du| of a forward and a backward difference of step 1e-4, each
        shifted point clipped to the domain."""
        eps = 1e-4

        def u_fn(xx):
            return apply_fn(params, torch.cat([xx, t], dim=-1)).reshape(xx.shape[0], -1)[:, 0:1]

        u_c = u_fn(x)
        loss = torch.zeros((), device=x.device)
        for d in range(self.dimension):
            lo, hi = self.domain[d]
            x_p, x_m = x.clone(), x.clone()
            x_p[:, d] = torch.clamp(x[:, d] + eps, lo, hi)
            x_m[:, d] = torch.clamp(x[:, d] - eps, lo, hi)
            du_f = (u_fn(x_p) - u_c) / eps
            du_b = (u_c - u_fn(x_m)) / eps
            loss = loss + torch.mean(torch.abs(du_f)) + torch.mean(torch.abs(du_b))
        return loss

    def _gpinn_loss(self, apply_fn, params, x: torch.Tensor, t: torch.Tensor,
                    coeffs: Optional[Coeffs] = None) -> torch.Tensor:
        """The gradient-enhanced residual penalty (gPINN): mean over the
        points of |grad_z r|^2, summed over a system's channels. The residual
        is point-wise, so one jvp of the batched residual with tangent e_k on
        every point gives dr/dz_k per point; it runs on the nested-jvp
        engine, one order above the residual (KdV: 4)."""
        z = torch.cat([x, t], dim=-1)
        if self.system_size > 1:
            k = self.system_size

            def uvec(zz: torch.Tensor) -> torch.Tensor:
                return apply_fn(params, zz).reshape(zz.shape[0], -1)[:, :k]

            def r_fn(zz):
                return self.residual_pointwise_system(uvec, zz, coeffs).reshape(zz.shape[0], -1)
        else:
            u = self._scalar_u(apply_fn, params)

            def r_fn(zz):
                return self.residual_pointwise(u, zz, coeffs).reshape(zz.shape[0], -1)

        sq = 0.0
        for axis in range(z.shape[1]):
            g = torch.func.jvp(r_fn, (z,), (_tangent(z, axis),))[1]
            sq = sq + torch.sum(g**2, dim=-1)
        return torch.mean(sq)

    def hard_ic_transform(self) -> Callable:
        """An output transform that imposes the initial condition exactly:

            u(x, t) = u0(x) [+ (t - t0) v0(x)] + ramp(t) net(x, t)

        with ramp tanh(tau) for a PDE first order in time and tanh(tau)^2
        (zero value and slope at t0) for one second order in time, tau = (t -
        t0) / T. T is ``hard_ic_timescale`` (the PDE block's, else its
        parameters') or min(horizon, 1). The velocity v0 is d/dt of the
        exact solution at t0 (a ``torch.func.jvp`` in t) where one is
        configured, else 0. Scalar (``output_dim == 1``) PDEs only; the
        trainer installs it when ``model.hard_ic`` is set."""
        ic_fn = self.boundary_conditions.get("initial")
        if ic_fn is None:
            raise ValueError(f"{self.pde_type}: hard_ic requires an initial condition")
        if int(self.settings.output_dim or 1) != 1:
            raise ValueError("hard_ic supports scalar (output_dim == 1) PDEs only")
        t0 = float(self.time_domain[0])
        horizon = float(self.time_domain[1]) - t0
        timescale = float(getattr(self.settings, "hard_ic_timescale", None)
                          or self.parameters.get("hard_ic_timescale")
                          or min(horizon, 1.0))
        second_order = 2 in tuple(self.temporal_orders)
        has_exact = bool(self.settings.exact_solution)

        def transform(z: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
            flat = z.reshape(-1, z.shape[-1])
            x, t = flat[:, :-1], flat[:, -1:]
            tt0 = torch.full_like(t, t0)
            u0 = ic_fn(x, tt0)
            tau = (t - t0) / timescale
            if second_order:
                ramp = torch.tanh(tau) ** 2
                if has_exact:
                    v0 = torch.func.jvp(lambda s: self.exact_solution(x, s), (tt0,),
                                        (torch.ones_like(tt0),))[1]
                else:
                    v0 = torch.zeros_like(u0)
                base = u0 + (t - t0) * v0
            else:
                ramp = torch.tanh(tau)
                base = u0
            res = base + ramp * out.reshape(flat.shape[0], -1)
            return res.reshape(out.shape)

        return transform

    def _add_velocity_ic(self, losses: Dict[str, torch.Tensor], apply_fn, params,
                         generator: torch.Generator, n_colloc: int, target_fn: Callable):
        """Adds the velocity initial condition u_t(x, t0) = target_fn(x, t0)
        of a PDE second order in time (wave, pendulum) on a fresh IC draw
        from ``generator``, taken after every draw of the base loss (so the
        other PDEs' streams are unchanged), to ``initial`` and, at the
        configured IC weight, to ``total``."""
        from pinnrl_tpu_torch.ops.derivatives import directional_derivative

        _, n_i = self._bc_counts(n_colloc)
        x_i, t_i = self._sample_initial_points(generator, n_i)
        u = self._scalar_u(apply_fn, params)
        z_i = torch.cat([x_i, t_i], dim=-1)
        u_t0 = directional_derivative(u, z_i, self.dimension, 1)[0].reshape(-1, 1)
        velocity_ic = self._loss(u_t0 - target_fn(x_i, t_i))
        losses["initial"] = losses["initial"] + velocity_ic
        w_ic = float(self._loss_weights().get("initial", 10.0))
        active = 0.0 if self._training_mode() == "data_only" else 1.0
        losses["total"] = losses["total"] + active * w_ic * velocity_ic
        return losses

    def _assemble_total(self, residual_loss, boundary_loss, initial_loss, smoothness_loss,
                        data_loss, gpinn_loss) -> Dict[str, torch.Tensor]:
        """Mode gating + fixed/adaptive weighting."""
        lw = self._loss_weights()
        smoothness_weight = float(lw.get("smoothness", 0.0))
        gpinn_weight = float(lw.get("gpinn", 0.0))
        data_weight = float(lw.get("data", 1.0))
        mode = self._training_mode()
        residual_active = 0.0 if mode == "data_only" else 1.0
        ic_bc_active = residual_active
        if mode in ("inverse", "data_only", "data_augmented") and data_weight <= 0.0:
            data_weight = 1.0
        losses = {
            "residual": residual_loss,
            "boundary": boundary_loss,
            "initial": initial_loss,
            "smoothness": smoothness_loss,
            "data": data_loss,
            "gpinn": gpinn_loss,
        }
        aw_enabled = bool(
            self.training is not None
            and getattr(self.training, "adaptive_weights", None) is not None
            and self.training.adaptive_weights.enabled
        )
        if aw_enabled:
            w_res = w_bc = w_ic = 1.0
        else:
            w_res = float(lw.get("pde", lw.get("residual", 1.0)))
            w_bc = float(lw.get("boundary", 10.0))
            w_ic = float(lw.get("initial", 10.0))
        losses["total"] = (
            residual_active * w_res * residual_loss
            + ic_bc_active * w_bc * boundary_loss
            + ic_bc_active * w_ic * initial_loss
            + smoothness_weight * smoothness_loss
            + residual_active * gpinn_weight * gpinn_loss
            + data_weight * data_loss
        )
        return losses

    # ------------------------------------------------------------------ #
    # Validation
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def validate(self, apply_fn, params, coeffs: Optional[Coeffs] = None,
                 generator: Optional[torch.Generator] = None,
                 num_points: int = 1000) -> Dict[str, float]:
        """Error metrics against the exact solution (``l2_error`` is the
        mean SQUARED error, as in the reference; ``rel_l2`` the relative L2
        norm)."""
        device = next(iter(params.values())).device
        generator = generator if generator is not None else _default_generator(device)
        x, t = sample_uniform(generator, num_points, self.domain, self.time_domain)
        return self._validate_on(apply_fn, params, x, t, coeffs)

    def _validate_on(self, apply_fn, params, x, t, coeffs: Optional[Coeffs] = None) -> Dict[str, Any]:
        """``validate``'s metrics on the given points."""
        u_exact = self.exact_solution(x, t, coeffs)
        pred = apply_fn(params, torch.cat([x, t], dim=-1)).reshape(x.shape[0], -1)[:, 0:1]
        if u_exact is None:
            return {"l2_error": float("nan"), "max_error": float("nan"), "mean_error": float("nan")}
        u_exact = u_exact.reshape(pred.shape)
        err = torch.abs(pred - u_exact)
        rel = torch.sqrt(torch.sum((pred - u_exact) ** 2)) / (torch.sqrt(torch.sum(u_exact**2)) + 1e-12)
        return {
            "l2_error": float(torch.mean(err**2)),
            "max_error": float(torch.max(err)),
            "mean_error": float(torch.mean(err)),
            "rel_l2": float(rel),
        }
