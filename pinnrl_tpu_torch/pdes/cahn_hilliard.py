"""Cahn-Hilliard equation u_t = lap(mu), mu = u^3 - u - eps^2 lap(u), as
``pinnrl_tpu.pdes.cahn_hilliard``.

Two formulations (``parameters.formulation``):

- ``direct`` (default): the fourth-order residual u_t - lap(mu(u)), where
  the chemical potential is itself a batched point function whose
  Laplacian is taken by the generic engine: four nested jvps of the
  network, no stacked-jet bundle (``bundle_compatible = False``).
- ``mixed``: a 2-channel head (u, mu) tied by the compatibility residual
  mu = u^3 - u - eps^2 lap(u); both residuals need second-order jets only
  (``system_size = 2``, ``residual_pointwise_system``).

The u^3 argument is clamped to +-10, as in the reference. Exact solutions:
the reference's ``tanh`` / ``spinodal`` profile tanh(x / 2 eps) (not a
solution: kept for parity), the ``stationary_interface`` tanh(x_0 /
(sqrt(2) eps)), whose residual is zero in any dimension, and ``spectral``:
the ETDRK4 trajectory of ``numerical_solvers.spectral``, built on the PDE's
device.

``compute_loss`` adds two penalties in one space dimension: ``mass`` (the
mean of u over a 128-point grid at 16 random times against the IC's mean)
and, for the mixed form, ``mu_h2`` (k^4 |r2_hat|^2 of the compatibility
residual on a 128-point periodic grid at 8 random times, by
``torch.fft.rfft``). Their times are drawn from the loss's generator after
every draw of the base loss, mass first.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from pinnrl_tpu_torch.config import resolve_device
from pinnrl_tpu_torch.ops.derivatives import directional_derivative, laplacian
from pinnrl_tpu_torch.pdes.base import Coeffs, PDEBase, _default_generator, register_pde

_MASS_GRID, _MASS_TIMES = 128, 16
_H2_GRID, _H2_TIMES = 128, 8


@register_pde
class CahnHilliardEquation(PDEBase):
    pde_type = "cahn_hilliard"
    default_parameters = {"epsilon": 0.1, "mobility": 1.0, "kappa": 0.01}
    spatial_orders = (2, 4)
    temporal_orders = (1,)
    # The residual differentiates the composed chemical potential, which a
    # precomputed u-derivative bundle cannot serve.
    bundle_compatible = False

    def __init__(self, settings, training=None, device=None):
        # Built before super().__init__: the base constructor builds the IC
        # closure, which asks whether a spectral trajectory exists.
        self._spectral = None
        if (getattr(settings, "exact_solution", None) or {}).get("type") == "spectral":
            from pinnrl_tpu_torch.numerical_solvers.spectral import build_phase_field_reference

            eps = float((settings.parameters or {}).get("epsilon", 0.1))
            self._spectral = build_phase_field_reference("cahn_hilliard", settings, eps,
                                                         device=resolve_device(device))
        super().__init__(settings, training, device)
        if str(self.parameters.get("formulation", "direct")) == "mixed":
            self.system_size = 2
            self.spatial_orders = (2,)

    def _eps(self, coeffs: Optional[Coeffs]):
        return self.coeff(coeffs, "epsilon", default=0.1)

    def residual_pointwise_system(self, uvec, z: torch.Tensor, coeffs: Optional[Coeffs]):
        """The mixed form over the head (u, mu), batched, (N, 2):

            r1 = u_t - lap(mu)                      (dynamics)
            r2 = mu - (u^3 - u - eps^2 lap(u))      (compatibility)

        One order-2 nest per spatial axis (``laplacian`` vmaps them over
        two or more axes) serves both channels (the vector restriction is
        batched, so channel c is column c), plus one first-order time jvp."""
        eps = self._eps(coeffs)
        vals = uvec(z)
        lap = laplacian(uvec, z, range(self.dimension))
        u_t = directional_derivative(uvec, z, self.dimension, 1)[0][:, 0]
        u_c = torch.clamp(vals[:, 0], -10.0, 10.0)
        r1 = u_t - lap[:, 1]
        r2 = vals[:, 1] - (u_c**3 - u_c - eps**2 * lap[:, 0])
        return torch.stack([r1, r2], dim=1)

    def residual_pointwise(self, u, z: torch.Tensor, coeffs: Optional[Coeffs]):
        """The direct form, batched: u_t - lap(u_c^3 - u_c - eps^2 lap u)."""
        u_t = directional_derivative(u, z, self.dimension, 1)[0]
        eps = self._eps(coeffs)
        axes = range(self.dimension)

        def mu(zz: torch.Tensor) -> torch.Tensor:
            val_c = torch.clamp(u(zz), -10.0, 10.0)
            return -(eps**2) * laplacian(u, zz, axes) + val_c**3 - val_c

        return u_t - laplacian(mu, z, axes)

    # ------------------------------------------------------------------ #
    # Penalties
    # ------------------------------------------------------------------ #

    def _draw_times(self, generator: torch.Generator, k: int) -> torch.Tensor:
        lo, hi = self.time_domain
        return lo + (hi - lo) * torch.rand((k, 1), generator=generator, device=generator.device,
                                           dtype=self.dtype)

    def compute_loss(self, apply_fn, params, x: torch.Tensor, t: torch.Tensor,
                     coeffs: Optional[Coeffs] = None,
                     generator: Optional[torch.Generator] = None,
                     residual_loss: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The base loss, then the ``mass`` penalty when ``loss_weights.mass
        > 0`` in one space dimension and the ``mu_h2`` penalty after it.
        As in the reference, ``mass <= 0`` skips both."""
        generator = generator if generator is not None else _default_generator(x.device)
        losses = super().compute_loss(apply_fn, params, x, t, coeffs=coeffs, generator=generator,
                                      residual_loss=residual_loss)
        w_mass = float(self._loss_weights().get("mass", 0.0))
        if w_mass <= 0.0 or self.dimension != 1:
            return losses
        active = 0.0 if self._training_mode() == "data_only" else 1.0
        mass = self._mass_terms(apply_fn, params, self._draw_times(generator, _MASS_TIMES))
        losses["mass"] = mass
        losses["total"] = losses["total"] + active * w_mass * mass
        w_h2 = float(self._loss_weights().get("mu_h2", 0.0))
        if w_h2 <= 0.0 or self.system_size < 2:
            return losses
        h2 = self._mu_h2_terms(apply_fn, params, coeffs, self._draw_times(generator, _H2_TIMES))
        losses["mu_h2"] = h2
        losses["total"] = losses["total"] + active * w_h2 * h2
        return losses

    def _mass_terms(self, apply_fn, params, ts: torch.Tensor) -> torch.Tensor:
        """Mean square of (spatial mean of u at each time of ``ts`` (K, 1)
        minus the IC's mean), on a 128-point grid holding both ends."""
        x_lo, x_hi = self.domain[0]
        xs = torch.linspace(x_lo, x_hi, _MASS_GRID, dtype=ts.dtype, device=ts.device)
        xs = xs.reshape(-1, 1)
        ic_fn = self.boundary_conditions.get("initial")
        mass0 = (torch.mean(ic_fn(xs, torch.zeros_like(xs))) if ic_fn is not None
                 else torch.zeros((), device=ts.device))
        k = ts.shape[0]
        z = torch.cat([xs.repeat(k, 1), ts.repeat_interleave(_MASS_GRID, dim=0)], dim=-1)
        u = apply_fn(params, z).reshape(k, _MASS_GRID, -1)[..., 0]
        return torch.mean((torch.mean(u, dim=1) - mass0) ** 2)

    def _mu_h2_terms(self, apply_fn, params, coeffs, ts: torch.Tensor) -> torch.Tensor:
        """Mean over the times of ``ts`` (K, 1) of sum_k mult_k k^4 |r2_hat_k|^2:
        the compatibility residual r2 on a 128-point periodic grid, its
        one-sided spectrum (rfft / G; DC and Nyquist once, the rest twice),
        k = 2 pi idx / L."""
        x_lo, x_hi = self.domain[0]
        length = x_hi - x_lo
        grid = torch.arange(_H2_GRID, dtype=ts.dtype, device=ts.device)
        xs = (x_lo + (length / _H2_GRID) * grid).reshape(-1, 1)
        k = ts.shape[0]
        r = self.compute_residual(apply_fn, params, xs.repeat(k, 1),
                                  ts.repeat_interleave(_H2_GRID, dim=0), coeffs)
        r_mu = r.reshape(k, _H2_GRID, -1)[..., 1]
        spec = torch.fft.rfft(r_mu, dim=1) / _H2_GRID
        idx = grid[: _H2_GRID // 2 + 1]
        kf = (2.0 * math.pi / length) * idx
        mult = torch.where((idx == 0) | (idx == _H2_GRID // 2), 1.0, 2.0)
        power = spec.real**2 + spec.imag**2
        return torch.mean(torch.sum(mult * kf**4 * power, dim=1))

    # ------------------------------------------------------------------ #
    # Exact solution, IC and BC
    # ------------------------------------------------------------------ #

    def _spectral_lookup(self, x, t):
        from pinnrl_tpu_torch.numerical_solvers.spectral import interp_trajectory

        x_min, x_max = self.domain[0]
        return interp_trajectory(self._spectral.u, x, t, x_min, x_max, self.time_domain[1])

    def _exact_type(self) -> str:
        return (self.settings.exact_solution or {}).get("type", "tanh")

    def exact_solution(self, x, t, coeffs: Optional[Coeffs] = None):
        """``tanh`` / ``spinodal`` (the default; 1-D and the N-D product),
        ``stationary_interface`` or the ``spectral`` trajectory."""
        kind = self._exact_type()
        eps = self._eps(coeffs)
        if kind == "spectral":
            return self._spectral_lookup(x, t)
        if kind == "stationary_interface":
            return torch.tanh(x[:, 0:1] / (math.sqrt(2.0) * eps))
        if self.dimension == 1:
            return torch.tanh(x[:, 0:1] / (2 * eps))
        sol = torch.ones_like(x[:, 0:1])
        for dim in range(self.dimension):
            sol = sol * torch.tanh(x[:, dim : dim + 1] / (2 * eps))
        return sol

    def _create_initial_condition(self, params: Dict) -> Callable:
        ic_type = params.get("type", "tanh")
        if (ic_type in ("spectral", "stationary_interface") or self._spectral is not None
                or self._exact_type() == "stationary_interface"):
            # The t = 0 trace of the reference the run is measured against.
            return lambda x, t: self.exact_solution(x, torch.zeros_like(x[:, 0:1]))
        if ic_type == "tanh":
            eps = self._eps(None)
            if self.dimension == 1:
                return lambda x, t: torch.tanh(x[:, 0:1] / (2 * eps))
            return lambda x, t: torch.tanh(torch.sum(x, dim=1, keepdim=True) / (2 * eps))
        return super()._create_initial_condition(params)

    def _create_boundary_condition(self, bc_type: str, params: Dict) -> Callable:
        if bc_type == "dirichlet" and self._exact_type() == "stationary_interface":
            # The interface's trace varies along the faces: target it.
            return lambda x, t: self.exact_solution(x, t)
        return super()._create_boundary_condition(bc_type, params)
