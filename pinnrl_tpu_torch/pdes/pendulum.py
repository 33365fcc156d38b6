"""Pendulum ODE as a PDE, theta_tt + (g/L) sin(theta) = 0, as
``pinnrl_tpu.pdes.pendulum``; with its total energy and phase-space
trajectories.

The solution does not depend on the dummy spatial axis, so the residual
needs only the time group of the stacked-jet bundle ([u_t, u_tt]).
``parameters.linearized`` swaps sin(theta) for theta, which makes the
``small_angle`` solution theta0 cos(omega t) exact; the ``elliptic``
solution (``ops/special.py``) is exact for the nonlinear residual.
``compute_loss`` adds the angular-velocity IC, whose target is the jvp in t
of the configured exact solution.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pinnrl_tpu_torch.ops.derivatives import directional_derivative, value_and_derivative
from pinnrl_tpu_torch.ops.special import pendulum_theta
from pinnrl_tpu_torch.pdes.base import Coeffs, PDEBase, _default_generator, register_pde


@register_pde
class PendulumEquation(PDEBase):
    pde_type = "pendulum"
    default_parameters = {"g": 9.81, "L": 1.0}
    spatial_orders = ()
    temporal_orders = (1, 2)

    def _g(self, coeffs: Optional[Coeffs]):
        return self.coeff(coeffs, "g", default=9.81)

    def _L(self, coeffs: Optional[Coeffs]):
        return self.coeff(coeffs, "L", default=1.0)

    def _omega(self, coeffs: Optional[Coeffs], dtype: torch.dtype):
        """sqrt(g / L), rounded as JAX rounds it: the square root taken in
        ``dtype`` (a Python float, so no copy to the device)."""
        g, L = self._g(coeffs), self._L(coeffs)
        if isinstance(g, torch.Tensor) or isinstance(L, torch.Tensor):
            return torch.sqrt(g / L)
        return float(torch.sqrt(torch.tensor(g / L, dtype=dtype)))

    def residual_pointwise(self, u, z: torch.Tensor, coeffs: Optional[Coeffs]):
        """Batched over the points of ``z``: theta_tt + (g/L) sin(theta), or
        (g/L) theta when ``linearized``."""
        u_tt = directional_derivative(u, z, self.dimension, 2)[1]
        val = u(z)
        restoring = val if bool(self.parameters.get("linearized", False)) else torch.sin(val)
        return u_tt + (self._g(coeffs) / self._L(coeffs)) * restoring

    def exact_solution(self, x, t, coeffs: Optional[Coeffs] = None):
        if not self.settings.exact_solution:
            return None
        spec = self.settings.exact_solution
        sol_type = spec.get("type", "small_angle")
        if sol_type == "small_angle":
            theta0 = float(spec.get("initial_angle", 0.1))
            omega = self._omega(coeffs, t.dtype)
            return theta0 * torch.cos(omega * t) * torch.ones_like(x[:, 0:1])
        if sol_type == "sine":
            A = float(spec.get("amplitude", 1.0))
            f = float(spec.get("frequency", 1.0))
            return A * torch.sin(f * (x[:, 0:1] + t))
        if sol_type == "elliptic":
            # The exact large-amplitude solution, released from rest at theta0.
            theta0 = float(spec.get("initial_angle", 0.5))
            omega = self._omega(coeffs, t.dtype)
            return pendulum_theta(t, theta0, omega) * torch.ones_like(x[:, 0:1])
        raise ValueError(f"Unknown exact solution type: {sol_type!r}")

    def compute_loss(self, apply_fn, params, x, t, coeffs=None, generator=None,
                     residual_loss=None):
        """Adds the angular-velocity IC theta_t(t0) = d/dt theta_exact(t0),
        the target by ``torch.func.jvp`` of ``exact_solution`` in t (a value-
        only IC leaves the B sin(omega t) mode free)."""
        generator = generator if generator is not None else _default_generator(x.device)
        losses = super().compute_loss(apply_fn, params, x, t, coeffs=coeffs, generator=generator,
                                      residual_loss=residual_loss)
        if not self.settings.exact_solution:
            return losses

        def target(x_i, t_i):
            return torch.func.jvp(lambda tt: self.exact_solution(x_i, tt, coeffs),
                                  (t_i,), (torch.ones_like(t_i),))[1]

        return self._add_velocity_ic(losses, apply_fn, params, generator, x.shape[0], target)

    def compute_energy(self, apply_fn, params, x, t, coeffs: Optional[Coeffs] = None):
        """Kinetic + potential energy per point, (N, 1)."""
        theta, theta_t = self.compute_phase_space(apply_fn, params, x, t)
        g, L = self._g(coeffs), self._L(coeffs)
        return 0.5 * L * L * theta_t**2 + g * L * (1 - torch.cos(theta))

    def compute_phase_space(
        self, apply_fn, params, x, t, coeffs: Optional[Coeffs] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(theta, dtheta/dt), each (N, 1), from one jvp of the network."""
        u = self._scalar_u(apply_fn, params)
        theta, theta_t = value_and_derivative(u, torch.cat([x, t], dim=-1), self.dimension)
        return theta.reshape(-1, 1), theta_t.reshape(-1, 1)
