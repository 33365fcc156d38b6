"""Burgers equation u_t + u.grad(u) = nu*lap(u)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from pinnrl_tpu_torch.ops.derivatives import directional_derivative
from pinnrl_tpu_torch.pdes.base import Coeffs, PDEBase, register_pde


@register_pde
class BurgersEquation(PDEBase):
    pde_type = "burgers"
    default_parameters = {"nu": 0.01}
    spatial_orders = (1, 2)
    temporal_orders = (1,)

    def _nu(self, coeffs: Optional[Coeffs]):
        # Config may name it "nu" or "viscosity".
        if "nu" in self.parameters or (coeffs and "nu" in coeffs):
            return self.coeff(coeffs, "nu", default=0.01)
        return self.coeff(coeffs, "viscosity", default=0.01)

    def residual_pointwise(self, u, z: torch.Tensor, coeffs: Optional[Coeffs]):
        """Batched over the points of ``z``: u_t + sum_ax u u_ax - nu lap u."""
        val = u(z)
        u_t = directional_derivative(u, z, self.dimension, 1)[0]
        lap = torch.zeros_like(val)
        convection = torch.zeros_like(val)
        for ax in range(self.dimension):
            d1, d2 = directional_derivative(u, z, ax, 2)
            lap = lap + d2
            convection = convection + val * d1
        return u_t + convection - self._nu(coeffs) * lap

    def exact_solution(self, x, t, coeffs: Optional[Coeffs] = None):
        """Cole-Hopf, the reference's tanh profile, or the exact viscous-shock
        traveling wave u = c - a tanh(a (x - x0 - c t) / (2 nu))."""
        spec = self.settings.exact_solution or {}
        sol_type = spec.get("type", "cole_hopf")
        nu = self._nu(coeffs)
        if sol_type == "cole_hopf":
            nu_s = float(spec.get("viscosity", 0.0)) or nu
            k = float(spec.get("initial_frequency", 1.0))

            def one_dim(xi):
                decay = torch.exp(-nu_s * (k * torch.pi) ** 2 * t)
                phi = -torch.cos(k * torch.pi * xi) * decay
                phi_x = k * torch.pi * torch.sin(k * torch.pi * xi) * decay
                return -2 * nu_s * phi_x / phi

            if self.dimension == 1:
                return one_dim(x[:, 0:1])
            sol = torch.ones_like(x[:, 0:1])
            for dim in range(self.dimension):
                sol = sol * one_dim(x[:, dim : dim + 1])
            return sol
        if sol_type == "tanh":
            # Reference-parity form; NOT an exact Burgers solution (its
            # residual is O(1)). Use "traveling_wave" as a benchmark target.
            eps = float(spec.get("epsilon", 0.1))
            sol = torch.ones_like(x[:, 0:1])
            for dim in range(self.dimension):
                sol = sol * torch.tanh((x[:, dim : dim + 1] - 0.5 - nu * t) / eps)
            return sol
        if sol_type == "traveling_wave":
            a = float(spec.get("amplitude", 0.5))
            c = float(spec.get("speed", 0.5))
            x0 = float(spec.get("center", 0.0))
            return c - a * torch.tanh(a * (x[:, 0:1] - x0 - c * t) / (2.0 * nu))
        raise ValueError(f"Unsupported exact solution type {sol_type!r}")

    def _create_initial_condition(self, params: Dict) -> Callable:
        ic_type = params.get("type", "sine")
        if ic_type == "traveling_wave" or (
            (self.settings.exact_solution or {}).get("type") == "traveling_wave"
        ):
            # IC = the exact traveling wave at t = 0.
            return lambda x, t: self.exact_solution(x, torch.zeros_like(x[:, 0:1]))
        if ic_type == "sine":
            A = float(params.get("amplitude", -1.0))
            k = float(params.get("frequency", 1.0))
            if self.dimension == 1:
                return lambda x, t: A * torch.sin(k * torch.pi * x[:, 0:1])
            return lambda x, t: A * torch.prod(torch.sin(k * torch.pi * x), dim=1, keepdim=True)
        if ic_type == "tanh":
            eps = float(params.get("epsilon", 0.1))
            if self.dimension == 1:
                return lambda x, t: torch.tanh((x[:, 0:1] - 0.5) / eps)
            return lambda x, t: torch.prod(torch.tanh((x - 0.5) / eps), dim=1, keepdim=True)
        return super()._create_initial_condition(params)

    def _create_boundary_condition(self, bc_type: str, params: Dict) -> Callable:
        if (
            bc_type == "dirichlet"
            and (self.settings.exact_solution or {}).get("type") == "traveling_wave"
        ):
            # The front's endpoint values are c -/+ a, not zero: target the
            # exact trace at the boundary.
            return lambda x, t: self.exact_solution(x, t)
        return super()._create_boundary_condition(bc_type, params)
