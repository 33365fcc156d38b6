"""Wave equation u_tt = c^2 lap(u), as ``pinnrl_tpu.pdes.wave``.

The exact solution is the traveling wave sin(2 pi (x - c t)) (in N-D the
product over the axes); when it is configured, the IC and Dirichlet targets
are its traces, and ``compute_loss`` adds the velocity IC
u_t(x, 0) = -2 pi c cos(2 pi x_0), without which a PDE second order in time
is underdetermined.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from pinnrl_tpu_torch.ops.derivatives import directional_derivative, laplacian
from pinnrl_tpu_torch.pdes.base import Coeffs, PDEBase, _default_generator, register_pde


@register_pde
class WaveEquation(PDEBase):
    pde_type = "wave"
    default_parameters = {"c": 1.0}
    spatial_orders = (2,)
    temporal_orders = (2,)

    def _c(self, coeffs: Optional[Coeffs]):
        return self.coeff(coeffs, "c", default=1.0)

    def residual_pointwise(self, u, z: torch.Tensor, coeffs: Optional[Coeffs]):
        """Batched over the points of ``z``: u_tt - c^2 lap u."""
        u_tt = directional_derivative(u, z, self.dimension, 2)[1]
        lap = laplacian(u, z, range(self.dimension))
        return u_tt - self._c(coeffs) ** 2 * lap

    def exact_solution(self, x, t, coeffs: Optional[Coeffs] = None):
        """Traveling wave sin(2 pi (x - c t)); in N-D the product over the axes."""
        c = self._c(coeffs)
        if self.dimension == 1:
            return torch.sin(2 * math.pi * (x[:, 0:1] - c * t))
        sol = torch.ones_like(x[:, 0:1])
        for dim in range(self.dimension):
            sol = sol * torch.sin(2 * math.pi * (x[:, dim : dim + 1] - c * t))
        return sol

    def _create_initial_condition(self, params: Dict) -> Callable:
        ic_type = params.get("type", "sine")
        if ic_type == "sine" and self.settings.exact_solution:
            # With an exact solution configured, its trace at t = 0 (the
            # reference's sin(k pi x) IC contradicts its own exact solution).
            return lambda x, t: self.exact_solution(x, torch.zeros_like(x[:, 0:1]))
        if ic_type == "sine":
            A = float(params.get("amplitude", 1.0))
            k = float(params.get("frequency", 2.0))
            if self.dimension == 1:
                return lambda x, t: A * torch.sin(k * math.pi * x[:, 0:1])
            return lambda x, t: A * torch.sin(k * math.pi * torch.sum(x, dim=1, keepdim=True))
        if ic_type == "sine_2d" and self.dimension == 2:
            A = float(params.get("amplitude", 1.0))
            kx = float(params.get("frequency_x", 2.0))
            ky = float(params.get("frequency_y", 2.0))
            return lambda x, t: (
                A * torch.sin(kx * math.pi * x[:, 0:1]) * torch.sin(ky * math.pi * x[:, 1:2])
            )
        return super()._create_initial_condition(params)

    def _create_boundary_condition(self, bc_type: str, params: Dict) -> Callable:
        if bc_type == "dirichlet" and self.settings.exact_solution:
            # The traveling wave is not zero at the endpoints: its trace.
            return lambda x, t: self.exact_solution(x, t)
        return super()._create_boundary_condition(bc_type, params)

    def compute_loss(self, apply_fn, params, x, t, coeffs=None, generator=None,
                     residual_loss=None):
        """Adds the velocity IC u_t(x, 0) = d/dt u_exact = -2 pi c cos(2 pi x_0)."""
        generator = generator if generator is not None else _default_generator(x.device)
        losses = super().compute_loss(apply_fn, params, x, t, coeffs=coeffs, generator=generator,
                                      residual_loss=residual_loss)
        if not self.settings.exact_solution:
            return losses
        c = self._c(coeffs)
        return self._add_velocity_ic(
            losses, apply_fn, params, generator, x.shape[0],
            lambda x_i, t_i: -2 * math.pi * c * torch.cos(2 * math.pi * x_i[:, 0:1]),
        )
