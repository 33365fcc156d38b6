"""Convection equation u_t + v.grad(u) = 0, as ``pinnrl_tpu.pdes.convection``.

The velocity is a scalar (the same on every axis) or one value per axis;
the exact solution is the advected sine sin(2 pi (x - v t)) (a product
over the axes in d-D).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from pinnrl_tpu_torch.ops.derivatives import directional_derivative
from pinnrl_tpu_torch.pdes.base import Coeffs, PDEBase, register_pde


@register_pde
class ConvectionEquation(PDEBase):
    pde_type = "convection"
    default_parameters = {"velocity": 1.0}
    spatial_orders = (1,)
    temporal_orders = (1,)

    def _velocity(self, coeffs: Optional[Coeffs]) -> List:
        """Scalar -> per-dimension list."""
        v = self.coeff(coeffs, "velocity", default=1.0)
        if isinstance(v, (list, tuple)):
            return list(v)
        if isinstance(v, torch.Tensor) and v.ndim > 0:
            return [v[i] for i in range(self.dimension)]
        return [v] * self.dimension

    def residual_pointwise(self, u, z: torch.Tensor, coeffs: Optional[Coeffs]):
        """Batched over the points of ``z``: u_t + sum_ax v_ax u_ax."""
        u_t = directional_derivative(u, z, self.dimension, 1)[0]
        v = self._velocity(coeffs)
        conv = torch.zeros((), device=z.device)
        for ax in range(self.dimension):
            conv = conv + v[ax] * directional_derivative(u, z, ax, 1)[0]
        return u_t + conv

    def exact_solution(self, x, t, coeffs: Optional[Coeffs] = None):
        v = self._velocity(coeffs)
        if self.dimension == 1:
            return torch.sin(2 * torch.pi * (x[:, 0:1] - v[0] * t))
        sol = torch.ones_like(x[:, 0:1])
        for dim in range(self.dimension):
            sol = sol * torch.sin(2 * torch.pi * (x[:, dim : dim + 1] - v[dim] * t))
        return sol

    def _create_initial_condition(self, params: Dict) -> Callable:
        ic_type = params.get("type", "sine")
        if ic_type in ("sine", "sin"):
            A = float(params.get("amplitude", 1.0))
            k = float(params.get("frequency", 2.0))
            if self.dimension == 1:
                return lambda x, t: A * torch.sin(k * torch.pi * x[:, 0:1])
            return lambda x, t: A * torch.sin(k * torch.pi * torch.sum(x, dim=1, keepdim=True))
        return super()._create_initial_condition(params)
