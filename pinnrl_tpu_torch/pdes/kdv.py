"""KdV equation u_t + 6 u u_x + u_xxx = 0.

The third spatial derivative is the order-3 stream of the stacked-jet
bundle along each spatial axis.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from pinnrl_tpu_torch.ops.derivatives import directional_derivative
from pinnrl_tpu_torch.pdes.base import Coeffs, PDEBase, register_pde


@register_pde
class KdVEquation(PDEBase):
    pde_type = "kdv"
    default_parameters = {"speed": 1.0}
    spatial_orders = (1, 3)
    temporal_orders = (1,)

    def __init__(self, settings, training=None):
        super().__init__(settings, training)
        if str(self.parameters.get("formulation", "direct")) == "first_order":
            raise NotImplementedError(
                "the first-order KdV system (u, u_x, u_xx) needs jvp of a vector "
                "point function, the generic derivative engine (ROADMAP item 10)"
            )

    def _speed(self, coeffs: Optional[Coeffs]):
        return self.coeff(coeffs, "speed", default=1.0)

    def residual_pointwise(self, u, z: torch.Tensor, coeffs: Optional[Coeffs]):
        """Batched over the points of ``z``: u_t + sum_ax (6 u u_ax + u_ax^3)."""
        val = u(z)
        u_t = directional_derivative(u, z, self.dimension, 1)[0]
        res = u_t
        for ax in range(self.dimension):
            d = directional_derivative(u, z, ax, 3)
            res = res + 6.0 * val * d[0] + d[2]
        return res

    def exact_solution(self, x, t, coeffs: Optional[Coeffs] = None):
        """Single soliton (c/2) sech^2(sqrt(c)/2 (x - c t)); in nD along the
        sum of the coordinates."""
        if not self.settings.exact_solution:
            return None
        c = self._speed(coeffs)
        xs = x[:, 0:1] if self.dimension == 1 else torch.sum(x, dim=1, keepdim=True)
        arg = 0.5 * math.sqrt(c) * (xs - c * t)
        return 0.5 * c / torch.cosh(arg) ** 2

    def _create_initial_condition(self, params: Dict) -> Callable:
        ic_type = params.get("type", "soliton")
        if ic_type == "soliton":
            c = float(params.get("speed", self.parameters.get("speed", 1.0)))
            if self.dimension == 1:
                return lambda x, t: 0.5 * c / torch.cosh(0.5 * math.sqrt(c) * x[:, 0:1]) ** 2
            return lambda x, t: (
                0.5 * c / torch.cosh(0.5 * math.sqrt(c) * torch.sum(x, dim=1, keepdim=True)) ** 2
            )
        return super()._create_initial_condition(params)
