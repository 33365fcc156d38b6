"""Allen-Cahn equation u_t = eps^2 lap(u) + u - u^3, as
``pinnrl_tpu.pdes.allen_cahn``.

Exact solutions: the reference's ``tanh`` profile tanh(x / 2 eps) (not a
stationary solution: it leaves an O(0.1) residual), the genuine stationary
interface tanh(x / (sqrt(2) eps)) (``stationary_interface``), and
``spectral``: the ETDRK4 trajectory of ``numerical_solvers.spectral``,
built once in the constructor on the PDE's device and read by bilinear
interpolation, as are the IC (its t = 0 trace) and validation.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from pinnrl_tpu_torch.config import resolve_device
from pinnrl_tpu_torch.ops.derivatives import directional_derivative, laplacian
from pinnrl_tpu_torch.pdes.base import Coeffs, PDEBase, register_pde


@register_pde
class AllenCahnEquation(PDEBase):
    pde_type = "allen_cahn"
    default_parameters = {"epsilon": 0.1}
    spatial_orders = (2,)
    temporal_orders = (1,)

    def __init__(self, settings, training=None, device=None):
        # Built before super().__init__: the base constructor builds the IC
        # closure, which asks whether a spectral trajectory exists.
        self._spectral = None
        if (getattr(settings, "exact_solution", None) or {}).get("type") == "spectral":
            from pinnrl_tpu_torch.numerical_solvers.spectral import build_phase_field_reference

            eps = float((settings.parameters or {}).get("epsilon", 0.1))
            self._spectral = build_phase_field_reference("allen_cahn", settings, eps,
                                                         device=resolve_device(device))
        super().__init__(settings, training, device)

    def _spectral_lookup(self, x, t):
        from pinnrl_tpu_torch.numerical_solvers.spectral import interp_trajectory

        x_min, x_max = self.domain[0]
        return interp_trajectory(self._spectral.u, x, t, x_min, x_max, self.time_domain[1])

    def _eps(self, coeffs: Optional[Coeffs]):
        return self.coeff(coeffs, "epsilon", default=0.1)

    def residual_pointwise(self, u, z: torch.Tensor, coeffs: Optional[Coeffs]):
        """Batched over the points of ``z``: u_t - eps^2 lap u - u + u^3."""
        val = u(z)
        u_t = directional_derivative(u, z, self.dimension, 1)[0]
        lap = laplacian(u, z, range(self.dimension))
        return u_t - self._eps(coeffs) ** 2 * lap - val + val**3

    def _width(self, kind: str, eps) -> float:
        return math.sqrt(2.0) * eps if kind == "stationary_interface" else 2 * eps

    def exact_solution(self, x, t, coeffs: Optional[Coeffs] = None):
        """The ``tanh`` profile (default, reference parity), the
        ``stationary_interface`` or the ``spectral`` trajectory."""
        spec = self.settings.exact_solution or {}
        kind = spec.get("type", "tanh") if isinstance(spec, dict) else "tanh"
        if kind == "spectral":
            return self._spectral_lookup(x, t)
        width = self._width(kind, self._eps(coeffs))
        if self.dimension == 1:
            return torch.tanh(x[:, 0:1] / width)
        sol = torch.ones_like(x[:, 0:1])
        for dim in range(self.dimension):
            sol = sol * torch.tanh(x[:, dim : dim + 1] / width)
        return sol

    def _create_initial_condition(self, params: Dict) -> Callable:
        ic_type = params.get("type", "tanh")
        if ic_type == "spectral" or self._spectral is not None:
            # The IC is the t = 0 trace of the spectral reference.
            return lambda x, t: self._spectral_lookup(x, torch.zeros_like(x[:, 0:1]))
        if ic_type in ("tanh", "stationary_interface"):
            width = self._width(ic_type, self._eps(None))
            if self.dimension == 1:
                return lambda x, t: torch.tanh(x[:, 0:1] / width)
            return lambda x, t: torch.tanh(torch.sum(x, dim=1, keepdim=True) / width)
        return super()._create_initial_condition(params)
