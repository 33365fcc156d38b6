"""Heat equation u_t = alpha lap(u), as ``pinnrl_tpu.pdes.heat``, in any
number of space dimensions (``heat_2d`` is this class with dimension 2).

The decay rate is tied to alpha (decay = alpha (2 pi k / L)^2, L the first
axis's length), the ``sin_exp_decay`` exact solution and its IC/BC targets
(a product of sines over the axes in N-D), the ``sine_2d`` exact solution
and IC (per-axis wave numbers 2 pi k_ax / L_ax, shifted to the domain's
lower corner, so the mode vanishes on a Dirichlet box and solves the PDE),
time-stratified boundary points (25% in the first 1% of the horizon), an
edge-concentrated IC layout in one dimension (25% near each end, 50%
inside; uniform in N-D) and validation with NaN, bound and, in one
dimension, periodic-BC checks. Periodic BCs go through the base class's
structural loss (value and first-derivative matching). The two sampling
hooks take their uniform draws in the public method and hand them as
tensors to a deterministic helper (``_stratified_times``,
``_edge_initial_points``), so the tests can feed JAX's draws.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from pinnrl_tpu_torch.ops.derivatives import directional_derivative, laplacian
from pinnrl_tpu_torch.pdes.base import Coeffs, PDEBase, register_pde


@register_pde
class HeatEquation(PDEBase):
    pde_type = "heat"
    default_parameters = {"alpha": 0.01}
    spatial_orders = (2,)
    temporal_orders = (1,)

    def __init__(self, settings, training=None, device=None):
        super().__init__(settings, training, device)
        if "alpha" not in self.parameters:
            raise ValueError("heat equation requires parameter 'alpha'")

    def _alpha(self, coeffs: Optional[Coeffs]):
        return self.coeff(coeffs, "alpha")

    def _wave_number(self, k: float, axis: int = 0) -> float:
        return 2 * math.pi * k / (self.domain[axis][1] - self.domain[axis][0])

    def _sine_product(self, k: float) -> Callable:
        """x -> prod_ax sin(2 pi k x_ax / L_ax)."""
        def space(x):
            sol = torch.sin(self._wave_number(k) * x[:, 0:1])
            for ax in range(1, self.dimension):
                sol = sol * torch.sin(self._wave_number(k, ax) * x[:, ax:ax + 1])
            return sol
        return space

    def _sine_2d(self, spec: Dict) -> Tuple[float, float, float, Callable]:
        """(A, wx, wy, x -> sin(wx (x - x_lo)) sin(wy (y - y_lo))) of a
        ``sine_2d`` block."""
        A = float(spec.get("amplitude", 1.0))
        wx = self._wave_number(float(spec.get("frequency_x", 2.0)), 0)
        wy = self._wave_number(float(spec.get("frequency_y", 2.0)), 1)
        (x_lo, _), (y_lo, _) = self.domain[0], self.domain[1]
        return A, wx, wy, lambda x: (torch.sin(wx * (x[:, 0:1] - x_lo))
                                     * torch.sin(wy * (x[:, 1:2] - y_lo)))

    def _decay_rate(self, k: float, coeffs: Optional[Coeffs] = None):
        """decay = alpha (2 pi k / L)^2."""
        return self._alpha(coeffs) * self._wave_number(k) ** 2

    def residual_pointwise(self, u, z: torch.Tensor, coeffs: Optional[Coeffs]):
        """Batched over the points of ``z``: u_t - alpha lap u."""
        u_t = directional_derivative(u, z, self.dimension, 1)[0]
        lap = laplacian(u, z, range(self.dimension))
        return u_t - self._alpha(coeffs) * lap

    def exact_solution(self, x, t, coeffs: Optional[Coeffs] = None):
        """``sine_2d`` in two dimensions: A exp(-alpha (wx^2 + wy^2) t)
        sin(wx (x - x_lo)) sin(wy (y - y_lo)); otherwise A exp(-decay t)
        prod_ax sin(2 pi k x_ax / L_ax) (``sin_exp_decay`` / ``sine``)."""
        spec = self.settings.exact_solution or self.settings.initial_condition or {}
        if spec.get("type") == "sine_2d" and self.dimension == 2:
            A, wx, wy, space = self._sine_2d(spec)
            return A * torch.exp(-self._alpha(coeffs) * (wx**2 + wy**2) * t) * space(x)
        A = float(spec.get("amplitude", 1.0))
        k = float(spec.get("frequency", 2.0))
        decay = self._decay_rate(k, coeffs)
        if self.dimension == 1:
            return A * torch.exp(-decay * t) * torch.sin(self._wave_number(k) * x[:, 0:1])
        return A * torch.exp(-decay * t) * self._sine_product(k)(x)

    # ------------------------------------------------------------------ #
    # IC / BC overrides: exact-solution-aware targets
    # ------------------------------------------------------------------ #

    def _create_initial_condition(self, params: Dict) -> Callable:
        ic_type = params.get("type", "sine")
        if ic_type == "sin_exp_decay":
            A = float(params.get("amplitude", 1.0))
            k = float(params.get("frequency", 2.0))
            if self.dimension == 1:
                wn = self._wave_number(k)
                return lambda x, t: A * torch.sin(wn * x[:, 0:1]) * torch.exp(-self._decay_rate(k) * t)
            space = self._sine_product(k)
            return lambda x, t: A * space(x) * torch.exp(-self._decay_rate(k) * t)
        if ic_type == "sine" and self.dimension == 1:
            A = float(params.get("amplitude", 1.0))
            wn = self._wave_number(float(params.get("frequency", 2.0)))
            return lambda x, t: A * torch.sin(wn * x[:, 0:1])
        if ic_type == "sine_2d":
            A, _wx, _wy, space = self._sine_2d(params)
            return lambda x, t: A * space(x)
        return super()._create_initial_condition(params)

    def _create_boundary_condition(self, bc_type: str, params: Dict) -> Callable:
        if (
            bc_type == "dirichlet"
            and (self.settings.exact_solution or {}).get("type") == "sin_exp_decay"
        ):
            A = float(self.settings.exact_solution.get("amplitude", 1.0))
            k = float(self.settings.exact_solution.get("frequency", 2.0))
            wn = self._wave_number(k)
            return lambda x, t: A * torch.sin(wn * x[:, 0:1]) * torch.exp(-self._decay_rate(k) * t)
        return super()._create_boundary_condition(bc_type, params)

    # ------------------------------------------------------------------ #
    # Sampling hooks
    # ------------------------------------------------------------------ #

    def _time_split(self, n: int):
        n_early = max(n // 4, 1)
        return n_early, max(n - n_early, 1)

    def _stratified_times(self, u_early: torch.Tensor, u_late: torch.Tensor, n: int) -> torch.Tensor:
        """Boundary times from unit uniforms: ``u_early`` in the first 1% of
        the horizon, ``u_late`` in the rest; the first ``n``."""
        t0, t_max = self.time_domain
        t_early = t0 + (t_max - t0) * 0.01
        early = t0 + (t_early - t0) * u_early
        late = t_early + (t_max - t_early) * u_late
        return torch.cat([early, late], dim=0)[:n]

    def _sample_boundary_time(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Time-stratified boundary draw: 25% of the times in the first 1%."""
        n_early, n_late = self._time_split(n)
        dev = generator.device
        u_early = torch.rand((n_early, 1), generator=generator, device=dev, dtype=self.dtype)
        u_late = torch.rand((n_late, 1), generator=generator, device=dev, dtype=self.dtype)
        return self._stratified_times(u_early, u_late, n)

    def _initial_split(self, n: int):
        n_q = max(n // 4, 1)
        return n_q, max(n - 2 * n_q, 1)

    def _edge_initial_points(self, u_lo: torch.Tensor, u_mid: torch.Tensor, u_hi: torch.Tensor,
                             n: int):
        """IC points from unit uniforms: ``u_lo`` in the first 10% of the
        domain, ``u_mid`` inside, ``u_hi`` in the last 10%; the first ``n``,
        at ``time_domain[0]``."""
        x_min, x_max = self.domain[0]
        edge = (x_max - x_min) * 0.1
        x_i = torch.cat([
            x_min + edge * u_lo,
            (x_min + edge) + ((x_max - edge) - (x_min + edge)) * u_mid,
            (x_max - edge) + edge * u_hi,
        ], dim=0)[:n]
        return x_i, torch.full((x_i.shape[0], 1), self.time_domain[0], dtype=x_i.dtype,
                               device=x_i.device)

    def _sample_initial_points(self, generator: torch.Generator, n: int):
        """Edge-concentrated IC layout in one dimension: 25% near each end,
        50% inside; the base class's uniform draw in N-D."""
        if self.dimension != 1:
            return super()._sample_initial_points(generator, n)
        n_q, n_h = self._initial_split(n)
        dev = generator.device
        u_lo = torch.rand((n_q, 1), generator=generator, device=dev, dtype=self.dtype)
        u_mid = torch.rand((n_h, 1), generator=generator, device=dev, dtype=self.dtype)
        u_hi = torch.rand((n_q, 1), generator=generator, device=dev, dtype=self.dtype)
        return self._edge_initial_points(u_lo, u_mid, u_hi, n)

    # ------------------------------------------------------------------ #

    def _validate_on(self, apply_fn, params, x, t, coeffs=None):
        """Adds NaN/Inf, physical-bound and (in one dimension) periodic-BC
        checks on the same points."""
        metrics = super()._validate_on(apply_fn, params, x, t, coeffs)
        pred = apply_fn(params, torch.cat([x, t], dim=-1))
        metrics["has_nan"] = bool(torch.any(~torch.isfinite(pred)))
        amplitude = float((self.settings.exact_solution or {}).get("amplitude", 1.0))
        metrics["within_bounds"] = bool(torch.all(torch.abs(pred) <= abs(amplitude) * 1.5 + 1e-3))
        if self.dimension == 1 and "periodic" in self.boundary_conditions:
            t_line = torch.linspace(self.time_domain[0], self.time_domain[1], 64,
                                    device=x.device).reshape(-1, 1)
            z_lo = torch.cat([torch.full_like(t_line, self.domain[0][0]), t_line], dim=1)
            z_hi = torch.cat([torch.full_like(t_line, self.domain[0][1]), t_line], dim=1)
            periodic_err = float(torch.mean((apply_fn(params, z_lo) - apply_fn(params, z_hi)) ** 2))
            metrics["periodic_bc_error"] = periodic_err
            metrics["periodic_bc_ok"] = periodic_err < 1e-3
        return metrics
