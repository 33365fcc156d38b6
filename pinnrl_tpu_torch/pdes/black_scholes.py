"""Black-Scholes equation V_t + 0.5 sigma^2 S^2 V_SS + r S V_S - r V = 0, as
``pinnrl_tpu.pdes.black_scholes``.

The residual reads t as calendar time by default (reference parity) or, with
``parameters.time_convention: to_maturity``, as time to maturity (the sign
of every term but V_t flips; the payoff IC at t = 0 and the closed form then
agree). The closed form uses erf where the normal CDF belongs (reference
parity) unless ``exact_solution.cdf`` is true. ``parameters.ic_strike_focus``
= f draws f n of the initial points from a normal around the strike
(the payoff's kink).
"""

from __future__ import annotations

from typing import Optional

import torch

from pinnrl_tpu_torch.ops.derivatives import directional_derivative
from pinnrl_tpu_torch.pdes.base import Coeffs, PDEBase, register_pde


@register_pde
class BlackScholesEquation(PDEBase):
    pde_type = "black_scholes"
    default_parameters = {"sigma": 0.2, "r": 0.05}
    spatial_orders = (1, 2)
    temporal_orders = (1,)

    def _sigma(self, coeffs: Optional[Coeffs]):
        return self.coeff(coeffs, "sigma", default=0.2)

    def _r(self, coeffs: Optional[Coeffs]):
        return self.coeff(coeffs, "r", default=0.05)

    def time_sign(self) -> float:
        """+1 for calendar time, -1 for time to maturity."""
        to_maturity = str(self.parameters.get("time_convention", "calendar")) == "to_maturity"
        return -1.0 if to_maturity else 1.0

    def _strike_focus(self):
        """(strike, width) of the IC's focused draw."""
        spec = self.settings.exact_solution or {}
        strike = float(spec.get("strike_price", spec.get("strike", 1.0)))
        lo, hi = self.domain[0]
        return strike, float(self.parameters.get("ic_strike_width", 0.025 * (hi - lo)))

    def _strike_focused_points(self, u_uniform: torch.Tensor, normal: torch.Tensor):
        """IC points from unit uniforms (n_u, dim) and standard normals
        (n_focus, dim): the uniform part over the domain, the focused part
        at strike + width * normal clipped to it, at ``time_domain[0]``."""
        los, his = self._space_bounds(u_uniform.device)
        strike, width = self._strike_focus()
        x_g = torch.minimum(torch.maximum(strike + width * normal, los), his)
        x = torch.cat([los + (his - los) * u_uniform, x_g], dim=0)
        return x, torch.full((x.shape[0], 1), self.time_domain[0], dtype=x.dtype,
                             device=x.device)

    def _sample_initial_points(self, generator: torch.Generator, n: int):
        """With ``parameters.ic_strike_focus`` = f > 0, round(f n) of the
        points are drawn around the strike (width
        ``parameters.ic_strike_width``, default 2.5% of the span), the rest
        uniformly."""
        frac = float(self.parameters.get("ic_strike_focus", 0.0) or 0.0)
        if frac <= 0.0:
            return super()._sample_initial_points(generator, n)
        n_focus = int(round(frac * n))
        dev = generator.device
        u = torch.rand((n - n_focus, self.dimension), generator=generator, device=dev,
                       dtype=self.dtype)
        g = torch.randn((n_focus, self.dimension), generator=generator, device=dev,
                        dtype=self.dtype)
        return self._strike_focused_points(u, g)

    def canonicalize_coeffs(self, coeffs):
        """sigma enters the residual only as sigma^2: the canonical
        volatility is the non-negative root."""
        out = dict(coeffs)
        if "sigma" in out:
            out["sigma"] = abs(float(out["sigma"]))
        return out

    def residual_pointwise(self, u, z: torch.Tensor, coeffs: Optional[Coeffs]):
        """Batched over the points of ``z`` (S = z[:, ax]):
        V_t - s r V + s sum_ax (0.5 sigma^2 S^2 V_SS + r S V_S), s the
        time sign."""
        V = u(z)
        V_t = directional_derivative(u, z, self.dimension, 1)[0]
        sigma, r = self._sigma(coeffs), self._r(coeffs)
        sign = self.time_sign()
        res = V_t - sign * r * V
        for ax in range(self.dimension):
            S = z[:, ax]
            V_S, V_SS = directional_derivative(u, z, ax, 2)
            res = res + sign * (0.5 * sigma**2 * S**2 * V_SS + r * S * V_S)
        return res

    def exact_solution(self, x, t, coeffs: Optional[Coeffs] = None, use_cdf: bool = False):
        """The call price with erf (reference parity) or, with ``use_cdf`` or
        ``exact_solution.cdf``, the normal CDF."""
        if not self.settings.exact_solution:
            return None
        spec = self.settings.exact_solution
        K = float(spec.get("strike_price", spec.get("strike", 1.0)))
        sigma, r = self._sigma(coeffs), self._r(coeffs)
        use_cdf = use_cdf or bool(spec.get("cdf", False))
        cdf = torch.special.ndtr if use_cdf else torch.erf

        def one_dim(S):
            S_safe = torch.clamp(S, min=1e-6)
            t_safe = torch.clamp(t, min=1e-6)
            d1 = (torch.log(S_safe / K) + (r + 0.5 * sigma**2) * t_safe) / (sigma * torch.sqrt(t_safe))
            d2 = d1 - sigma * torch.sqrt(t_safe)
            return S * cdf(d1) - K * torch.exp(-r * t_safe) * cdf(d2)

        if self.dimension == 1:
            return one_dim(x[:, 0:1])
        sol = torch.ones_like(x[:, 0:1])
        for dim in range(self.dimension):
            sol = sol * one_dim(x[:, dim : dim + 1])
        return sol
