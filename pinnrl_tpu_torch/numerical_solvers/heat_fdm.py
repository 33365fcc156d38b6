"""Heat-equation FDM wrapper for PINN validation, as
``pinnrl_tpu.numerical_solvers.heat_fdm``: a class around
``benchmarks.fdm.solve_heat_1d`` (on the PDE's device) that compares a
trained PINN with the finite-difference field on the same grid."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pinnrl_tpu_torch.benchmarks.fdm import FDMResult, solve_heat_1d


class HeatEquationFDM:
    def __init__(self, pde, nx: int = 101, nt: int = 2001, t_max: Optional[float] = None):
        self.pde = pde
        self.nx = nx
        self.nt = nt
        self.t_max = t_max if t_max is not None else pde.time_domain[1]

    def solve(self) -> FDMResult:
        alpha = float(self.pde.coeff(None, "alpha"))
        spec = self.pde.settings.exact_solution or {}
        # Stability: double nt until r <= 0.5.
        nt = self.nt
        x_min, x_max = self.pde.domain[0]
        dx = (x_max - x_min) / (self.nx - 1)
        while alpha * (self.t_max / (nt - 1)) / dx**2 > 0.5:
            nt *= 2
        return solve_heat_1d(
            alpha=alpha,
            x_min=x_min,
            x_max=x_max,
            nx=self.nx,
            t_max=self.t_max,
            nt=nt,
            amplitude=float(spec.get("amplitude", 1.0)),
            frequency=float(spec.get("frequency", 2.0)),
            device=self.pde.device,
        )

    def compare_with_pinn(self, apply_fn, params) -> Dict[str, float]:
        """L2 and max error between the PINN field and the FDM field on the
        FDM grid (the network evaluated on the parameters' device)."""
        res = self.solve()
        X, T = np.meshgrid(res.x, res.t, indexing="xy")
        device = next(iter(params.values())).device
        z = torch.as_tensor(np.stack([X.reshape(-1), T.reshape(-1)], axis=-1),
                            dtype=torch.float32, device=device)
        with torch.no_grad():
            u_pinn = apply_fn(params, z).cpu().numpy().reshape(len(res.t), len(res.x), -1)[..., 0]
        diff = u_pinn - res.u
        return {
            "fdm_vs_pinn_l2": float(np.sqrt(np.mean(diff**2))),
            "fdm_vs_pinn_max": float(np.max(np.abs(diff))),
            "fdm_l2_vs_exact": res.l2_error if res.l2_error is not None else float("nan"),
        }
