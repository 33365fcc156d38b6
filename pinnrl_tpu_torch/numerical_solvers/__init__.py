"""Numerical reference solvers: the spectral phase-field solver (ETDRK4)
and the heat finite-difference wrapper (``HeatEquationFDM``)."""

from pinnrl_tpu_torch.numerical_solvers.heat_fdm import HeatEquationFDM  # noqa: F401
from pinnrl_tpu_torch.numerical_solvers.spectral import (  # noqa: F401
    SpectralResult,
    build_phase_field_reference,
    interp_trajectory,
    solve_phase_field_1d,
    spinodal_ic,
)
