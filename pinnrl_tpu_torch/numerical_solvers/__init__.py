"""Numerical reference solvers. The spectral phase-field solver (ETDRK4) is
ported; the heat finite-difference solver of ``pinnrl_tpu`` is not (no
path of the port reads it)."""

from pinnrl_tpu_torch.numerical_solvers.spectral import (  # noqa: F401
    SpectralResult,
    build_phase_field_reference,
    interp_trajectory,
    solve_phase_field_1d,
    spinodal_ic,
)
