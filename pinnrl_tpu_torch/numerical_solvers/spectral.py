"""Fourier-spectral phase-field solvers: reference trajectories for
time-dependent Allen-Cahn and Cahn-Hilliard, as
``pinnrl_tpu.numerical_solvers.spectral``.

Scheme: periodic 1-D grid, rfft pseudo-spectral in space, ETDRK4 in time
(Kassam & Trefethen 2005): the stiff linear operator is integrated exactly
by exponential time differencing and the nonlinearity by a fourth-order RK
rule.

    CH:  u_t = (u^3 - u - eps^2 u_xx)_xx    L = -eps^2 k^4,  N = -k^2 F[u^3 - u]
    AC:  u_t = eps^2 u_xx + u - u^3         L = -eps^2 k^2,  N = F[u - u^3]

The phi-function weights are a float64 numpy precompute by the
contour-integral mean (stable near L = 0, where the k = 0 mode sits), cast
to float32 as in the JAX package. The stepping runs in float32 with
``torch.fft.rfft`` / ``irfft`` on the device of the caller's choice, in a
Python loop of ``steps_per_save`` steps per snapshot (JAX's ``lax.scan``).
``interp_trajectory`` reads a trajectory on tensors, so a PDE's exact
solution, IC and validation read it where the trajectory lies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass
class SpectralResult:
    """Trajectory on the solver grid: ``u`` (n_save + 1, nx) at times ``t``."""

    x: torch.Tensor  # (nx,)
    t: np.ndarray  # (n_save + 1,)
    u: torch.Tensor  # (n_save + 1, nx)
    kind: str
    eps: float


def _etdrk4_weights(L_h: np.ndarray, dt: float):
    """(E, E2, Q, f1, f2, f3) in float64 for the diagonal operator ``L_h``:
    each phi-function as the mean over 32 points of a unit circle around
    dt L (the contour-integral trick)."""
    z = dt * L_h
    M = 32
    r = np.exp(1j * np.pi * (np.arange(1, M + 1) - 0.5) / M)
    LR = z[:, None] + r[None, :]
    Q = dt * np.real(np.mean((np.exp(LR / 2.0) - 1.0) / LR, axis=1))
    f1 = dt * np.real(np.mean((-4.0 - LR + np.exp(LR) * (4.0 - 3.0 * LR + LR**2)) / LR**3, axis=1))
    f2 = dt * np.real(np.mean((2.0 + LR + np.exp(LR) * (-2.0 + LR)) / LR**3, axis=1))
    f3 = dt * np.real(np.mean((-4.0 - 3.0 * LR - LR**2 + np.exp(LR) * (4.0 - LR)) / LR**3, axis=1))
    return np.exp(z), np.exp(z / 2.0), Q, f1, f2, f3


def solve_phase_field_1d(
    kind: str,
    u0: Callable[[torch.Tensor], torch.Tensor] | torch.Tensor,
    eps: float,
    t_end: float,
    x_min: float = 0.0,
    x_max: float = 2.0 * np.pi,
    nx: int = 256,
    dt: float = 1e-4,
    n_save: int = 100,
    device: torch.device | str = "cuda",
) -> SpectralResult:
    """Integrate AC or CH on a periodic 1-D grid on ``device``; returns
    n_save + 1 snapshots. ``dt`` is rounded so that a whole number of steps
    lies between snapshots."""
    if kind not in ("allen_cahn", "cahn_hilliard"):
        raise ValueError(f"kind must be allen_cahn|cahn_hilliard, got {kind!r}")
    device = torch.device(device)
    L = x_max - x_min
    x = x_min + L * torch.arange(nx, dtype=torch.float32, device=device) / nx
    # k in float32 as the JAX package forms it; the precompute reads it in float64.
    k = np.float32(2.0 * np.pi / L) * np.fft.rfftfreq(nx, d=1.0 / nx).astype(np.float32)
    k2_h = (k * k).astype(np.float64)

    steps_total = int(round(t_end / dt))
    steps_per_save = max(steps_total // n_save, 1)
    steps_total = steps_per_save * n_save
    dt = t_end / steps_total

    if kind == "cahn_hilliard":
        L_h = -(eps**2) * k2_h * k2_h
        k2 = torch.from_numpy(k * k).to(device)

        def nonlinear(u):
            return -k2 * torch.fft.rfft(u**3 - u)

    else:
        L_h = -(eps**2) * k2_h

        def nonlinear(u):
            return torch.fft.rfft(u - u**3)

    E, E2, Q, f1, f2, f3 = (torch.from_numpy(a.astype(np.float32)).to(device)
                            for a in _etdrk4_weights(L_h, dt))

    def step(u_hat):
        Nu = nonlinear(torch.fft.irfft(u_hat, n=nx))
        a = E2 * u_hat + Q * Nu
        Na = nonlinear(torch.fft.irfft(a, n=nx))
        b = E2 * u_hat + Q * Na
        Nb = nonlinear(torch.fft.irfft(b, n=nx))
        c = E2 * a + Q * (2.0 * Nb - Nu)
        Nc = nonlinear(torch.fft.irfft(c, n=nx))
        return E * u_hat + Nu * f1 + 2.0 * (Na + Nb) * f2 + Nc * f3

    u_init = u0(x) if callable(u0) else torch.as_tensor(u0, dtype=torch.float32, device=device)
    if tuple(u_init.shape) != (nx,):
        raise ValueError(f"u0 must produce shape ({nx},), got {tuple(u_init.shape)}")

    u_hat = torch.fft.rfft(u_init)
    snaps = [u_init]
    for _ in range(n_save):
        for _ in range(steps_per_save):
            u_hat = step(u_hat)
        snaps.append(torch.fft.irfft(u_hat, n=nx))
    return SpectralResult(x=x, t=np.linspace(0.0, t_end, n_save + 1), u=torch.stack(snaps),
                          kind=kind, eps=float(eps))


def interp_trajectory(
    res_u: torch.Tensor,
    x_query: torch.Tensor,
    t_query: torch.Tensor,
    x_min: float,
    x_max: float,
    t_end: float,
) -> torch.Tensor:
    """Bilinear interpolation into an (n_t, nx) trajectory, periodic in x
    and clamped in t. ``x_query`` / ``t_query`` are (n, 1) columns on the
    trajectory's device; returns (n, 1)."""
    n_t, nx = res_u.shape
    L = x_max - x_min
    # Periodic fractional index in x (grid spacing L / nx, node nx wraps to 0).
    fx = (x_query[:, 0] - x_min) / L * nx
    ix0 = torch.floor(fx)
    wx = fx - ix0
    ix0 = torch.remainder(ix0.to(torch.int64), nx)
    ix1 = torch.remainder(ix0 + 1, nx)
    # Clamped fractional index in t.
    ft = torch.clamp(t_query[:, 0] / t_end, 0.0, 1.0) * (n_t - 1)
    it0 = torch.clamp(torch.floor(ft), 0, n_t - 2)
    wt = ft - it0
    it0 = it0.to(torch.int64)
    it1 = it0 + 1

    v0 = res_u[it0, ix0] * (1 - wx) + res_u[it0, ix1] * wx
    v1 = res_u[it1, ix0] * (1 - wx) + res_u[it1, ix1] * wx
    return (v0 * (1 - wt) + v1 * wt).reshape(-1, 1)


def spinodal_ic(
    modes=((1, 0.05), (2, 0.04), (3, 0.03)),
    phase: float = 0.0,
    x_min: float = 0.0,
    x_max: float = 2.0 * np.pi,
):
    """Few-mode cosine perturbation around u = 0, periodic on [x_min, x_max):
    the modes inside the unstable band grow, saturate at +-1, then coarsen."""
    L = x_max - x_min

    def u0(x):
        u = torch.zeros_like(x)
        for n_mode, amp in modes:
            u = u + amp * torch.cos(n_mode * 2.0 * np.pi * (x - x_min) / L + phase)
        return u

    return u0


def build_phase_field_reference(kind: str, settings, eps: float,
                                device: torch.device | str = "cuda") -> SpectralResult:
    """The spectral reference that a PDE's ``exact_solution.type: spectral``
    block describes, built on ``device``. The configured ``ic_modes`` give
    the field at absolute t = 0 and the solver integrates [0,
    time_domain[1]], so a window config reads the global reference
    restricted to its window."""
    spec = settings.exact_solution or {}
    if settings.dimension != 1:
        raise ValueError("spectral phase-field reference supports 1D only")
    x_min, x_max = settings.domain[0]
    modes = tuple(
        (int(n), float(a))
        for n, a in spec.get("ic_modes", ((1, 0.05), (2, 0.04), (3, 0.03)))
    )
    return solve_phase_field_1d(
        kind,
        spinodal_ic(modes, phase=float(spec.get("ic_phase", 0.0)), x_min=x_min, x_max=x_max),
        eps=eps,
        t_end=float(settings.time_domain[1]),
        x_min=x_min,
        x_max=x_max,
        nx=int(spec.get("nx", 256)),
        dt=float(spec.get("dt", 1e-3)),
        n_save=int(spec.get("n_save", 128)),
        device=device,
    )
