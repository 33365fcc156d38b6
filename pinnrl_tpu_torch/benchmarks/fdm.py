"""Finite-difference baselines for the heat and wave equations, as
``pinnrl_tpu.benchmarks.fdm``.

The time loop runs on the device in float32, one eager stencil update per
step (the JAX package scans it as one XLA program); the host reads the
field back once, after the loop. The grid and the initial data are made on
the CPU and moved, so a solve on the card and one on the CPU start from the
same bits (the leapfrog field moves by ~4e-4 after 2000 steps for a
one-ulp change of its first rows). Stability guards:
- heat: r = alpha dt / dx^2 <= 0.5
- wave: CFL c dt / dx <= 1
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from pinnrl_tpu_torch.config import resolve_device


@dataclass
class FDMResult:
    """A solution on the (t, x) grid."""

    x: np.ndarray  # (nx,)
    t: np.ndarray  # (nt,)
    u: np.ndarray  # (nt, nx)
    scheme: str
    stability: float  # r (heat) or CFL (wave)
    l2_error: Optional[float] = None  # vs analytic, when available

    def final_state(self) -> np.ndarray:
        return self.u[-1]


def _default_heat_ic(x: torch.Tensor, L: float, amplitude: float = 1.0, k: float = 2.0):
    return amplitude * torch.sin(2 * math.pi * k * x / L)


def _grid(lo: float, hi: float, n: int):
    """The float32 grid on the CPU and its spacing."""
    x = torch.linspace(lo, hi, n, dtype=torch.float32)
    return x, float(x[1] - x[0])


def _leapfrog(u: torch.Tensor, r2: float) -> torch.Tensor:
    """Fill the interior of rows 2.. of ``u`` (nt, nx) from rows 0 and 1
    and the end columns: u_next = 2 u - u_prev + r2 lap(u), the last
    product and sum as one fused multiply-add (``add``'s ``alpha``), as XLA
    contracts it."""
    for i in range(2, u.shape[0]):
        prev = u[i - 1]
        lap = prev[2:] - 2 * prev[1:-1] + prev[:-2]
        torch.add(2 * prev[1:-1] - u[i - 2, 1:-1], lap, alpha=r2, out=u[i, 1:-1])
    return u


def solve_heat_1d(
    alpha: float = 0.01,
    x_min: float = 0.0,
    x_max: float = 2.0,
    nx: int = 51,
    t_max: float = 0.5,
    nt: int = 2001,
    ic: Optional[Callable] = None,
    amplitude: float = 1.0,
    frequency: float = 2.0,
    device: Optional[str] = None,
) -> FDMResult:
    """Explicit Euler with a periodic roll stencil, on ``device`` (the card
    unless the caller names one; raises without it)."""
    device = resolve_device("cuda" if device is None else device)
    x, dx = _grid(x_min, x_max, nx)
    dt = t_max / (nt - 1)
    r = alpha * dt / dx**2
    if r > 0.5:
        raise ValueError(
            f"Explicit heat scheme unstable: r={r:.4f} > 0.5 "
            f"(reduce dt or increase dx)"
        )
    L = x_max - x_min
    u0 = (ic(x) if ic is not None else _default_heat_ic(x, L, amplitude, frequency)).to(device)
    x = x.to(device)

    # Periodic stencil: x[0] and x[-1] are the same physical point on an
    # inclusive grid, so the roll wraps over the first nx-1 cells only.
    v = torch.empty((nt, nx - 1), dtype=torch.float32, device=device)
    v[0] = u0[:-1]
    for i in range(1, nt):
        prev = v[i - 1]
        lap = torch.roll(prev, -1) - 2 * prev + torch.roll(prev, 1)
        torch.add(prev, lap, alpha=r, out=v[i])  # one fused multiply-add, as XLA's
    u = torch.cat([v, v[:, :1]], dim=1)  # duplicate the wrap point

    # Analytic comparison for the default sine IC.
    t_grid = torch.linspace(0.0, t_max, nt, dtype=torch.float32).to(device)
    k_wave = 2 * math.pi * frequency / L
    exact = (
        amplitude
        * torch.exp(-alpha * k_wave**2 * t_grid[:, None])
        * torch.sin(k_wave * x[None, :])
    )
    l2 = float(torch.sqrt(torch.mean((u - exact) ** 2))) if ic is None else None
    return FDMResult(
        x=x.cpu().numpy(), t=t_grid.cpu().numpy(), u=u.cpu().numpy(),
        scheme="explicit_euler_periodic", stability=float(r), l2_error=l2,
    )


def solve_wave_1d(
    c: float = 1.0,
    x_min: float = 0.0,
    x_max: float = 1.0,
    nx: int = 101,
    t_max: float = 0.5,
    nt: int = 2001,
    ic: Optional[Callable] = None,
    device: Optional[str] = None,
) -> FDMResult:
    """Leap-frog with a Taylor first step and Dirichlet ends: the exact
    traces of the traveling wave sin(2 pi (x - c t)) for the default IC (its
    exact solution), zero for a given ``ic``."""
    device = resolve_device("cuda" if device is None else device)
    x, dx = _grid(x_min, x_max, nx)
    dt = t_max / (nt - 1)
    cfl = c * dt / dx
    if cfl > 1.0:
        raise ValueError(f"Wave CFL violated: c*dt/dx={cfl:.4f} > 1")
    r2 = cfl**2

    if ic is None:
        u0 = torch.sin(2 * math.pi * x)
        v0 = -2 * math.pi * c * torch.cos(2 * math.pi * x)  # du/dt at t=0
    else:
        u0 = ic(x)
        v0 = torch.zeros_like(u0)

    t_grid = torch.linspace(0.0, t_max, nt, dtype=torch.float32)
    u = torch.empty((nt, nx), dtype=torch.float32)
    u[0] = u0
    # Taylor first step: u1 = u0 + dt*v0 + 0.5*r2*lap(u0).
    u[1, 1:-1] = u0[1:-1] + dt * v0[1:-1] + 0.5 * r2 * (u0[2:] - 2 * u0[1:-1] + u0[:-2])
    if ic is None:
        # The exact Dirichlet traces, the first step's at dt.
        u[2:, 0] = torch.sin(2 * math.pi * (x[0] - c * t_grid[2:]))
        u[2:, -1] = torch.sin(2 * math.pi * (x[-1] - c * t_grid[2:]))
        u[1, 0] = torch.sin(2 * math.pi * (x[0] - c * dt))
        u[1, -1] = torch.sin(2 * math.pi * (x[-1] - c * dt))
    else:  # v0 = 0 and lap = 0 at the ends: each end keeps its first value
        u[1:, 0], u[1:, -1] = u0[0], u0[-1]
    x, t_grid = x.to(device), t_grid.to(device)
    u = _leapfrog(u.to(device), r2)

    exact = torch.sin(2 * math.pi * (x[None, :] - c * t_grid[:, None]))
    l2 = float(torch.sqrt(torch.mean((u - exact) ** 2))) if ic is None else None
    return FDMResult(
        x=x.cpu().numpy(), t=t_grid.cpu().numpy(), u=u.cpu().numpy(),
        scheme="leapfrog_dirichlet", stability=float(cfl), l2_error=l2,
    )
