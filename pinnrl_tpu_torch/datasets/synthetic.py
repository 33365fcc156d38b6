"""Synthetic Well-format trajectories for offline use, as
``pinnrl_tpu.datasets.synthetic``.

Exact 2D heat-kernel trajectories on a grid, written into the loader's
``.npz`` cache through its own flattening and cache-key code, so
``load_well_slice("synthetic_heat_2d", ...)`` and everything downstream
(data-mode training, the operator harness) run the pipeline a real Well
dataset would, without the download. The field is a superposition of
separable heat modes ``sum_k A_k sin(m_k x) sin(n_k y) exp(-alpha (m_k^2 +
n_k^2) t)``, an exact solution of ``u_t = alpha lap(u)`` on [0, pi]^2 with
zero Dirichlet BCs. The arrays equal the JAX package's bit for bit (the same
numpy code).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from pinnrl_tpu_torch.datasets.registry import get_entry
from pinnrl_tpu_torch.datasets.well_loader import _cache_file, _flatten_trajectory

ALPHA = 0.05
# Per-trajectory mode sets: (amplitude, m, n) terms. Trajectory i uses
# MODE_SETS[i % len(MODE_SETS)] scaled by a deterministic per-traj factor.
MODE_SETS = [
    ((1.0, 1, 1), (0.5, 2, 2)),
    ((0.8, 2, 1), (0.4, 1, 2)),
    ((1.0, 1, 2), (0.3, 3, 1)),
    ((0.7, 2, 2), (0.5, 1, 1)),
]


def generate_heat_2d_trajectory(
    traj_index: int = 0,
    n_steps: int = 24,
    nx: int = 48,
    ny: int = 48,
    alpha: float = ALPHA,
) -> np.ndarray:
    """(n_steps, nx, ny, 1) exact heat field for trajectory ``traj_index``."""
    entry = get_entry("synthetic_heat_2d")
    (x_lo, x_hi), (y_lo, y_hi) = entry.domain
    t_lo, t_hi = entry.time_domain
    x = np.linspace(x_lo, x_hi, nx)
    y = np.linspace(y_lo, y_hi, ny)
    t = np.linspace(t_lo, t_hi, n_steps)
    T, X, Y = np.meshgrid(t, x, y, indexing="ij")
    scale = 1.0 + 0.25 * (traj_index % 3)
    field = np.zeros_like(T)
    for amp, m, n in MODE_SETS[traj_index % len(MODE_SETS)]:
        field += (
            scale
            * amp
            * np.sin(m * X)
            * np.sin(n * Y)
            * np.exp(-alpha * (m * m + n * n) * T)
        )
    return field[..., None].astype(np.float32)


def ensure_synthetic_well_cache(
    name: str = "synthetic_heat_2d",
    split: str = "train",
    n_traj: int = 2,
    n_points: int = 8192,
    seed: int = 0,
    base: Optional[str] = None,
    overwrite: bool = False,
) -> Path:
    """Write the trajectories into the loader's cache (same key, same
    layout) so ``load_well_slice`` serves them without ``the_well``.

    'train' and 'test' sample the SAME trajectories at DISJOINT grid points
    (one permutation from ``default_rng(seed)``: the first ``n_points`` and
    the next ``n_points``), so the held-out error measures reconstruction
    of the field from scattered samples, the task a point-wise model u(x, t)
    can perform. For the same reason point-wise callers should use
    ``n_traj=1``: several trajectories put conflicting targets at equal
    coordinates. Refuses any name that is not a synthetic one.
    """
    if not name.startswith("synthetic"):
        raise ValueError("refusing to fabricate cache for a real Well dataset")
    entry = get_entry(name)
    cache = _cache_file(name, split, n_traj, n_points, seed, base)
    if cache.exists() and not overwrite:
        return cache

    clouds = [
        _flatten_trajectory(generate_heat_2d_trajectory(i), entry)
        for i in range(n_traj)
    ]
    x = np.concatenate([c["x"] for c in clouds], axis=0)
    t = np.concatenate([c["t"] for c in clouds], axis=0)
    u = np.concatenate([c["u"] for c in clouds], axis=0)
    total = x.shape[0]
    n = min(n_points, total // 2) if n_points else total // 2
    # One seed-keyed permutation shared by both splits -> disjoint subsets.
    perm = np.random.default_rng(seed).permutation(total)
    idx = perm[:n] if split == "train" else perm[n : 2 * n]
    x, t, u = x[idx], t[idx], u[idx]
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez(cache, x=x, t=t, u=u)
    return cache
