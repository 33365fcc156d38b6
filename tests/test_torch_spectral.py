"""The spectral phase-field solver (ETDRK4) and its trajectory reader: the
port against ``pinnrl_tpu.numerical_solvers.spectral``.

Tolerances:
- trajectories of both kinds (nx 64, 300 steps, float32): 1e-5 relative to
  max (measured ~3e-7: FFTs of two libraries, the same float32 weights);
- the float64 phi-function weights: equal to 1e-12 relative (the same
  numpy precompute);
- interp_trajectory on the same trajectory: 1e-6 relative to max (float32
  index arithmetic);
- the grids, times and the spinodal IC: 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import rel_to_max

from pinnrl_tpu.numerical_solvers import spectral as jax_spectral
from pinnrl_tpu_torch.numerical_solvers import spectral

MODES = ((1, 0.6), (2, 0.3))


@pytest.mark.parametrize("kind,eps,t_end", [("allen_cahn", 0.5, 1.2), ("cahn_hilliard", 0.5, 0.6),
                                            ("allen_cahn", 0.1, 0.6)])
def test_trajectory_matches_jax(kind, eps, t_end):
    """nx 64, dt 2e-3 (rounded to whole steps between 20 snapshots)."""
    kw = dict(eps=eps, t_end=t_end, nx=64, dt=2e-3, n_save=20)
    ref = jax_spectral.solve_phase_field_1d(kind, jax_spectral.spinodal_ic(MODES), **kw)
    got = spectral.solve_phase_field_1d(kind, spectral.spinodal_ic(MODES), device="cpu", **kw)
    assert got.u.shape == ref.u.shape == (21, 64) and got.u.dtype == torch.float32
    assert (got.kind, got.eps) == (ref.kind, ref.eps)
    assert rel_to_max(got.x, ref.x) < 1e-6 and np.array_equal(got.t, ref.t)
    assert rel_to_max(got.u, ref.u) < 1e-5
    assert float((got.u[-1] - got.u[0]).abs().max()) > 0.05  # the field moved


def test_cahn_hilliard_conserves_mass():
    got = spectral.solve_phase_field_1d("cahn_hilliard", spectral.spinodal_ic(MODES), 0.5, 0.6,
                                        nx=64, dt=2e-3, n_save=10, device="cpu")
    assert float(got.u.mean(dim=1).abs().max()) < 1e-6


def test_weights_match_jax():
    """The phi-function weights, float64, for an operator with its L = 0 mode."""
    L_h = -0.25 * np.arange(33, dtype=np.float64) ** 2
    dt = 1e-2
    z = dt * L_h
    r = np.exp(1j * np.pi * (np.arange(1, 33) - 0.5) / 32)
    LR = z[:, None] + r[None, :]
    ref_q = dt * np.real(np.mean((np.exp(LR / 2.0) - 1.0) / LR, axis=1))
    E, E2, Q, f1, f2, f3 = spectral._etdrk4_weights(L_h, dt)
    assert np.array_equal(E, np.exp(z)) and np.array_equal(E2, np.exp(z / 2.0))
    assert np.max(np.abs(Q - ref_q)) <= 1e-12 * np.max(np.abs(ref_q))
    # At L = 0 the weights are their limits: Q = dt / 2, f1 = f3 = dt / 6, f2 = dt / 6.
    for w in (f1, f2, f3):
        assert w[0] == pytest.approx(dt / 6.0, rel=1e-12)
    assert Q[0] == pytest.approx(dt / 2.0, rel=1e-12)


def test_interp_trajectory_matches_jax():
    """Periodic wrap in x (queries outside the period and at its end),
    clamping in t (before 0 and after t_end)."""
    rng = np.random.default_rng(0)
    traj = rng.standard_normal((17, 64)).astype(np.float32)
    xq = rng.uniform(-1.0, 7.5, (300, 1)).astype(np.float32)
    tq = rng.uniform(-0.5, 1.5, (300, 1)).astype(np.float32)
    xq[:3, 0] = (0.0, 2 * np.pi, 2 * np.pi * 63 / 64)
    tq[:3, 0] = (0.0, 1.0, 0.5)
    ref = jax_spectral.interp_trajectory(jnp.asarray(traj), jnp.asarray(xq), jnp.asarray(tq),
                                         0.0, 2 * np.pi, 1.0)
    got = spectral.interp_trajectory(torch.from_numpy(traj), torch.from_numpy(xq),
                                     torch.from_numpy(tq), 0.0, 2 * np.pi, 1.0)
    assert got.shape == (300, 1)
    assert rel_to_max(got, np.asarray(ref)) < 1e-6
    assert float(got[1, 0]) == pytest.approx(float(traj[-1, 0]), abs=1e-6)  # x = L wraps to 0


def test_spinodal_ic_matches_jax():
    x = np.linspace(-1.0, 3.0, 97, dtype=np.float32)
    for kw in (dict(), dict(modes=MODES, phase=0.3, x_min=-1.0, x_max=3.0)):
        ref = jax_spectral.spinodal_ic(**kw)(jnp.asarray(x))
        got = spectral.spinodal_ic(**kw)(torch.from_numpy(x))
        assert rel_to_max(got, np.asarray(ref)) < 1e-6


def test_build_phase_field_reference_matches_jax():
    """The allen_cahn_dynamics recipe's block, at nx 64 and 32 snapshots."""
    from pinnrl_tpu.benchmarks import convergence as jax_conv
    from pinnrl_tpu_torch.benchmarks import convergence

    cfgs = [jax_conv.build_recipe_config("allen_cahn_dynamics"),
            convergence.build_recipe_config("allen_cahn_dynamics", device="cpu")]
    for cfg in cfgs:
        cfg.pde.exact_solution = {**cfg.pde.exact_solution, "nx": 64, "n_save": 32}
    ref = jax_spectral.build_phase_field_reference("allen_cahn", cfgs[0].pde, 0.5)
    got = spectral.build_phase_field_reference("allen_cahn", cfgs[1].pde, 0.5, device="cpu")
    assert got.u.shape == ref.u.shape == (33, 64)
    assert rel_to_max(got.u, ref.u) < 1e-5


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="kind"):
        spectral.solve_phase_field_1d("heat", np.zeros(8), 0.5, 1.0, nx=8, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        spectral.solve_phase_field_1d("allen_cahn", np.zeros(7), 0.5, 1.0, nx=8, device="cpu")
    from pinnrl_tpu_torch.benchmarks import convergence

    cfg = convergence.build_recipe_config("allen_cahn_dynamics", device="cpu")
    cfg.pde.dimension = 2
    with pytest.raises(ValueError, match="1D"):
        spectral.build_phase_field_reference("allen_cahn", cfg.pde, 0.5, device="cpu")
