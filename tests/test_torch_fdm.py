"""The port's finite-difference baselines (``benchmarks/fdm.py``,
``numerical_solvers/heat_fdm.py``) and the ``fdm`` subcommand against
``pinnrl_tpu.benchmarks.fdm``.

Tolerances (each with its reason):
- heat fields and L2 errors 1e-5 absolute: the same float32 stencil, a
  diffusive one, from initial rows that differ by an ulp;
- the wave stencil from JAX's own first two rows and end traces: 1e-6 (it
  reproduces JAX's field bit for bit on the CPU: the last product and sum
  as one fused multiply-add, as XLA contracts them);
- the whole wave solve 1e-3 on the field and 5e-5 on its L2 error: torch
  and XLA round sin and linspace differently by an ulp, and the float32
  leapfrog carries a change of its first rows over dt = 2.5e-4 as a
  velocity error, which moves the field by up to 3.7e-4 after 2000 steps
  (measured; the L2 errors 2.815e-4 and 3.149e-4);
- ``compare_with_pinn`` 1e-5 absolute: the same network on bridged
  parameters, evaluated in float32 on the same grid;
- the stability number (r or CFL) 1e-5 relative: dx is the difference of
  two float32 grid points, and torch's linspace and JAX's round a point
  differently by one ulp (6e-8 at |x| ~ 1, 1.5e-6 of dx = 0.04);
- the stability guards' errors equal as strings.
"""

import jax
import numpy as np
import pytest
from torch_parity_helpers import pde_pair

from pinnrl_tpu.benchmarks import cli as jax_cli
from pinnrl_tpu.benchmarks.fdm import solve_heat_1d as jax_heat
from pinnrl_tpu.benchmarks.fdm import solve_wave_1d as jax_wave
from pinnrl_tpu.numerical_solvers.heat_fdm import HeatEquationFDM as JaxHeatFDM
from pinnrl_tpu_torch.benchmarks import cli
from pinnrl_tpu_torch.benchmarks.fdm import solve_heat_1d, solve_wave_1d
from pinnrl_tpu_torch.numerical_solvers import HeatEquationFDM

TOL = 1e-5


WAVE_FIELD_TOL = 1e-3
WAVE_L2_TOL = 5e-5


def _same(got, ref, field_tol=TOL, l2_tol=TOL):
    assert got.scheme == ref.scheme
    assert got.u.shape == ref.u.shape and got.u.dtype == np.float32
    np.testing.assert_allclose(got.x, np.asarray(ref.x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.t, np.asarray(ref.t), rtol=0, atol=1e-6)
    assert abs(got.stability - ref.stability) <= 1e-5 * ref.stability
    assert float(np.max(np.abs(got.u[:2] - ref.u[:2]))) < 1e-6
    assert float(np.max(np.abs(got.u - ref.u))) < field_tol
    if ref.l2_error is None:
        assert got.l2_error is None
    else:
        assert abs(got.l2_error - ref.l2_error) < l2_tol


@pytest.mark.parametrize("kw", [
    {}, {"nx": 41, "nt": 801, "t_max": 0.3, "alpha": 0.02},
    {"amplitude": 0.5, "frequency": 1.0, "x_min": -1.0, "x_max": 1.0},
])
def test_heat_matches_jax(kw):
    _same(solve_heat_1d(device="cpu", **kw), jax_heat(**kw))


WAVE_CASES = [{}, {"nx": 51, "nt": 1001, "c": 0.5, "t_max": 0.8}]


@pytest.mark.parametrize("kw", WAVE_CASES)
def test_wave_matches_jax(kw):
    _same(solve_wave_1d(device="cpu", **kw), jax_wave(**kw), WAVE_FIELD_TOL, WAVE_L2_TOL)


@pytest.mark.parametrize("kw", WAVE_CASES)
def test_wave_stencil_from_jax_rows_matches_jax(kw):
    import torch

    from pinnrl_tpu_torch.benchmarks.fdm import _leapfrog

    ref = jax_wave(**kw)
    u = torch.from_numpy(np.array(ref.u))
    u[2:, 1:-1] = 0.0
    got = _leapfrog(u, ref.stability**2).numpy()
    assert float(np.max(np.abs(got - np.asarray(ref.u)))) < 1e-6


def test_given_initial_conditions_match_jax():
    """A caller's IC: heat without a reference solution; wave with zero
    velocity and ends held at their initial values."""
    import jax.numpy as jnp
    import torch

    def bump(lib):
        return lambda x: lib.exp(-40.0 * (x - 0.5) ** 2)

    _same(solve_heat_1d(device="cpu", ic=bump(torch)), jax_heat(ic=bump(jnp)))
    _same(solve_wave_1d(device="cpu", ic=bump(torch)), jax_wave(ic=bump(jnp)), WAVE_FIELD_TOL)


@pytest.mark.parametrize("solver,kw", [("heat", {"nt": 11, "alpha": 0.1}), ("wave", {"nt": 11})])
def test_stability_guards_raise_as_jax(solver, kw):
    ours, ref = {"heat": (solve_heat_1d, jax_heat), "wave": (solve_wave_1d, jax_wave)}[solver]
    with pytest.raises(ValueError) as got:
        ours(device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        ref(**kw)
    assert str(got.value) == str(want.value)


def test_heat_fdm_wrapper_matches_jax():
    """solve() doubles nt until stable; compare_with_pinn evaluates the
    network on the FDM grid (heat's shipped block, a small bridged trunk)."""
    pair = pde_pair("heat", hidden=(16, 16), mapping=8)
    kw = dict(nx=101, nt=11, t_max=0.5)
    got_res = HeatEquationFDM(pair.tpde, **kw).solve()
    ref_res = JaxHeatFDM(pair.jpde, **kw).solve()
    assert got_res.u.shape[0] > 11
    _same(got_res, ref_res)
    got = HeatEquationFDM(pair.tpde, **kw).compare_with_pinn(pair.tmodel.apply, pair.tmodel.params)
    ref = JaxHeatFDM(pair.jpde, **kw).compare_with_pinn(
        pair.jmodel.apply, jax.tree_util.tree_map(np.asarray, pair.jmodel.params))
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) < TOL, k


def test_fdm_subcommand_prints_and_writes_jax_csv(tmp_path, capsys):
    """``cli fdm --pde all`` with the JAX package's table and CSV: the heat
    row equal as printed, the wave row's L2 error within the wave bound."""
    rc = cli.main(["fdm", "--csv", str(tmp_path / "t.csv"), "--device", "cpu"])
    ours = capsys.readouterr().out.split("\n")
    assert rc == 0 and jax_cli.main(["fdm", "--csv", str(tmp_path / "j.csv")]) == 0
    theirs = capsys.readouterr().out.split("\n")
    assert ours[:3] == theirs[:3] and ours[3].split()[:3] == theirs[3].split()[:3]
    got, ref = ((tmp_path / f).read_text().splitlines() for f in ("t.csv", "j.csv"))
    assert got[:2] == ref[:2] == ["pde,scheme,stability,l2_error", ref[1]]
    assert got[2].rsplit(",", 1)[0] == ref[2].rsplit(",", 1)[0]
    assert abs(float(got[2].rsplit(",", 1)[1]) - float(ref[2].rsplit(",", 1)[1])) < WAVE_L2_TOL
