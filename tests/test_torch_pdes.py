"""Burgers PDE: exact solutions, IC/BC targets and compute_loss of the port
against pinnrl_tpu, on bridged parameters.

jax.random and torch.Generator give different streams, so the BC/IC points
are drawn with JAX's own samplers under the key compute_loss derives, and
injected into the port. Tolerance: 1e-5 relative per component (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import burgers_pair, inject_points, jax_bc_ic_points, points, rel_to_max

TOL = 1e-5


@pytest.mark.parametrize("fused", [True, False])
def test_compute_loss_components_match_jax(monkeypatch, fused):
    pair = burgers_pair()
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)
    if fused:
        assert pair.tpde.attach_fused_residual_kernel(pair.tmodel)
    x, t = points(21, 128)
    key = jax.random.PRNGKey(4)
    ref = pair.jpde.compute_loss(pair.jmodel.apply, pair.jmodel.params,
                                 jnp.asarray(x), jnp.asarray(t), key=key)
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, 128))
    got = pair.tpde.compute_loss(pair.tmodel.apply, pair.tmodel.params,
                                 torch.from_numpy(x), torch.from_numpy(t))
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < TOL, k
    for k in ("smoothness", "data"):
        assert float(got[k]) == float(ref[k]) == 0.0


@pytest.mark.parametrize("sol", [
    {"type": "traveling_wave", "amplitude": 0.5, "speed": 0.5, "center": -0.25},
    {"type": "cole_hopf", "viscosity": 0.01, "initial_frequency": 1.0},
    {"type": "tanh", "epsilon": 0.1},
])
def test_exact_solutions_and_targets_match_jax(sol):
    pair = burgers_pair()
    for cfg in (pair.jcfg, pair.tcfg):
        cfg.pde.exact_solution = dict(sol)
        cfg.pde.initial_condition = {"type": sol["type"]} if sol["type"] != "cole_hopf" else {
            "type": "sine", "amplitude": -1.0, "frequency": 1.0}
    from pinnrl_tpu.pdes import create_pde as jax_create_pde
    from pinnrl_tpu_torch.pdes import create_pde

    jpde, tpde = jax_create_pde(pair.jcfg), create_pde(pair.tcfg)
    x, t = points(2, 300)
    for fn in ("exact_solution",):
        ref = np.asarray(getattr(jpde, fn)(jnp.asarray(x), jnp.asarray(t)))
        got = getattr(tpde, fn)(torch.from_numpy(x), torch.from_numpy(t))
        assert rel_to_max(got, ref) < TOL
    for name in ("initial", "dirichlet"):
        ref = np.asarray(jpde.boundary_conditions[name](jnp.asarray(x), jnp.asarray(t)))
        got = tpde.boundary_conditions[name](torch.from_numpy(x), torch.from_numpy(t))
        assert rel_to_max(got, ref) < TOL, name


def test_samplers_shapes_and_ranges():
    pair = burgers_pair()
    gen = torch.Generator().manual_seed(0)
    xb, tb = pair.tpde._sample_boundary_points(gen, 64)
    assert xb.shape == (64, 1) and tb.shape == (64, 1)
    assert set(xb[:32, 0].tolist()) == {-1.0} and set(xb[32:, 0].tolist()) == {1.0}
    assert float(tb.min()) >= 0.0 and float(tb.max()) <= 1.0
    xi, ti = pair.tpde._sample_initial_points(gen, 50)
    assert xi.shape == (50, 1) and torch.equal(ti, torch.zeros(50, 1))
    x, t = pair.tpde.generate_collocation_points(gen, 40, "uniform")
    assert x.shape == (40, 1) and t.shape == (40, 1)
    assert float(x.abs().max()) <= 1.0
    pair.tpde.attach_fast_bundle(pair.tmodel)

    def residual_fn(xx, tt):
        return pair.tpde.residual_score(pair.tmodel.apply, pair.tmodel.params, xx, tt)

    with torch.no_grad():
        x, t = pair.tpde.generate_collocation_points(gen, 40, "residual_based", residual_fn=residual_fn)
    assert x.shape == (40, 1) and t.shape == (40, 1)
    assert float(x.abs().max()) <= 1.0 and float(t.min()) >= 0.0 and float(t.max()) <= 1.0
    assert len(set(x[:, 0].tolist())) == 40  # drawn without replacement from the pool


def test_validate_reports_finite_metrics():
    pair = burgers_pair()
    metrics = pair.tpde.validate(pair.tmodel.apply, pair.tmodel.params, num_points=500)
    assert set(metrics) == {"l2_error", "max_error", "mean_error", "rel_l2"}
    assert all(np.isfinite(v) for v in metrics.values())
    # Validation never runs a kernel wrapper's gradient path.
    again = pair.tpde.validate(pair.tmodel.apply, pair.tmodel.params, num_points=500)
    assert again == metrics
