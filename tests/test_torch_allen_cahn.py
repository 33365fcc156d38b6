"""The Allen-Cahn equation, its stationary-interface recipe and its dynamics
recipe (the ETDRK4 spectral trajectory as exact solution and IC, periodic
BCs): the port against pinnrl_tpu, and kernel 1's Allen-Cahn variant
through its host launcher with the plain twins.

Tolerances:
- residual (order 2): 1e-5 relative to max (tests/test_torch_jet.py);
- tanh exact solutions and IC targets: 1e-6 relative to max (float32; the
  width sqrt(2) eps is rounded once here and twice in JAX);
- the spectral target (exact solution, IC, validation's rel-L2): 1e-5
  relative (the trajectories agree to ~3e-7 of max, tests/test_torch_spectral.py);
- kernel 1 against the JAX Pallas kernel in interpret mode and the launcher
  against autograd: loss 1e-5 relative, gradients 1e-4 relative to max;
  causal 1e-4 and 1e-3 (the JAX suite's bounds);
- compute_loss: 1e-5 relative per component (the periodic loss: one jvp
  of a LayerNorm network, as in tests/test_torch_heat.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (DOMAINS, FUSED_TOLS, inject_periodic_draws, inject_points,
                                  jax_bc_ic_points, launcher_vs_jax_kernel, pde_pair,
                                  plain_vs_launcher, points, rel_to_max, small_recipe_trainer,
                                  sorted_z)

from pinnrl_tpu.benchmarks import convergence as jax_conv
from pinnrl_tpu.sampling import sample_uniform as jax_sample_uniform
from pinnrl_tpu_torch.ops.kernels import fused_step

DOMAIN = DOMAINS["allen_cahn"]
STATIONARY = jax_conv.RECIPES["allen_cahn"]["pde"]
DYNAMICS = jax_conv.RECIPES["allen_cahn_dynamics"]["pde"]
DYN_DOMAIN = dict(domain=((0.0, 2.0 * np.pi),), time_domain=(0.0, 4.0))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch,bundle", [("fourier", True), ("fourier", False),
                                         ("feedforward", True)])
def test_residual_matches_jax(arch, bundle):
    pair = pde_pair("allen_cahn", arch=arch, pde={"parameters": {"epsilon": 0.3}})
    pair.jpde.attach_fast_bundle(pair.jmodel)
    assert pair.tpde.attach_fast_bundle(pair.tmodel, enable=bundle) == bundle
    x, t = points(5, 96, **DOMAIN)
    ref = pair.jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                     jnp.asarray(t))
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert got.shape == (96, 1)
    assert rel_to_max(got, np.asarray(ref)) < 1e-5


@pytest.mark.parametrize("kind,dim", [("tanh", 1), ("stationary_interface", 1), ("tanh", 2),
                                      ("stationary_interface", 2)])
def test_tanh_targets_match_jax(kind, dim):
    """The exact solution, the IC and the exact Dirichlet BC targets."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.pdes import create_pde as jax_create_pde
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.pdes import create_pde

    cfgs = [jax_load_config(pde_type="allen_cahn"), load_config(pde_type="allen_cahn", device="cpu")]
    for cfg in cfgs:
        cfg.pde.exact_solution = {"type": kind}
        cfg.pde.initial_condition = {"type": kind}
        cfg.pde.boundary_conditions = {"dirichlet": {"type": "exact"}}
        cfg.pde.dimension = dim
        cfg.pde.domain = [[-1.0, 1.0]] * dim
    jpde, tpde = jax_create_pde(cfgs[0]), create_pde(cfgs[1])
    rng = np.random.default_rng(dim)
    x = rng.uniform(-1.0, 1.0, (300, dim)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, (300, 1)).astype(np.float32)
    ref = np.asarray(jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
    assert rel_to_max(tpde.exact_solution(_t(x), _t(t)), ref) < 1e-6
    assert sorted(tpde.boundary_conditions) == sorted(jpde.boundary_conditions)
    for name in jpde.boundary_conditions:
        ref = np.asarray(jpde.boundary_conditions[name](jnp.asarray(x), jnp.asarray(t)))
        got = tpde.boundary_conditions[name](_t(x), _t(t))
        assert got.shape == ref.shape and rel_to_max(got, ref) < 1e-6, name


@pytest.fixture(scope="module")
def dynamics_pair():
    """The allen_cahn_dynamics recipe's PDE block (its spectral trajectory:
    nx 128, dt 2e-3 over [0, 4]) in both packages, at small width."""
    return pde_pair("allen_cahn", pde=DYNAMICS)


def test_spectral_targets_and_validation_match_jax(dynamics_pair):
    pair = dynamics_pair
    jpde, tpde = pair.jpde, pair.tpde
    assert tpde._spectral.u.shape == jpde._spectral.u.shape == (129, 128)
    assert tpde._spectral.u.device == tpde.device
    assert "periodic" in tpde.boundary_conditions
    x, t = points(2, 300, **DYN_DOMAIN)
    t[:10] = np.float32(0.0)
    t[10:20] = np.float32(4.0)
    ref = np.asarray(jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
    assert rel_to_max(tpde.exact_solution(_t(x), _t(t)), ref) < 1e-5
    ref = np.asarray(jpde.boundary_conditions["initial"](jnp.asarray(x), jnp.asarray(t)))
    assert rel_to_max(tpde.boundary_conditions["initial"](_t(x), _t(t)), ref) < 1e-5
    key = jax.random.PRNGKey(3)
    ref = jpde.validate(pair.jmodel.apply, pair.jmodel.params, key=key, num_points=500)
    xv, tv = jax_sample_uniform(key, 500, jpde.domain, jpde.time_domain)
    with torch.no_grad():
        got = tpde._validate_on(pair.tmodel.apply, pair.tmodel.params, _t(xv), _t(tv))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-5 * abs(v), k


@pytest.mark.parametrize("eps", [0.0, 1.0])
@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_kernel1_launcher_matches_jax_interpret_kernel(arch, eps):
    pair = pde_pair("allen_cahn", arch=arch, causal_eps=eps, pde={"parameters": {"epsilon": 0.3}})
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert (spec.x_order, spec.residual, spec.epsilon) == (2, "allen_cahn", 0.3)
    loss_rel, grad_rels = launcher_vs_jax_kernel(pair, sorted_z(7, 256, DOMAIN))
    loss_tol, grad_tol = FUSED_TOLS[eps]
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel1_launcher_matches_autograd(causal, layer_norm):
    pair = pde_pair("allen_cahn", causal_eps=1.0 if causal else 0.0, hidden=(32, 24, 16),
                    layer_norm=layer_norm)
    loss_rel, grad_rels = plain_vs_launcher(pair, sorted_z(3, 300, DOMAIN))
    loss_tol, grad_tol = FUSED_TOLS[1.0 if causal else 0.0]
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


@pytest.mark.parametrize("fused", [True, False])
def test_compute_loss_matches_jax(monkeypatch, fused):
    """The stationary recipe's block (exact Dirichlet BC and IC)."""
    pair = pde_pair("allen_cahn", pde=STATIONARY)
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)
    assert pair.tpde.attach_fused_residual_kernel(pair.tmodel,
                                                  enable="on" if fused else "off") == fused
    x, t = points(21, 128, **DOMAIN)
    key = jax.random.PRNGKey(4)
    ref = pair.jpde.compute_loss(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                 jnp.asarray(t), key=key)
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, 128))
    got = pair.tpde.compute_loss(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < 1e-5, k


@pytest.mark.parametrize("fused", [True, False])
def test_dynamics_compute_loss_matches_jax(monkeypatch, dynamics_pair, fused):
    """The dynamics block: periodic BC loss (JAX's draws), the spectral IC."""
    pair = dynamics_pair
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)
    assert pair.tpde.attach_fused_residual_kernel(pair.tmodel,
                                                  enable="on" if fused else "off") == fused
    x, t = points(22, 128, **DYN_DOMAIN)
    key = jax.random.PRNGKey(5)
    ref = pair.jpde.compute_loss(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                 jnp.asarray(t), key=key)
    inject_periodic_draws(monkeypatch, pair, key, 128)
    got = pair.tpde.compute_loss(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < 1e-5, k


@pytest.mark.parametrize("key", ["allen_cahn", "allen_cahn_dynamics"])
def test_recipe_trains_on_kernel1_and_its_loss_falls(key):
    """6 epochs (3 Adam epochs of 2 steps, then 3 L-BFGS iterations) at CPU
    size; the dynamics recipe's periodic loss and spectral IC included."""
    trainer = small_recipe_trainer(key)
    assert trainer.fused_kernel_active and trainer.fast_bundle_active
    spec = fused_step._spec(trainer.model, trainer.pde)
    assert spec.epsilon == (0.5 if key == "allen_cahn_dynamics" else 0.1)
    hist = trainer.train(seed=0)["history"]["train_loss"]
    assert len(hist) == 6 and all(np.isfinite(hist))
    assert hist[-1] < hist[0]
