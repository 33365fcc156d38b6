"""The convection equation and its recipe: the port against pinnrl_tpu, and
kernel 1's order-1 variant (3 stacked streams [u; u_x; u_t]) through its
host launcher with the plain twins.

Tolerances:
- residual (order 1): 1e-5 relative to max (tests/test_torch_jet.py's
  bound for orders <= 2);
- exact solution and IC/BC targets: 1e-6 relative to max (float32; the
  sine's argument is formed in another order);
- kernel 1 against the JAX Pallas kernel in interpret mode: loss 1e-5
  relative, gradients 1e-4 relative to max; causal 1e-4 and 1e-3 (the JAX
  suite's fused-kernel bounds); the launcher against autograd on the plain
  version: the same bounds;
- compute_loss: 1e-5 relative per component.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (DOMAINS, FUSED_TOLS, inject_points, jax_bc_ic_points,
                                  launcher_vs_jax_kernel, pde_pair, plain_vs_launcher, points,
                                  rel_to_max, small_recipe_trainer, sorted_z)

from pinnrl_tpu.benchmarks import convergence as jax_conv
from pinnrl_tpu_torch.ops.kernels import fused_step
from pinnrl_tpu_torch.pdes import create_pde

DOMAIN = DOMAINS["convection"]
RECIPE_PDE = jax_conv.RECIPES["convection"]["pde"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch,bundle", [("fourier", True), ("fourier", False),
                                         ("feedforward", True)])
def test_residual_matches_jax(arch, bundle):
    """Through the stacked-jet bundle and through the generic engine."""
    pair = pde_pair("convection", arch=arch, pde={"parameters": {"velocity": 0.7}})
    pair.jpde.attach_fast_bundle(pair.jmodel)
    assert pair.tpde.attach_fast_bundle(pair.tmodel, enable=bundle) == bundle
    x, t = points(5, 96, **DOMAIN)
    ref = pair.jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                     jnp.asarray(t))
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert got.shape == (96, 1)
    assert rel_to_max(got, np.asarray(ref)) < 1e-5


@pytest.mark.parametrize("velocity", [[1.0], 0.5, [0.5, -1.5]])
def test_exact_solution_and_targets_match_jax(velocity):
    """The shipped block (velocity [1.0], frequency-1 IC) and the recipe's
    (frequency-2 IC, exact Dirichlet BC); a scalar velocity, and one value
    per axis in two dimensions."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.pdes import create_pde as jax_create_pde
    from pinnrl_tpu_torch.config import load_config

    dim = len(velocity) if isinstance(velocity, list) else 1
    for over in ({}, RECIPE_PDE):
        cfgs = [jax_load_config(pde_type="convection"),
                load_config(pde_type="convection", device="cpu")]
        for cfg in cfgs:
            for k, v in over.items():
                setattr(cfg.pde, k, v)
            cfg.pde.parameters["velocity"] = velocity
            cfg.pde.dimension = dim
            cfg.pde.domain = [[0.0, 2.0]] * dim
        jpde, tpde = jax_create_pde(cfgs[0]), create_pde(cfgs[1])
        rng = np.random.default_rng(dim)
        x = rng.uniform(0.0, 2.0, (300, dim)).astype(np.float32)
        t = rng.uniform(0.0, 1.0, (300, 1)).astype(np.float32)
        assert tpde._velocity(None) == [float(v) for v in jpde._velocity(None)]
        ref = np.asarray(jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
        assert rel_to_max(tpde.exact_solution(_t(x), _t(t)), ref) < 1e-6
        for name in jpde.boundary_conditions:
            ref = np.asarray(jpde.boundary_conditions[name](jnp.asarray(x), jnp.asarray(t)))
            got = tpde.boundary_conditions[name](_t(x), _t(t))
            assert got.shape == ref.shape, name
            assert rel_to_max(got, ref) < 1e-6 if np.abs(ref).max() > 0 else not got.abs().max()


@pytest.mark.parametrize("eps", [0.0, 1.0])
@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_kernel1_launcher_matches_jax_interpret_kernel(arch, eps):
    """Kernel 1's convection variant (x-order 1) through its launcher with
    the plain twins, against the JAX kernel (tile 32) in interpret mode."""
    pair = pde_pair("convection", arch=arch, causal_eps=eps)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert (spec.x_order, spec.residual, spec.velocity) == (1, "convection", (1.0,))
    assert (spec.B is None) == (arch == "feedforward")
    loss_rel, grad_rels = launcher_vs_jax_kernel(pair, sorted_z(7, 256, DOMAIN))
    loss_tol, grad_tol = FUSED_TOLS[eps]
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel1_launcher_matches_autograd(causal, layer_norm):
    """The K = 1 transport backward and the convection twin against
    autograd on the plain version, three hidden layers."""
    pair = pde_pair("convection", causal_eps=1.0 if causal else 0.0, hidden=(32, 24, 16),
                    layer_norm=layer_norm)
    loss_rel, grad_rels = plain_vs_launcher(pair, sorted_z(3, 300, DOMAIN))
    loss_tol, grad_tol = FUSED_TOLS[1.0 if causal else 0.0]
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


@pytest.mark.parametrize("fused", [True, False])
def test_compute_loss_matches_jax(monkeypatch, fused):
    """The recipe's PDE block (exact Dirichlet BC, frequency-2 IC), with JAX's
    BC and IC draws."""
    pair = pde_pair("convection", pde=RECIPE_PDE)
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


def test_recipe_trains_on_kernel1_and_its_loss_falls():
    """6 epochs (3 Adam epochs of 2 steps, then 3 L-BFGS iterations) of the
    recipe at CPU size: kernel 1's order-1 variant on every loss, a falling
    loss."""
    trainer = small_recipe_trainer("convection")
    assert trainer.fused_kernel_active and trainer.fast_bundle_active
    hist = trainer.train(seed=0)["history"]["train_loss"]
    assert len(hist) == 6 and all(np.isfinite(hist))
    assert hist[-1] < hist[0]
