"""The pendulum and its two recipes: the port against pinnrl_tpu, linearized
and nonlinear; its three exact solutions, the velocity target (a jvp of the
exact solution in t), the residual through the bundle's time group alone
(spatial order 0), compute_loss, the energy and the phase space.

Tolerances:
- exact solutions, targets and the velocity target: 1e-6 relative to max
  (float32; the elliptic solution runs the same ops as JAX's,
  tests/test_torch_special.py);
- bundle streams and residual (orders <= 2): 1e-5 relative to max
  (tests/test_torch_jet.py's bound);
- compute_loss with JAX's BC, IC and velocity-IC draws: each component 1e-5
  relative and each parameter gradient 1e-4 relative to its max, the JAX
  suite's fused-kernel bounds (tests/test_pallas_parity_tpu.py:152-155);
- compute_energy and compute_phase_space: 1e-5 relative to max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (jax_grad_rels, inject_points, jax_bc_ic_points,
                                  jax_velocity_points, pde_pair, points, rel_to_max,
                                  small_recipe_trainer, torch_params)

from pinnrl_tpu.benchmarks import convergence as jax_conv
from pinnrl_tpu.ops import jet_mlp as jax_jet
from pinnrl_tpu_torch.benchmarks import convergence
from pinnrl_tpu_torch.ops import jet_mlp

DOMAIN = dict(domain=((0.0, 3.14159),), time_domain=(0.0, 10.0))
N = 96
RECIPE_PDES = {key: jax_conv.RECIPES[key]["pde"] for key in ("pendulum", "pendulum_nonlinear")}
EXACT = {"small_angle": {"type": "small_angle", "initial_angle": 0.5},
         "sine": {"type": "sine", "amplitude": 0.7, "frequency": 1.3},
         "elliptic": {"type": "elliptic", "initial_angle": 0.5}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(key="pendulum", arch="fourier", scale=(0.0, 1.0), **kw):
    return pde_pair("pendulum", arch=arch, scale=scale, pde=RECIPE_PDES[key], **kw)


def _pdes(**over):
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.pdes import create_pde as jax_create_pde
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.pdes import create_pde

    cfgs = [jax_load_config(pde_type="pendulum"), load_config(pde_type="pendulum", device="cpu")]
    for cfg in cfgs:
        for k, v in over.items():
            if k == "parameters":
                cfg.pde.parameters.update(v)
            else:
                setattr(cfg.pde, k, v)
    return jax_create_pde(cfgs[0]), create_pde(cfgs[1])


@pytest.mark.parametrize("exact", list(EXACT))
def test_exact_solutions_and_velocity_targets_match_jax(exact):
    jpde, tpde = _pdes(exact_solution=dict(EXACT[exact]))
    x, t = points(3, 300, **DOMAIN)
    ref = np.asarray(jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
    got = tpde.exact_solution(_t(x), _t(t))
    assert got.shape == ref.shape == (300, 1)
    assert rel_to_max(got, ref) < 1e-6
    jt = jnp.asarray(t)
    vref = jax.jvp(lambda tt: jpde.exact_solution(jnp.asarray(x), tt), (jt,), (jnp.ones_like(jt),))[1]
    tt = _t(t)
    vgot = torch.func.jvp(lambda s: tpde.exact_solution(_t(x), s), (tt,), (torch.ones_like(tt),))[1]
    assert rel_to_max(vgot, np.asarray(vref)) < 1e-6


@pytest.mark.parametrize("block", ["shipped", "pendulum", "pendulum_nonlinear"])
def test_targets_match_jax(block):
    """The shipped block's Dirichlet entry is typed "periodic": a zero
    target in both packages, not a periodic BC; the recipes' are exact."""
    jpde, tpde = _pdes(**({} if block == "shipped" else RECIPE_PDES[block]))
    assert sorted(tpde.boundary_conditions) == sorted(jpde.boundary_conditions) == ["dirichlet",
                                                                                   "initial"]
    x, t = points(4, 300, **DOMAIN)
    for name in jpde.boundary_conditions:
        ref = np.asarray(jpde.boundary_conditions[name](jnp.asarray(x), jnp.asarray(t)))
        got = tpde.boundary_conditions[name](_t(x), _t(t))
        assert got.shape == ref.shape, name
        assert rel_to_max(got, ref) < 1e-6 if np.abs(ref).max() > 0 else not got.abs().max()
    if block == "shipped":
        assert not tpde.boundary_conditions["dirichlet"](_t(x), _t(t)).abs().max()


@pytest.mark.parametrize("scale", [(0.0, 1.0), 1.0])
@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_time_only_bundle_matches_jax(arch, scale):
    """Spatial order 0: the bundle has the time group alone; [u_t, u_tt]
    along the time axis, nothing along x."""
    pair = _pair(arch=arch, scale=scale)
    x, t = points(5, N, **DOMAIN)
    z = np.concatenate([x, t], axis=1)
    jf = jax_jet.make_bundle_fn(pair.jmodel, 1, spatial_order=0, temporal_order=2)
    tf = jet_mlp.make_bundle_fn(pair.tmodel, 1, spatial_order=0, temporal_order=2)
    v_j, s_j = jf(pair.jmodel.params, jnp.asarray(z))
    with torch.no_grad():
        v_t, s_t = tf(pair.tmodel.params, torch.from_numpy(z))
    assert sorted(s_t) == sorted(s_j) == [1]
    assert rel_to_max(v_t, v_j) < 1e-5
    view = jet_mlp.BundleView(v_t, s_t)
    u_t, u_tt = view.directional(1, 2)
    assert rel_to_max(u_t, s_j[1][0]) < 1e-5 and rel_to_max(u_tt, s_j[1][1]) < 1e-5
    with pytest.raises(KeyError, match="axis 0"):
        view.directional(0, 1)


@pytest.mark.parametrize("bundle", [True, False])
@pytest.mark.parametrize("key", list(RECIPE_PDES))
def test_residual_matches_jax(key, bundle):
    """Linearized (pendulum) and nonlinear (pendulum_nonlinear), through the
    time-only bundle and through the generic engine."""
    pair = _pair(key)
    pair.jpde.attach_fast_bundle(pair.jmodel)
    assert pair.tpde.attach_fast_bundle(pair.tmodel, enable=bundle) == bundle
    assert not pair.tpde.attach_fused_residual_kernel(pair.tmodel)  # temporal order 2
    x, t = points(6, N, **DOMAIN)
    ref = pair.jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                     jnp.asarray(t))
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert got.shape == (N, 1)
    assert rel_to_max(got, np.asarray(ref)) < 1e-5


@pytest.mark.parametrize("key", list(RECIPE_PDES))
def test_compute_loss_and_gradients_match_jax(monkeypatch, key):
    pair = _pair(key)
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)
    x, t = points(21, N, **DOMAIN)
    jkey = jax.random.PRNGKey(4)

    def jtotal(p):
        losses = pair.jpde.compute_loss(pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t),
                                        key=jkey)
        return losses["total"], losses

    (_, ref), g_j = jax.value_and_grad(jtotal, has_aux=True)(pair.jmodel.params)
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, jkey, N),
                  velocity=jax_velocity_points(pair.jpde, jkey, N))
    params = torch_params(pair.tmodel)
    got = pair.tpde.compute_loss(pair.tmodel.apply, params, _t(x), _t(t))
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < 1e-5, k
    grads = dict(zip(params, torch.autograd.grad(got["total"], list(params.values()))))
    for name, rel in jax_grad_rels(grads, g_j).items():
        assert rel < 1e-4, name


@pytest.mark.parametrize("key", list(RECIPE_PDES))
def test_energy_and_phase_space_match_jax(key):
    pair = _pair(key)
    x, t = points(8, N, **DOMAIN)
    args_j = (pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x), jnp.asarray(t))
    args_t = (pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    with torch.no_grad():
        energy = pair.tpde.compute_energy(*args_t)
        theta, theta_t = pair.tpde.compute_phase_space(*args_t)
    assert energy.shape == theta.shape == theta_t.shape == (N, 1)
    assert rel_to_max(energy, np.asarray(pair.jpde.compute_energy(*args_j))) < 1e-5
    ref_theta, ref_theta_t = pair.jpde.compute_phase_space(*args_j)
    assert rel_to_max(theta, np.asarray(ref_theta)) < 1e-5
    assert rel_to_max(theta_t, np.asarray(ref_theta_t)) < 1e-5


@pytest.mark.parametrize("key", list(RECIPE_PDES))
def test_recipe_config_matches_jax(key):
    assert convergence.RECIPES[key] == jax_conv.RECIPES[key]
    a = jax_conv.build_recipe_config(key, epochs=7).to_dict()
    b = convergence.build_recipe_config(key, epochs=7, device="cpu").to_dict()
    assert b.pop("device") == "cpu"
    a.pop("device")
    assert a == b


def test_nonlinear_recipe_builds_its_shipped_basis():
    """pendulum_nonlinear's feature_seed 0 at 2x128 is the shipped table's."""
    from pinnrl_tpu.models import PINNModel as JaxModel
    from pinnrl_tpu_torch.models import PINNModel

    jm = JaxModel(jax_conv.build_recipe_config("pendulum_nonlinear"), seed=3)
    tm = PINNModel(convergence.build_recipe_config("pendulum_nonlinear", device="cpu"), seed=3)
    B = tm.constants["FourierFeatures_0.B"]
    assert B.shape == (2, 128) and not B[0].abs().max()  # scale (0, 1): no x-frequencies
    assert np.array_equal(B.numpy(), np.asarray(jm.constants["constants"]["FourierFeatures_0"]["B"]))


@pytest.mark.parametrize("key", list(RECIPE_PDES))
def test_recipe_trains_past_the_lbfgs_switch(key):
    """6 epochs at CPU size (3 Adam epochs of 2 steps, then 3 L-BFGS
    iterations) on the time-only bundle: finite losses that fall."""
    trainer = small_recipe_trainer(key)
    assert trainer.fast_bundle_active and not trainer.fused_kernel_active
    hist = trainer.train(seed=0)["history"]["train_loss"]
    assert trainer.switch_epoch == 3 and len(hist) == 6
    assert all(np.isfinite(hist)) and hist[-1] < hist[0]
