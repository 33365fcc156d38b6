"""The wave equation and its recipe: the port against pinnrl_tpu in one and
two space dimensions, on the Fourier and feedforward trunks (the
stacked-jet bundle, temporal order 2) and on SIREN (the generic engine).

Tolerances:
- residual (order 2): 1e-5 relative to max on the bundle (tests/test_torch_jet.py's
  bound for orders <= 2); 1e-4 on SIREN, whose omega_0 = 30 multiplies the
  f32 rounding at every order (tests/test_torch_kdv_siren.py's bound);
- exact solution and IC/BC targets: 1e-6 relative to max (float32);
- compute_loss with JAX's BC, IC and velocity-IC draws: each component 1e-5
  relative and each parameter gradient 1e-4 relative to its max, the JAX
  suite's fused-kernel bounds (tests/test_pallas_parity_tpu.py:152-155).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (_pair, jax_grad_rels, inject_points, jax_bc_ic_points,
                                  jax_velocity_points, pde_pair, points, rel_to_max,
                                  small_recipe_trainer, torch_params)

from pinnrl_tpu.benchmarks import convergence as jax_conv
from pinnrl_tpu_torch.benchmarks import convergence
from pinnrl_tpu_torch.ops.kernels import fourier_feats, siren
from pinnrl_tpu_torch.training import PDETrainer

N = 96


def _domain(dim):
    return dict(domain=((0.0, 1.0),) * dim, time_domain=(0.0, 1.0))


def _t(a):
    return torch.from_numpy(np.array(a))


def siren_wave_pair(dim=1, hidden=(32, 32)):
    """The shipped wave configuration (a SIREN, omega_0 30) at ``hidden``
    widths in ``dim`` space dimensions, bridged; BC/IC counts 32 each."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config

    cfgs = [jax_load_config(pde_type="wave"), load_config(pde_type="wave", device="cpu")]
    for cfg in cfgs:
        assert cfg.model.architecture == "siren"
        cfg.model.hidden_dims = list(hidden)
        cfg.pde.dimension = dim
        cfg.pde.domain = [[0.0, 1.0]] * dim
        cfg.model.input_dim = dim + 1
        cfg.training.num_boundary_points = cfg.training.num_initial_points = 32
    return _pair(*cfgs, seed=0, jitter_ln=False)


def _pair_for(arch, dim):
    if arch == "siren":
        return siren_wave_pair(dim)
    return pde_pair("wave", arch=arch, dim=None if dim == 1 else dim, scale=0.35)


CASES = [("fourier", 1), ("fourier", 2), ("feedforward", 1), ("feedforward", 2), ("siren", 1),
         ("siren", 2)]


@pytest.mark.parametrize("arch,dim", CASES)
def test_residual_matches_jax(arch, dim):
    pair = _pair_for(arch, dim)
    bundle = arch != "siren"
    assert pair.jpde.attach_fast_bundle(pair.jmodel) == bundle
    assert pair.tpde.attach_fast_bundle(pair.tmodel) == bundle
    assert not pair.tpde.attach_fused_residual_kernel(pair.tmodel)  # temporal order 2
    x, t = points(5, N, **_domain(dim))
    ref = pair.jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                     jnp.asarray(t))
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert got.shape == (N, 1)
    assert rel_to_max(got, np.asarray(ref)) < (1e-5 if bundle else 1e-4)


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("ic", [None, {"type": "sine", "amplitude": 0.7, "frequency": 3.0},
                                {"type": "sine_2d", "frequency_x": 1.0, "frequency_y": 2.0}])
@pytest.mark.parametrize("exact", [True, False])
def test_exact_solution_and_targets_match_jax(dim, ic, exact):
    """The traveling wave and its traces (with an exact solution), the
    sine and sine_2d ICs and the fixed Dirichlet target (without one)."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.pdes import create_pde as jax_create_pde
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.pdes import create_pde

    cfgs = [jax_load_config(pde_type="wave"), load_config(pde_type="wave", device="cpu")]
    for cfg in cfgs:
        cfg.pde.dimension = dim
        cfg.pde.domain = [[0.0, 1.0]] * dim
        cfg.pde.parameters["c"] = 0.8
        if ic is not None:
            cfg.pde.initial_condition = dict(ic)
        if not exact:
            cfg.pde.exact_solution = None
    jpde, tpde = jax_create_pde(cfgs[0]), create_pde(cfgs[1])
    rng = np.random.default_rng(dim)
    x = rng.uniform(0.0, 1.0, (300, dim)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, (300, 1)).astype(np.float32)
    if exact:
        ref = np.asarray(jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
        assert rel_to_max(tpde.exact_solution(_t(x), _t(t)), ref) < 1e-6
    assert sorted(tpde.boundary_conditions) == sorted(jpde.boundary_conditions)
    for name in jpde.boundary_conditions:
        ref = np.asarray(jpde.boundary_conditions[name](jnp.asarray(x), jnp.asarray(t)))
        got = tpde.boundary_conditions[name](_t(x), _t(t))
        assert got.shape == ref.shape, name
        assert rel_to_max(got, ref) < 1e-6 if np.abs(ref).max() > 0 else not got.abs().max()


@pytest.mark.parametrize("arch,dim", CASES)
def test_compute_loss_and_gradients_match_jax(monkeypatch, arch, dim):
    """With JAX's BC, IC and velocity-IC draws injected: every component,
    the velocity IC inside ``initial``, and every parameter gradient."""
    pair = _pair_for(arch, dim)
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)
    pair.tpde.attach_fused_residual_kernel(pair.tmodel)
    x, t = points(21, N, **_domain(dim))
    key = jax.random.PRNGKey(4)

    def jtotal(p):
        losses = pair.jpde.compute_loss(pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t), key=key)
        return losses["total"], losses

    (_, ref), g_j = jax.value_and_grad(jtotal, has_aux=True)(pair.jmodel.params)
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, N),
                  velocity=jax_velocity_points(pair.jpde, key, N))
    params = torch_params(pair.tmodel)
    got = pair.tpde.compute_loss(pair.tmodel.apply, params, _t(x), _t(t))
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < 1e-5, k
    grads = dict(zip(params, torch.autograd.grad(got["total"], list(params.values()))))
    for name, rel in jax_grad_rels(grads, g_j).items():
        assert rel < 1e-4, name


def test_velocity_ic_is_drawn_after_the_base_draws():
    """The velocity IC takes a fresh IC draw from the generator after the
    base loss's draws, so the base terms are those of the same generator
    without it; it raises ``initial`` and ``total`` by its weighted term."""
    pair = _pair_for("fourier", 1)
    x, t = (_t(a) for a in points(3, N, **_domain(1)))
    params = pair.tmodel.params
    with torch.no_grad():
        got = pair.tpde.compute_loss(pair.tmodel.apply, params, x, t,
                                     generator=torch.Generator().manual_seed(9))
        pair.tpde.settings.exact_solution = None
        base = pair.tpde.compute_loss(pair.tmodel.apply, params, x, t,
                                      generator=torch.Generator().manual_seed(9))
    assert float(got["boundary"]) == float(base["boundary"])
    vel = float(got["initial"]) - float(base["initial"])
    assert vel > 0.0
    w_ic = pair.tcfg.training.loss_weights.get("initial", 10.0)
    assert float(got["total"] - base["total"]) == pytest.approx(w_ic * vel, rel=1e-5)


def test_fourier_features_calls_per_loss(monkeypatch):
    """The count chip_smoke.py asserts on the card, derived here from the
    code: a loss embeds the BC points, the IC points and the velocity IC's
    points (the residual's streams are the bundle's closed form)."""
    trainer = small_recipe_trainer("wave")
    calls = []
    plain = fourier_feats.fourier_features

    def counting(x, B, two_pi=True):
        calls.append(x.shape[0])
        return plain(x, B, two_pi)

    monkeypatch.setattr(fourier_feats, "fourier_features", counting)
    x, t = trainer._sample(torch.Generator().manual_seed(0), 128, trainer.model.params)
    trainer._loss_components(trainer.model.params, x, t, torch.Generator().manual_seed(1))
    assert calls == [32, 32, 32]


def test_siren_layer_calls_per_loss(monkeypatch):
    """Wave on its shipped SIREN: u_tt (one nest of two jvps), u_xx (one),
    the BC, the IC and the velocity IC (one jvp): 5 evaluations of each
    layer."""
    pair = siren_wave_pair(hidden=(16,) * 3)
    calls = []
    plain = siren.siren_layer

    def counting(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(siren, "siren_layer", counting)
    trainer = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    assert not trainer.fast_bundle_active and not trainer.fused_kernel_active
    x, t = (_t(a) for a in points(2, 64, **_domain(1)))
    trainer._loss_components(pair.tmodel.params, x, t, torch.Generator().manual_seed(1))
    assert len(calls) == 5 * 3


def test_recipe_config_matches_jax():
    assert convergence.RECIPES["wave"] == jax_conv.RECIPES["wave"]
    a = jax_conv.build_recipe_config("wave", epochs=7).to_dict()
    b = convergence.build_recipe_config("wave", epochs=7, device="cpu").to_dict()
    assert b.pop("device") == "cpu"
    a.pop("device")
    assert a == b


def test_recipe_trains_past_the_lbfgs_switch():
    """6 epochs at CPU size (3 Adam epochs of 2 steps, then 3 L-BFGS
    iterations) on the plain bundle: finite losses that fall."""
    trainer = small_recipe_trainer("wave")
    assert trainer.fast_bundle_active and not trainer.fused_kernel_active
    hist = trainer.train(seed=0)["history"]["train_loss"]
    assert trainer.switch_epoch == 3 and len(hist) == 6
    assert all(np.isfinite(hist)) and hist[-1] < hist[0]
