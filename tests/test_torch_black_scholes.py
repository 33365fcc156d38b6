"""The Black-Scholes equation, its shipped configuration (a feedforward
128x7 trunk with LayerNorm) and its convergence recipe: the port against
pinnrl_tpu, and kernel 1's Black-Scholes variant (the one residual that
reads z, for S) through its host launcher with the plain twins, on a
Fourier and on a feedforward trunk.

Tolerances:
- residual (order 2): 1e-5 relative to max (tests/test_torch_jet.py); S
  runs to 200, so the S^2 V_SS term is up to 800 V_SS, and the terms
  cancel: the bound holds relative to the residual's max;
- exact solutions and IC/BC targets: 1e-6 relative to max (float32; erf
  and the normal CDF of two libraries);
- the strike-focus draw from JAX's own unit draws: 1e-6 relative to max;
- kernel 1 against the JAX Pallas kernel in interpret mode and the launcher
  against autograd: loss 1e-5 relative, gradients 1e-4 relative to max;
  causal 1e-4 and 1e-3 (the JAX suite's bounds; none needed loosening);
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
from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.ops.kernels import fused_step
from pinnrl_tpu_torch.pdes import create_pde

DOMAIN = DOMAINS["black_scholes"]
RECIPE_PDE = jax_conv.RECIPES["black_scholes"]["pde"]
CONVENTIONS = {"calendar": 1.0, "to_maturity": -1.0}


def _t(a):
    return torch.from_numpy(np.array(a))


def _convention(name):
    return {"parameters": {"time_convention": name}}


@pytest.mark.parametrize("arch,bundle", [("fourier", True), ("fourier", False),
                                         ("feedforward", True), ("feedforward", False)])
@pytest.mark.parametrize("convention", list(CONVENTIONS))
def test_residual_matches_jax(convention, arch, bundle):
    """Both time conventions, through the stacked-jet bundle and through the
    generic engine."""
    pair = pde_pair("black_scholes", arch=arch, pde=_convention(convention))
    assert pair.tpde.time_sign() == CONVENTIONS[convention]
    pair.jpde.attach_fast_bundle(pair.jmodel)
    assert pair.tpde.attach_fast_bundle(pair.tmodel, enable=bundle) == bundle
    x, t = points(5, 96, **DOMAIN)
    ref = pair.jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                     jnp.asarray(t))
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert got.shape == (96, 1)
    assert rel_to_max(got, np.asarray(ref)) < 1e-5


@pytest.mark.parametrize("cdf", [False, True])
def test_closed_forms_and_targets_match_jax(cdf):
    """The erf form (reference parity) and the normal CDF, from the config's
    ``cdf`` flag and from ``use_cdf``; the payoff IC and the exact BC."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.pdes import create_pde as jax_create_pde

    cfgs = [jax_load_config(pde_type="black_scholes"),
            load_config(pde_type="black_scholes", device="cpu")]
    for cfg in cfgs:
        cfg.pde.exact_solution = {**cfg.pde.exact_solution, "cdf": cdf}
        cfg.pde.boundary_conditions = {"dirichlet": {"type": "exact"}}
    jpde, tpde = jax_create_pde(cfgs[0]), create_pde(cfgs[1])
    x, t = points(2, 300, **DOMAIN)
    x[:5] = 0.0  # S = 0 and t = 0 take the guards
    t[5:10] = 0.0
    ref = np.asarray(jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
    assert rel_to_max(tpde.exact_solution(_t(x), _t(t)), ref) < 1e-6
    ref = np.asarray(jpde.exact_solution(jnp.asarray(x), jnp.asarray(t), use_cdf=True))
    assert rel_to_max(tpde.exact_solution(_t(x), _t(t), use_cdf=True), ref) < 1e-6
    for name in jpde.boundary_conditions:
        ref = np.asarray(jpde.boundary_conditions[name](jnp.asarray(x), jnp.asarray(t)))
        got = tpde.boundary_conditions[name](_t(x), _t(t))
        assert got.shape == ref.shape and rel_to_max(got, ref) < 1e-6, name
    cfgs[1].pde.exact_solution = None
    cfgs[1].pde.boundary_conditions = {"dirichlet": {"type": "custom"}}
    assert create_pde(cfgs[1]).exact_solution(_t(x), _t(t)) is None


@pytest.mark.parametrize("n,focus", [(4096, 0.5), (101, 0.3), (64, 1.0)])
def test_strike_focus_draw_matches_jax(n, focus):
    """``ic_strike_focus``: JAX's unit draws through the port's helper give
    JAX's points; the port's own draw has the count, the clipping and the
    share near the strike asked for."""
    over = {"parameters": {"ic_strike_focus": focus, "ic_strike_width": 5.0}}
    pair = pde_pair("black_scholes", pde=over)
    key = jax.random.PRNGKey(n)
    ref_x, ref_t = (np.asarray(a) for a in pair.jpde._sample_initial_points(key, n))
    n_focus = int(round(focus * n))
    k_u, k_g = jax.random.split(key)
    u = jax.random.uniform(k_u, (n - n_focus, 1))
    g = jax.random.normal(k_g, (n_focus, 1))
    got_x, got_t = pair.tpde._strike_focused_points(_t(u), _t(g))
    assert got_x.shape == ref_x.shape == (n, 1) and torch.equal(got_t, _t(ref_t))
    assert rel_to_max(got_x, ref_x) < 1e-6

    x, t = pair.tpde._sample_initial_points(torch.Generator().manual_seed(0), n)
    assert x.shape == (n, 1) and t.shape == (n, 1) and float(t.abs().max()) == 0.0
    assert float(x.min()) >= 0.0 and float(x.max()) <= 200.0  # clipped to the domain
    # Four widths of the strike hold all but ~6e-5 of the focused points; a
    # uniform draw puts 40 / 200 of its points there.
    near = (x - 100.0).abs() <= 4 * 5.0
    assert float(near[n - n_focus:].float().mean()) > 0.99
    assert float(near.float().mean()) >= 0.99 * focus
    x0, _ = pde_pair("black_scholes").tpde._sample_initial_points(torch.Generator().manual_seed(0), n)
    assert x0.shape == (n, 1) and float(((x0 - 100.0).abs() <= 20.0).float().mean()) < 0.5


def test_canonicalize_coeffs():
    tpde = create_pde(load_config(pde_type="black_scholes", device="cpu"))
    out = tpde.canonicalize_coeffs({"sigma": torch.tensor(-0.1996), "r": 0.05})
    assert out["sigma"] == pytest.approx(0.1996) and out["r"] == 0.05


@pytest.mark.parametrize("eps", [0.0, 1.0])
@pytest.mark.parametrize("convention", list(CONVENTIONS))
@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_kernel1_launcher_matches_jax_interpret_kernel(arch, convention, eps):
    pair = pde_pair("black_scholes", arch=arch, causal_eps=eps, pde=_convention(convention))
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert (spec.x_order, spec.residual, spec.sigma, spec.rate, spec.sign) == (
        2, "black_scholes", 0.2, 0.05, CONVENTIONS[convention])
    loss_rel, grad_rels = launcher_vs_jax_kernel(pair, sorted_z(7, 256, DOMAIN))
    loss_tol, grad_tol = FUSED_TOLS[eps]
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("arch", ["fourier", "feedforward"])
def test_kernel1_launcher_matches_autograd(arch, causal, layer_norm):
    pair = pde_pair("black_scholes", arch=arch, causal_eps=1.0 if causal else 0.0,
                    hidden=(32, 24, 16), layer_norm=layer_norm, pde=_convention("to_maturity"))
    loss_rel, grad_rels = plain_vs_launcher(pair, sorted_z(3, 300, DOMAIN))
    loss_tol, grad_tol = FUSED_TOLS[1.0 if causal else 0.0]
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch,over", [("fourier", RECIPE_PDE), ("feedforward", None)])
def test_compute_loss_matches_jax(monkeypatch, arch, over, fused):
    """The recipe's block (to maturity, CDF, exact BC) on a Fourier trunk and
    the shipped block (calendar time, erf, the 'custom' BC's zero target) on
    a feedforward trunk, with JAX's BC and IC draws."""
    pair = pde_pair("black_scholes", arch=arch, pde=over)
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


def test_shipped_config_builds_its_feedforward_trunk_on_kernel1():
    """``load_config(pde_type="black_scholes")``: a feedforward 128x7 with
    LayerNorm, which kernel 1 takes (its affine input, x-order 2)."""
    cfg = load_config(pde_type="black_scholes", device="cpu")
    model, pde = PINNModel(cfg, seed=0), create_pde(cfg)
    assert cfg.model.architecture == "feedforward" and cfg.model.layer_norm
    assert list(cfg.model.hidden_dims) == [128] * 7
    assert fused_step.supports(model, pde, cfg.training)
    assert pde.attach_fused_residual_kernel(model)
    spec = fused_step._spec(model, pde)
    assert spec.B is None and spec.x_order == 2 and spec.sign == 1.0


def test_recipe_trains_on_kernel1_and_its_loss_falls():
    trainer = small_recipe_trainer("black_scholes")
    assert trainer.fused_kernel_active and trainer.fast_bundle_active
    hist = trainer.train(seed=0)["history"]["train_loss"]
    assert len(hist) == 6 and all(np.isfinite(hist))
    assert hist[-1] < hist[0]
