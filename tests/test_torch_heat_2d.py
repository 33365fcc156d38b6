"""The heat equation in two (and three) space dimensions, the heat_2d recipe,
and kernel 1 beyond one dimension and in a co-moving frame: the port
against pinnrl_tpu.

Tolerances:
- kernel 1 (the launcher with its plain twins) against the JAX Pallas
  kernel in interpret mode (tile 32), and against autograd on the plain
  version: loss 1e-5 relative, gradients 1e-4 relative to max; causal 1e-4
  and 1e-3 (the JAX suite's fused-kernel bounds);
- residual (order 2): 1e-5 relative to max (tests/test_torch_jet.py);
- exact solution and IC/BC targets: 1e-6 relative to max (float32; the
  products of sines are formed in another order);
- validation metrics: 1e-5 relative; flags equal;
- compute_loss: 1e-5 relative per component.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (FUSED_TOLS, inject_points, jax_bc_ic_points,
                                  launcher_vs_jax_kernel, pde_pair, plain_vs_launcher, points,
                                  rel_to_max, small_recipe_trainer, sorted_z)

from pinnrl_tpu.benchmarks import convergence as jax_conv
from pinnrl_tpu.ops.kernels import fused_step as jax_fused
from pinnrl_tpu.sampling import sample_uniform as jax_sample_uniform
from pinnrl_tpu_torch.benchmarks import convergence
from pinnrl_tpu_torch.ops.kernels import fused_step

DOMAIN = dict(domain=((0.0, 3.14159), (0.0, 3.14159)), time_domain=(0.0, 5.0))


def _t(a):
    return torch.from_numpy(np.array(a))


def _domain(pair):
    return dict(domain=tuple(tuple(d) for d in pair.tcfg.pde.domain),
                time_domain=tuple(pair.tcfg.pde.time_domain))


# ---------------------------------------------------------------- kernel 1

KERNEL_CASES = {
    "heat_2d": dict(pde_type="heat_2d"),
    "heat_2d_feedforward": dict(pde_type="heat_2d", arch="feedforward"),
    "heat_2d_frame": dict(pde_type="heat_2d", frame=0.7),
    "heat_2d_frame_feedforward": dict(pde_type="heat_2d", arch="feedforward", frame=0.7),
    "heat_2d_causal": dict(pde_type="heat_2d", causal_eps=1.0),
    "heat_3d": dict(pde_type="heat", dim=3),
    "burgers_frame": dict(pde_type="burgers", frame=0.7),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel1_launcher_matches_jax_interpret_kernel(case):
    """The launcher with the plain twins (d x-groups, the frame's shifted
    input and t-direction) against the JAX kernel, which takes both."""
    kw = dict(KERNEL_CASES[case])
    pair = pde_pair(kw.pop("pde_type"), **kw)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert spec.dimension == pair.tpde.dimension and spec.frame_speed == kw.get("frame")
    loss_rel, grad_rels = launcher_vs_jax_kernel(pair, sorted_z(7, 128, _domain(pair)))
    loss_tol, grad_tol = FUSED_TOLS[kw.get("causal_eps", 0.0)]
    assert loss_rel < loss_tol
    for name, rel in grad_rels.items():
        assert rel < grad_tol, name


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("frame", [None, -0.4])
def test_kernel1_launcher_matches_autograd(frame, layer_norm):
    """heat_2d through the launcher against autograd on the plain bundle ->
    residual -> loss path, three hidden layers."""
    pair = pde_pair("heat_2d", hidden=(32, 24, 16), layer_norm=layer_norm, frame=frame)
    loss_rel, grad_rels = plain_vs_launcher(pair, sorted_z(3, 160, DOMAIN))
    assert loss_rel < 1e-5
    for name, rel in grad_rels.items():
        assert rel < 1e-4, name


def test_supports_matches_the_reference_beyond_one_dimension():
    """In two, three and more dimensions and with a frame the port admits
    what the reference admits (at the reference's widths): the reference's
    gate has no limit on d, and neither has the port's."""
    from pinnrl_tpu.models import PINNModel as JaxModel

    for kw in (dict(pde_type="heat_2d"), dict(pde_type="heat", dim=3),
               dict(pde_type="heat_2d", frame=0.5), dict(pde_type="burgers", frame=0.5),
               dict(pde_type="heat_2d", arch="feedforward", frame=0.5)):
        pair = pde_pair(kw.pop("pde_type"), hidden=(128, 128), mapping=64, **kw)
        wide = JaxModel(pair.jcfg, seed=0)
        assert jax_fused.supports(wide, pair.jpde, pair.jcfg.training)
        assert fused_step.supports(pair.tmodel, pair.tpde, pair.tcfg.training)
    for dim in (4, 5, 8):
        wide = pde_pair("heat", hidden=(128, 128), mapping=64, dim=dim)
        assert jax_fused.supports(JaxModel(wide.jcfg, seed=0), wide.jpde, wide.jcfg.training)
        assert fused_step.supports(wide.tmodel, wide.tpde, wide.tcfg.training)
        assert wide.tpde.attach_fused_residual_kernel(wide.tmodel)


# ---------------------------------------------------------------- the PDE


def test_heat_2d_builds_as_the_heat_equation_in_two_dimensions():
    pair = pde_pair("heat_2d")
    assert pair.tpde.pde_type == "heat" and pair.tpde.dimension == 2
    assert pair.tmodel.config.input_dim == 3


@pytest.mark.parametrize("bundle", [True, False])
def test_residual_matches_jax(bundle):
    """Through the stacked-jet bundle and through the generic engine."""
    pair = pde_pair("heat_2d")
    pair.jpde.attach_fast_bundle(pair.jmodel)
    assert pair.tpde.attach_fast_bundle(pair.tmodel, enable=bundle) == bundle
    x, t = points(5, 96, **DOMAIN)
    ref = pair.jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                     jnp.asarray(t))
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert got.shape == (96, 1)
    assert rel_to_max(got, np.asarray(ref)) < 1e-5


SOLUTIONS = {
    "sine_2d": dict(initial_condition={"type": "sine_2d", "amplitude": 1.3, "frequency_x": 2.0,
                                       "frequency_y": 1.0},
                    exact_solution={"type": "sine_2d", "amplitude": 1.3, "frequency_x": 2.0,
                                    "frequency_y": 1.0},
                    domain=[[0.5, 3.0], [-1.0, 2.0]]),
    "sin_exp_decay": dict(initial_condition={"type": "sin_exp_decay", "amplitude": 0.8,
                                             "frequency": 1.5},
                          exact_solution={"type": "sin_exp_decay", "amplitude": 0.8,
                                          "frequency": 1.5},
                          boundary_conditions={"dirichlet": {}}),
    "sine": dict(initial_condition={"type": "sine", "amplitude": 1.0, "frequency": 1.0}),
}


@pytest.mark.parametrize("kind,dim", [("sine_2d", 2), ("sin_exp_decay", 2), ("sine", 2),
                                      ("sin_exp_decay", 3), ("sine", 3)])
def test_exact_solution_and_targets_match_jax(kind, dim):
    """The exact solution and the IC and BC targets on the same points:
    sine_2d (per-axis wave numbers, shifted to the lower corner; posed in
    two dimensions), sin_exp_decay's products of sines, and an IC type heat
    only defines in one dimension (the base class's then)."""
    pair = pde_pair("heat_2d", pde=SOLUTIONS[kind], dim=3 if dim == 3 else None)
    lo = [d[0] for d in pair.tcfg.pde.domain]
    x, t = points(11, 200, domain=tuple((a, a + 2.5) for a in lo), time_domain=(0.0, 5.0))
    pairs = [(pair.tpde.exact_solution(_t(x), _t(t)), pair.jpde.exact_solution(x, t))]
    for name, fn in pair.tpde.boundary_conditions.items():
        pairs.append((fn(_t(x), _t(t)), pair.jpde.boundary_conditions[name](x, t)))
    for got, ref in pairs:
        assert got.shape == np.shape(ref)
        assert rel_to_max(got, np.asarray(ref)) < 1e-6


def test_initial_points_are_the_base_uniform_draw():
    """In N-D the IC points are the base class's uniform draw at
    time_domain[0] (no edge-concentrated layout)."""
    pair = pde_pair("heat_2d")
    gen = torch.Generator().manual_seed(3)
    x, t = pair.tpde._sample_initial_points(gen, 64)
    gen = torch.Generator().manual_seed(3)
    lo, hi = pair.tpde._space_bounds(torch.device("cpu"))
    want = pair.tpde._uniform(gen, 64, lo, hi)
    assert x.shape == (64, 2) and torch.equal(x, want)
    assert torch.equal(t, torch.zeros((64, 1)))


@pytest.mark.parametrize("fused", [True, False])
def test_compute_loss_matches_jax(monkeypatch, fused):
    """The shipped heat_2d block (Dirichlet u = 0 on the box, sine_2d IC),
    with JAX's BC and IC draws."""
    pair = pde_pair("heat_2d")
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


def test_validate_matches_jax():
    """The metrics on JAX's uniform draw; no periodic check in N-D."""
    pair = pde_pair("heat_2d", pde={"boundary_conditions": {"periodic": {}}})
    key = jax.random.PRNGKey(3)
    ref = pair.jpde.validate(pair.jmodel.apply, pair.jmodel.params, key=key, num_points=500)
    x, t = jax_sample_uniform(key, 500, pair.jpde.domain, pair.jpde.time_domain)
    with torch.no_grad():
        got = pair.tpde._validate_on(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert sorted(got) == sorted(ref) and "periodic_bc_error" not in got
    for k, v in ref.items():
        if isinstance(v, bool):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= 1e-5 * abs(v), k


# ---------------------------------------------------------------- recipe


def test_recipe_and_config_equal_jax():
    assert convergence.RECIPES["heat_2d"] == jax_conv.RECIPES["heat_2d"]
    a = jax_conv.build_recipe_config("heat_2d", epochs=7).to_dict()
    b = convergence.build_recipe_config("heat_2d", epochs=7, device="cpu").to_dict()
    assert b.pop("device") == "cpu"
    a.pop("device")
    assert a == b
    assert (b["pde"]["dimension"], b["model"]["input_dim"]) == (2, 3)


def test_recipe_trains_on_kernel1_and_its_loss_falls():
    """6 epochs (3 Adam epochs of 2 steps, then 3 L-BFGS iterations) of the
    recipe at CPU size: kernel 1 in two dimensions on every loss."""
    trainer = small_recipe_trainer("heat_2d")
    assert trainer.fused_kernel_active and trainer.fast_bundle_active
    spec = fused_step._spec(trainer.model, trainer.pde)
    assert (spec.dimension, spec.x_order, spec.residual) == (2, 2, "heat")
    hist = trainer.train(seed=0)["history"]["train_loss"]
    assert len(hist) == 6 and all(np.isfinite(hist))
    assert hist[-1] < hist[0]
