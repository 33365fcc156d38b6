"""The heat equation (one space dimension) and the heat recipe: the port
against pinnrl_tpu, with JAX's own draws fed to the port's deterministic
sampling helpers, the periodic boundary loss through the generic engine,
and kernel 1's heat residual rehearsed through its plain twins.

Tolerances:
- residual (order 2): 1e-5 relative to max (tests/test_torch_jet.py's
  order-2 bound);
- exact solution, IC/BC targets, sampled points: 1e-6 relative to max
  (float32; the interval widths are formed in float64 here and in float32
  by JAX);
- validation metrics: 1e-5 relative; flags equal;
- the periodic loss: value 1e-5 relative, gradients 1e-4 relative to max
  (one jvp of a LayerNorm network; sums in another order);
- compute_loss: 1e-5 relative per component;
- one Adam step: parameters 5e-4 absolute (tests/test_torch_trainer.py);
- kernel 1, heat: the plain version against the JAX interpret kernel and
  the launcher with its twins against autograd: loss 1e-5 relative,
  gradients 1e-4 relative to max (the JAX suite's fused-kernel bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity_helpers import (HEAT_DOMAIN, _pair, heat_pair, inject_periodic_draws,
                                  jax_periodic_draws, points, rel_to_max, torch_params)

from pinnrl_tpu.benchmarks import convergence as jax_conv
from pinnrl_tpu.ops.kernels import fused_step as jax_fused
from pinnrl_tpu.sampling import sample_uniform as jax_sample_uniform
from pinnrl_tpu.training import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.benchmarks import convergence
from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.ops.jet_mlp import make_bundle_fn
from pinnrl_tpu_torch.ops.kernels import fused_step
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.training import PDETrainer


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bundle", [True, False])
def test_residual_matches_jax(bundle):
    """Through the stacked-jet bundle and through the generic engine."""
    pair = heat_pair()
    pair.jpde.attach_fast_bundle(pair.jmodel)
    assert pair.tpde.attach_fast_bundle(pair.tmodel, enable=bundle) == bundle
    x, t = points(5, 96, **HEAT_DOMAIN)
    ref = pair.jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                     jnp.asarray(t))
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert got.shape == (96, 1)
    assert rel_to_max(got, np.asarray(ref)) < 1e-5


def test_exact_solution_and_targets_match_jax():
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.pdes import create_pde as jax_create_pde

    pairs = []
    for bcs in ({"periodic": {}}, {"dirichlet": {"type": "fixed", "value": 0.0}}):
        cfgs = [jax_load_config(pde_type="heat"), load_config(pde_type="heat", device="cpu")]
        for cfg in cfgs:
            cfg.pde.boundary_conditions = bcs
        pairs.append((jax_create_pde(cfgs[0]), create_pde(cfgs[1])))
    x, t = points(2, 300, **HEAT_DOMAIN)
    for jpde, tpde in pairs:
        assert tpde._decay_rate(2.0) == pytest.approx(float(jpde._decay_rate(2.0)), rel=1e-12)
        ref = np.asarray(jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
        assert rel_to_max(tpde.exact_solution(_t(x), _t(t)), ref) < 1e-6
        for name in jpde.boundary_conditions:
            ref = np.asarray(jpde.boundary_conditions[name](jnp.asarray(x), jnp.asarray(t)))
            got = tpde.boundary_conditions[name](_t(x), _t(t))
            assert got.shape == ref.shape
            assert rel_to_max(got, ref) < 1e-6 if np.abs(ref).max() > 0 else not got.abs().max()
    for ic in ({"type": "sine", "amplitude": 0.5, "frequency": 3.0}, {"type": "gaussian"}):
        cfgs = [jax_load_config(pde_type="heat"), load_config(pde_type="heat", device="cpu")]
        for cfg in cfgs:
            cfg.pde.initial_condition = ic
        ref = np.asarray(jax_create_pde(cfgs[0]).boundary_conditions["initial"](jnp.asarray(x),
                                                                                  jnp.asarray(t)))
        got = create_pde(cfgs[1]).boundary_conditions["initial"](_t(x), _t(t))
        assert rel_to_max(got, ref) < 1e-6


@pytest.mark.parametrize("n", [64, 4096, 7, 1])
def test_sampling_hooks_match_jax_draws(n):
    """The stratified boundary times and the edge-concentrated IC points,
    from JAX's own unit draws (the keys its hooks split)."""
    pair = heat_pair()
    jpde, tpde = pair.jpde, pair.tpde
    key = jax.random.PRNGKey(n)
    ref_t = np.asarray(jpde._sample_boundary_time(key, n))
    n_early, n_late = tpde._time_split(n)
    k_e, k_l = jax.random.split(key)
    got_t = tpde._stratified_times(_t(jax.random.uniform(k_e, (n_early, 1))),
                                   _t(jax.random.uniform(k_l, (n_late, 1))), n)
    assert got_t.shape == ref_t.shape == (n, 1)
    assert rel_to_max(got_t, ref_t) < 1e-6
    assert float(got_t[: max(n // 4, 1)].max()) <= 0.1  # the first 1% of [0, 10]

    ref_x, ref_ti = (np.asarray(a) for a in jpde._sample_initial_points(key, n))
    n_q, n_h = tpde._initial_split(n)
    k1, k2, k3 = jax.random.split(key, 3)
    got_x, got_ti = tpde._edge_initial_points(_t(jax.random.uniform(k1, (n_q, 1))),
                                              _t(jax.random.uniform(k2, (n_h, 1))),
                                              _t(jax.random.uniform(k3, (n_q, 1))), n)
    assert got_x.shape == ref_x.shape and got_ti.shape == ref_ti.shape
    assert rel_to_max(got_x, ref_x) < 1e-6 and torch.equal(got_ti, _t(ref_ti))
    gen = torch.Generator().manual_seed(0)
    assert tpde._sample_boundary_time(gen, n).shape == (n, 1)
    assert tpde._sample_initial_points(gen, n)[0].shape == ref_x.shape


def test_validate_matches_jax():
    pair = heat_pair()
    key = jax.random.PRNGKey(3)
    ref = pair.jpde.validate(pair.jmodel.apply, pair.jmodel.params, key=key, num_points=500)
    x, t = jax_sample_uniform(key, 500, pair.jpde.domain, pair.jpde.time_domain)
    with torch.no_grad():
        got = pair.tpde._validate_on(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, bool):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= 1e-5 * abs(v), k
    metrics = pair.tpde.validate(pair.tmodel.apply, pair.tmodel.params, num_points=200)
    assert np.isfinite(metrics["periodic_bc_error"]) and metrics["has_nan"] is False


def test_periodic_loss_matches_jax():
    pair = heat_pair()
    key = jax.random.PRNGKey(9)

    def jloss(p):
        return pair.jpde._periodic_loss(pair.jpde._scalar_u(pair.jmodel.apply, p), key, 64)

    l_j, g_j = jax.value_and_grad(jloss)(pair.jmodel.params)
    params = torch_params(pair.tmodel)
    u = pair.tpde._scalar_u(pair.tmodel.apply, params)
    l_t = pair.tpde._periodic_terms(u, jax_periodic_draws(pair.jpde, key, 64))
    assert abs(float(l_t.detach()) - float(l_j)) / abs(float(l_j)) < 1e-5
    for name, g in zip(params, torch.autograd.grad(l_t, list(params.values()))):
        module, leaf = name.split(".")
        jleaf = {"weight": "kernel" if module.startswith("Dense") else "scale", "bias": "bias"}[leaf]
        got = g.numpy().T if g.ndim == 2 else g.numpy()
        assert rel_to_max(got, np.asarray(g_j[module][jleaf])) < 1e-4, name
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(pair.tpde._periodic_loss(u, gen, 64))


@pytest.mark.parametrize("fused", [True, False])
def test_compute_loss_matches_jax(monkeypatch, fused):
    pair = heat_pair()
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)
    assert pair.tpde.attach_fused_residual_kernel(pair.tmodel, enable="on" if fused else "off") == fused
    x, t = points(21, 128, **HEAT_DOMAIN)
    key = jax.random.PRNGKey(4)
    ref = pair.jpde.compute_loss(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                 jnp.asarray(t), key=key)
    inject_periodic_draws(monkeypatch, pair, key, 128)
    got = pair.tpde.compute_loss(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < 1e-5, k


# ------------------------------------------------------------------ recipe


def _recipe_pair():
    """The heat recipe in both packages, cut to CPU size, with Adam."""
    cfgs = [jax_conv.build_recipe_config("heat", epochs=1),
            convergence.build_recipe_config("heat", epochs=1, device="cpu")]
    for cfg in cfgs:
        cfg.model.hidden_dims = [16, 16]
        cfg.model.arch_params["mapping_size"] = 8
        t = cfg.training
        t.optimizer = "adam"
        t.num_collocation_points, t.batch_size = 256, 128
        t.num_boundary_points = t.num_initial_points = 32
    return _pair(*cfgs, seed=0, jitter_ln=True)


def test_recipe_trainer_takes_the_heat_kernel():
    cfg = convergence.build_recipe_config("heat", epochs=8, device="cpu")
    assert cfg.model.arch_params["scale"] == 0.75 and cfg.training.optimizer == "adam_lbfgs"
    cfg.training.optimizer = "adam"
    pde = create_pde(cfg)
    trainer = PDETrainer(PINNModel(cfg, seed=0), pde, cfg)
    assert trainer.fused_kernel_active and trainer.fast_bundle_active
    spec = fused_step._spec(trainer.model, pde)
    assert (spec.x_order, spec.residual, spec.alpha, spec.nu) == (2, "heat", 0.01, 0.0)


def test_one_adam_step_of_the_recipe_matches_optax(monkeypatch):
    pair = _recipe_pair()
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    assert ttr.fused_kernel_active and ttr.fast_bundle_active
    jopt = jtr._make_adam(1, 2)
    jparams = {"net": pair.jmodel.params, "coeffs": {}}
    params = pair.tmodel.params
    topt = ttr._make_adam(1, 2, list(params.values()))
    x, t = points(100, 128, **HEAT_DOMAIN)
    key = jax.random.PRNGKey(0)

    def jtotal(p):
        return jtr._loss_components(p, jnp.asarray(x), jnp.asarray(t), key)["total"]

    l_j, g_j = jax.value_and_grad(jtotal)(jparams)
    updates, _ = jopt.update(g_j, jopt.init(jparams), jparams)
    jparams = optax.apply_updates(jparams, updates)

    inject_periodic_draws(monkeypatch, pair, key, 128)
    losses = ttr._loss_components(params, _t(x), _t(t), None)
    losses["total"].backward()
    topt.step()
    assert abs(float(losses["total"].detach()) - float(l_j)) / abs(float(l_j)) < 1e-5
    for module, leaves in jparams["net"].items():
        for leaf, ref in leaves.items():
            name = f"{module}.{ {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}[leaf] }"
            got = params[name].detach().numpy()
            got = got.T if got.ndim == 2 else got
            assert np.max(np.abs(got - np.asarray(ref))) < 5e-4, name


def test_heat_train_returns_finite_history():
    pair = _recipe_pair()
    pair.tcfg.training.validation_frequency = 1
    trainer = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    res = trainer.train(num_epochs=2, seed=0)
    hist = res["history"]
    assert len(hist["train_loss"]) == 2 and len(hist["val_loss"]) == 2
    assert all(np.isfinite(v) for v in hist["train_loss"] + hist["val_loss"])


def test_heat_2d_raises():
    """heat_2d no longer raises: it builds the heat equation in two space
    dimensions (tests/test_torch_heat_2d.py holds it against JAX)."""
    pde = create_pde(load_config(pde_type="heat_2d", device="cpu"))
    assert (pde.pde_type, pde.dimension) == ("heat", 2)


# ---------------------------------------------------------------- kernel 1


def _sorted_z(seed, n):
    x, t = points(seed, n, **HEAT_DOMAIN)
    z = np.concatenate([x, t], axis=1)
    return z[np.argsort(z[:, 1], kind="stable")]


def _plain_loss_and_grads(pair, params, z):
    bundle_fn = make_bundle_fn(pair.tmodel, 1, 2, 1)
    loss = fused_step.fused_residual_loss_plain(bundle_fn, pair.tpde, params, _t(z))
    # The residual does not depend on the output bias (its gradient is 0).
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


@pytest.mark.parametrize("eps", [0.0, 1.0])
def test_kernel1_plain_version_matches_jax_interpret_kernel(eps):
    pair = heat_pair(causal_eps=eps)
    z = _sorted_z(7, 128)
    fused_j = jax_fused.make_fused_residual_loss(pair.jmodel, pair.jpde, tile=32, interpret=True,
                                                 causal_eps=eps)
    l_j, g_j = jax.value_and_grad(lambda p: fused_j(p, jnp.asarray(z)))(pair.jmodel.params)
    l_t, g_t = _plain_loss_and_grads(pair, torch_params(pair.tmodel), z)
    assert abs(float(l_t) - float(l_j)) / abs(float(l_j)) < 1e-5
    for name, g in g_t.items():
        module, leaf = name.split(".")
        jleaf = {"weight": "kernel" if module.startswith("Dense") else "scale", "bias": "bias"}[leaf]
        got = g.numpy().T if g.ndim == 2 else g.numpy()
        assert rel_to_max(got, np.asarray(g_j[module][jleaf])) < 1e-4, name


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel1_launcher_with_plain_twins_matches_autograd(causal, layer_norm):
    """Kernel 1's heat variant through its host launcher with the plain
    twins (``_TorchOps.heat`` for ``fr_heat``) against autograd on the plain
    bundle -> residual -> loss path."""
    pair = heat_pair(causal_eps=1.0 if causal else 0.0, hidden=(32, 24, 16), layer_norm=layer_norm)
    z = _sorted_z(3, 160)
    params = torch_params(pair.tmodel)
    l_ref, g_ref = _plain_loss_and_grads(pair, params, z)
    spec = fused_step._spec(pair.tmodel, pair.tpde)
    assert (spec.x_order, spec.residual, spec.alpha) == (2, "heat", 0.01)
    detached = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        loss, grads = fused_step._loss_and_grads(fused_step._TorchOps(), spec, _t(z), detached)
    assert sorted(grads) == sorted(g_ref)
    assert abs(float(loss) - float(l_ref)) / abs(float(l_ref)) < 1e-5
    for name in g_ref:
        assert rel_to_max(grads[name], g_ref[name]) < 1e-4, name
