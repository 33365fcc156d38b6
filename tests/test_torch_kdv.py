"""The KdV slice of the port against pinnrl_tpu: the shipped Fourier basis
of ``feature_seed``, the convergence harness's recipes, the KdV PDE, its
causal compute_loss, and an Adam step of the causal slice.

Tolerances:
- the basis and the recipe configs: exact (bit for bit, and ==);
- the residual through the order-3 bundle: 1e-4 relative to max (the
  order-3 bound of tests/test_torch_jet.py: Taylor terms amplify f32
  rounding);
- exact solution and soliton IC: 1e-6 relative to max (float32, sqrt(c)
  taken in float64 here and in float32 by JAX);
- the soliton's own residual, by nested autograd in float64: 1e-6 of max |u|;
- compute_loss: BC, IC 1e-5 relative; the causal residual and the total
  1e-4 (order-3 streams, then a cumulative sum inside exp);
- one Adam step: parameters 5e-4 absolute, a quarter of one step at lr
  2e-3 (the bound and reason of tests/test_torch_trainer.py).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity_helpers import (KDV_DOMAIN, inject_points, jax_bc_ic_points, kdv_pair, points,
                                  rel_to_max)

from pinnrl_tpu.benchmarks import convergence as jax_conv
from pinnrl_tpu.models import PINNModel as JaxModel
from pinnrl_tpu.training.trainer import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.benchmarks import convergence
from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.models import PINNModel
from pinnrl_tpu_torch.models.fourier import feature_basis
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.training import PDETrainer
from pinnrl_tpu_torch.training.lbfgs import LBFGS

BASES = Path(convergence.__file__).resolve().parents[1] / "config" / "feature_bases.json"


# ---------------------------------------------------------------- feature_seed


def test_recipe_basis_equals_jax_bit_for_bit():
    tB = PINNModel(convergence.build_recipe_config("kdv", device="cpu"), seed=0).constants[
        "FourierFeatures_0.B"].numpy()
    jB = np.asarray(JaxModel(jax_conv.build_recipe_config("kdv"), seed=0).constants[
        "constants"]["FourierFeatures_0"]["B"])
    assert tB.shape == (2, 256) and tB.dtype == jB.dtype == np.float32
    assert tB.tobytes() == jB.tobytes()


def test_shipped_bases_equal_jax_draws():
    table = json.loads(BASES.read_text())
    assert sorted(table) == ["seed0_2x128", "seed0_2x256"]
    for key, rows in table.items():
        seed, shape = key.split("_")
        d, m = (int(v) for v in shape.split("x"))
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(int(seed[4:])), (d, m)))
        got = np.asarray(rows, np.float32)
        assert got.tobytes() == ref.tobytes(), key
        assert feature_basis(int(seed[4:]), d, m).numpy().tobytes() == ref.tobytes()


def test_anisotropic_scale_multiplies_rows_as_jax():
    cfg = jax_conv.build_recipe_config("kdv")
    cfg.model.arch_params["scale"] = (0.0, 1.0)
    tcfg = convergence.build_recipe_config("kdv", device="cpu")
    tcfg.model.arch_params["scale"] = (0.0, 1.0)
    jB = np.asarray(JaxModel(cfg, seed=0).constants["constants"]["FourierFeatures_0"]["B"])
    tB = PINNModel(tcfg, seed=0).constants["FourierFeatures_0.B"].numpy()
    assert tB.tobytes() == jB.tobytes() and not tB[0].any()


@pytest.mark.parametrize("seed,in_dim,m", [(1, 2, 256), (0, 3, 256), (0, 2, 64)])
def test_unknown_basis_raises(seed, in_dim, m):
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        feature_basis(seed, in_dim, m)


# ------------------------------------------------------------------- recipes


@pytest.mark.parametrize("key", ["kdv", "burgers", "heat"])
def test_recipes_and_configs_equal_jax(key):
    assert convergence.RECIPES[key] == jax_conv.RECIPES[key]
    a = jax_conv.build_recipe_config(key, epochs=7).to_dict()
    b = convergence.build_recipe_config(key, epochs=7, device="cpu").to_dict()
    assert b.pop("device") == "cpu"
    a.pop("device")
    assert a == b


def test_harness_raises_for_what_is_not_ported(monkeypatch, tmp_path):
    """An unknown recipe raises; resume and time-marching are ported: a
    missing checkpoint raises before any step, and time-marching runs on the
    card by default (it raises without one, no fallback)."""
    from pinnrl_tpu_torch.training import PDETrainer

    with pytest.raises(KeyError, match="unknown convergence recipe"):
        convergence.build_recipe_config("no_such_recipe", device="cpu")
    steps = []
    monkeypatch.setattr(PDETrainer, "_step", lambda self, *a: steps.append(a))
    with pytest.raises(FileNotFoundError):
        convergence.run_convergence("kdv", epochs=1, resume_from=str(tmp_path / "none.npz"),
                                    device="cpu")
    assert steps == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            convergence.run_time_marching("kdv")


@pytest.mark.parametrize("key,epochs,lbfgs_epochs", [("burgers", 4, 2), ("heat", 5, 3)])
def test_run_convergence_trains_the_adam_lbfgs_recipes(monkeypatch, key, epochs, lbfgs_epochs):
    """The Burgers (RAR) and heat recipes through the runner at CPU size
    (narrow trunk, 256 points, batch 128): 2 Adam epochs of 2 steps at the
    recipe's switch ratio, then L-BFGS epochs on all 256 points."""
    recipe = convergence.RECIPES[key]
    assert recipe["training"]["optimizer"] == "adam_lbfgs"
    small = {**recipe, "model": {**recipe["model"], "hidden_dims": [16, 16], "mapping_size": 8},
             "training": {**recipe["training"], "num_collocation_points": 256, "batch_size": 128,
                          "num_boundary_points": 32, "num_initial_points": 32}}
    monkeypatch.setitem(convergence.RECIPES, key, small)
    evals = LBFGS.evaluations
    res = convergence.run_convergence(key, seed=0, epochs=epochs, device="cpu")
    assert (res.pde, res.epochs, res.seed) == (key, epochs, 0)
    assert LBFGS.evaluations - evals >= 2 * lbfgs_epochs  # an initial evaluation and a trial each
    assert all(np.isfinite(v) for v in (res.rel_l2, res.max_error, res.final_train_loss,
                                        res.points_per_sec))
    # Adam epochs at their batch, L-BFGS epochs at theirs (all 256 points).
    points = res.points_per_sec * res.wall_time_s
    assert abs(points - (2 * 2 * 128 + lbfgs_epochs * 256)) < 1e-6 * points


def test_run_convergence_trains_and_reports(monkeypatch):
    """The runner end to end on the KdV recipe cut to CPU size (narrow
    trunk, no shipped basis for mapping 16, 2 steps of batch 128)."""
    small = {**convergence.RECIPES["kdv"],
             "model": dict(hidden_dims=[16, 16], mapping_size=16, scale=0.75),
             "training": {**convergence.RECIPES["kdv"]["training"], "num_collocation_points": 256,
                          "batch_size": 128, "num_boundary_points": 32, "num_initial_points": 32}}
    monkeypatch.setitem(convergence.RECIPES, "kdv", small)
    res = convergence.run_convergence("kdv", seed=0, epochs=1, device="cpu")
    assert (res.pde, res.architecture, res.epochs, res.seed) == ("kdv", "fourier", 1, 0)
    assert all(np.isfinite(v) for v in (res.rel_l2, res.max_error, res.final_train_loss,
                                        res.points_per_sec))
    assert convergence.results_to_csv([res]).count("\n") == 2


def test_results_to_csv_matches_jax():
    fields = dict(pde="kdv", architecture="fourier", epochs=5, rel_l2=0.5, max_error=0.25,
                  final_train_loss=1.5, wall_time_s=2.25, points_per_sec=1e5, seed=0)
    assert (convergence.results_to_csv([convergence.ConvergenceResult(**fields)])
            == jax_conv.results_to_csv([jax_conv.ConvergenceResult(**fields)]))


def test_recipe_trainer_takes_the_causal_order3_kernel():
    cfg = convergence.build_recipe_config("kdv", epochs=5, device="cpu")
    assert cfg.training.validation_frequency == 1 and cfg.training.causal_eps == 1.0
    pde = create_pde(cfg)
    trainer = PDETrainer(PINNModel(cfg, seed=0), pde, cfg)
    assert trainer.fused_kernel_active and trainer.fast_bundle_active
    from pinnrl_tpu_torch.ops.kernels import fused_step

    spec = fused_step._spec(trainer.model, pde)
    assert (spec.x_order, spec.residual, spec.causal_eps) == (3, "kdv", 1.0)


# ---------------------------------------------------------------------- PDE


@pytest.mark.parametrize("layer_norm", [True, False])
def test_residual_matches_jax(layer_norm):
    pair = kdv_pair(layer_norm=layer_norm)
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)
    x, t = points(5, 96, **KDV_DOMAIN)
    ref = pair.jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                     jnp.asarray(t), None)
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, torch.from_numpy(x),
                                         torch.from_numpy(t))
    assert got.shape == (96, 1)
    assert rel_to_max(got, np.asarray(ref).reshape(-1, 1)) < 1e-4


@pytest.mark.parametrize("dimension", [1, 2])
def test_exact_solution_and_targets_match_jax(dimension):
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.pdes import create_pde as jax_create_pde

    cfgs = [jax_load_config(pde_type="kdv", architecture="fourier"),
            load_config(pde_type="kdv", architecture="fourier", device="cpu")]
    for cfg in cfgs:
        cfg.pde.dimension = dimension
        cfg.pde.domain = [[-15.0, 15.0]] * dimension
    jpde, tpde = jax_create_pde(cfgs[0]), create_pde(cfgs[1])
    x, t = points(2, 300, domain=((-15.0, 15.0),) * dimension, time_domain=(0.0, 5.0))
    ref = np.asarray(jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
    assert rel_to_max(tpde.exact_solution(torch.from_numpy(x), torch.from_numpy(t)), ref) < 1e-6
    for name in ("initial", "dirichlet"):
        ref = np.asarray(jpde.boundary_conditions[name](jnp.asarray(x), jnp.asarray(t)))
        got = tpde.boundary_conditions[name](torch.from_numpy(x), torch.from_numpy(t))
        assert got.shape == ref.shape
        assert rel_to_max(got, ref) < 1e-6 if np.abs(ref).max() > 0 else not got.abs().max()


def test_soliton_satisfies_the_pde():
    """u_t + 6 u u_x + u_xxx of the port's exact soliton, by nested
    autograd in float64, as tests/test_pdes.py checks the JAX one."""
    pde = create_pde(load_config(pde_type="kdv", architecture="fourier", device="cpu"))
    xs, ts = np.meshgrid(np.linspace(-15.0, 15.0, 61), np.linspace(0.0, 5.0, 11))
    x = torch.tensor(xs.reshape(-1, 1), dtype=torch.float64, requires_grad=True)
    t = torch.tensor(ts.reshape(-1, 1), dtype=torch.float64, requires_grad=True)
    u = pde.exact_solution(x, t)

    def d(v, wrt):
        return torch.autograd.grad(v.sum(), wrt, create_graph=True)[0]

    u_x = d(u, x)
    u_xxx = d(d(u_x, x), x)
    r = d(u, t) + 6.0 * u * u_x + u_xxx
    assert float(r.detach().abs().max()) / float(u.detach().abs().max()) < 1e-6


def test_first_order_formulation_raises():
    """The first-order system is posed in one space dimension only, as in
    the JAX package."""
    cfg = load_config(pde_type="kdv", architecture="fourier", device="cpu")
    cfg.pde.parameters["formulation"] = "first_order"
    cfg.pde.dimension = 2
    cfg.pde.domain = [[-15.0, 15.0]] * 2
    with pytest.raises(ValueError, match="dimension=1 only"):
        create_pde(cfg)


def test_first_order_residual_matches_jax():
    """The (u, p, q) system on a 3-channel head: one x-jvp and one t-jvp of
    the restriction, (N, 3); 1e-5 relative to max (first-order jvps)."""
    from torch_parity_helpers import _configure_model_training, _pair

    from pinnrl_tpu.config import load_config as jax_load_config

    cfgs = [jax_load_config(pde_type="kdv", architecture="fourier"),
            load_config(pde_type="kdv", architecture="fourier", device="cpu")]
    for cfg in cfgs:
        cfg.pde.parameters["formulation"] = "first_order"
        cfg.model.output_dim = cfg.pde.output_dim = 3
        _configure_model_training(cfg, hidden=(32, 24), mapping=16, periodic=True,
                                  layer_norm=True, scale=0.75, causal_eps=0.0)
    pair = _pair(*cfgs, seed=0, jitter_ln=True)
    assert pair.tpde.system_size == pair.jpde.system_size == 3
    assert pair.tpde.spatial_orders == (1,)
    assert not pair.tpde.attach_fast_bundle(pair.tmodel)
    x, t = points(13, 64, **KDV_DOMAIN)
    ref = pair.jpde.compute_residual(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                     jnp.asarray(t))
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params,
                                         torch.from_numpy(x), torch.from_numpy(t))
        score = pair.tpde.residual_score(pair.tmodel.apply, pair.tmodel.params,
                                         torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (64, 3)
    assert rel_to_max(got, np.asarray(ref)) < 1e-5
    assert torch.equal(score, torch.sqrt(torch.sum(got * got, dim=1)))


# ------------------------------------------------------------- compute_loss


@pytest.mark.parametrize("causal", [True, False])
def test_compute_loss_matches_jax_and_sorts_only_when_causal(monkeypatch, causal):
    pair = kdv_pair(causal_eps=1.0 if causal else 0.0)
    pair.jpde.attach_fast_bundle(pair.jmodel)
    pair.tpde.attach_fast_bundle(pair.tmodel)
    x, t = points(21, 128, **KDV_DOMAIN)
    key = jax.random.PRNGKey(4)
    ref = pair.jpde.compute_loss(pair.jmodel.apply, pair.jmodel.params,
                                 jnp.asarray(x), jnp.asarray(t), key=key)
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, 128))

    def loss(fused):
        pair.tpde.attach_fused_residual_kernel(pair.tmodel, enable="on" if fused else "off")
        return pair.tpde.compute_loss(pair.tmodel.apply, pair.tmodel.params,
                                      torch.from_numpy(x), torch.from_numpy(t))

    unfused = loss(False)
    seen = []
    got = loss(True)
    fused_fn = pair.tpde._fused_residual_loss
    monkeypatch.setattr(pair.tpde, "_fused_residual_loss",
                        lambda p, z: seen.append(z) or fused_fn(p, z))
    loss_again = pair.tpde.compute_loss(pair.tmodel.apply, pair.tmodel.params,
                                        torch.from_numpy(x), torch.from_numpy(t))
    for k, tol in (("residual", 1e-4), ("boundary", 1e-5), ("initial", 1e-5), ("total", 1e-4)):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < tol, k
        assert abs(float(got[k].detach()) - float(unfused[k].detach())) <= 1e-6 * abs(float(unfused[k].detach())), k
    assert float(loss_again["total"].detach()) == float(got["total"].detach())
    z_in = torch.from_numpy(np.concatenate([x, t], axis=1))
    (z_seen,) = seen
    if causal:
        order = torch.argsort(z_in[:, 1], stable=True)
        assert torch.equal(z_seen, z_in[order]) and not torch.equal(z_seen, z_in)
    else:
        assert torch.equal(z_seen, z_in)


# ------------------------------------------------------------------ training


def test_one_adam_step_of_the_causal_slice_matches_optax(monkeypatch):
    pair = kdv_pair(causal_eps=1.0)
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    assert ttr.fused_kernel_active and ttr.fast_bundle_active
    jopt = jtr._make_adam(1, 4)
    jparams = {"net": pair.jmodel.params, "coeffs": {}}
    params = pair.tmodel.params
    topt = ttr._make_adam(1, 4, list(params.values()))
    x, t = points(100, 128, **KDV_DOMAIN)
    key = jax.random.PRNGKey(0)

    def jtotal(p):
        return jtr._loss_components(p, jnp.asarray(x), jnp.asarray(t), key)["total"]

    l_j, g_j = jax.value_and_grad(jtotal)(jparams)
    updates, _ = jopt.update(g_j, jopt.init(jparams), jparams)
    jparams = optax.apply_updates(jparams, updates)

    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, 128))
    losses = ttr._loss_components(params, torch.from_numpy(x), torch.from_numpy(t), None)
    losses["total"].backward()
    topt.step()
    assert abs(float(losses["total"].detach()) - float(l_j)) / abs(float(l_j)) < 1e-4
    for module, leaves in jparams["net"].items():
        for leaf, ref in leaves.items():
            name = f"{module}.{ {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}[leaf] }"
            got = params[name].detach().numpy()
            got = got.T if got.ndim == 2 else got
            assert np.max(np.abs(got - np.asarray(ref))) < 5e-4, name


def test_train_returns_finite_history():
    pair = kdv_pair(causal_eps=1.0)
    cfg = pair.tcfg.training
    cfg.num_collocation_points, cfg.batch_size, cfg.validation_frequency = 256, 128, 1
    trainer = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    res = trainer.train(num_epochs=2, seed=0)
    hist = res["history"]
    assert len(hist["train_loss"]) == 2 and len(hist["val_loss"]) == 2
    assert all(np.isfinite(v) for v in hist["train_loss"] + hist["val_loss"])
    metrics = pair.tpde.validate(pair.tmodel.apply, trainer._final_state["params"]["net"],
                                 num_points=400)
    assert np.isfinite(metrics["rel_l2"])
