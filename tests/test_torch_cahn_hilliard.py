"""Cahn-Hilliard in the port against pinnrl_tpu: the direct and mixed
residuals, the exact solutions and the IC/BC factories, the Neumann BC
loss, the mass and mu-H2 penalties, compute_loss, the random IC, the
three recipes, and the random streams of the other PDEs' losses.

Tolerances:
- residuals in float64 on both sides (JAX under ``jax.enable_x64``):
  1e-12 relative to max (the same operations; measured ~2e-15);
- residuals in float32: 1e-5 relative to max. Four nested jvps (the
  direct form) amplify float32 rounding: the port's own float32 residual
  lies 5e-6 to 1.5e-5 of max from its float64 one; against JAX's float32
  it measured 3e-7 to 1.5e-6;
- exact solutions, IC and BC targets and the random IC: 1e-6 relative to
  max (float32); the spectral trajectory's, and validation on it: 1e-5
  (tests/test_torch_spectral.py's bound: FFTs of two libraries);
- the Neumann loss, the penalties and each compute_loss component: 1e-5
  relative; each parameter gradient 1e-4 relative to its max (the JAX
  suite's fused-kernel bounds, tests/test_pallas_parity_tpu.py:152-155);
- the mu-H2 penalty in float64, ``torch.fft.rfft`` against JAX's DFT by
  matmul: 1e-12 relative;
- recipe configs and generator states: equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (ch_pair, inject_loss_draws, jax_grad_rels, jax_loss_draws,
                                  points, rel_to_max, small_recipe_trainer, torch_params)

from pinnrl_tpu.benchmarks import convergence as jax_conv
from pinnrl_tpu_torch.benchmarks import convergence
from pinnrl_tpu_torch.pdes.base import PDEBase, random_ic_basis

N = 32
RECIPES = ("cahn_hilliard", "cahn_hilliard_dynamics", "cahn_hilliard_biharmonic")
# The dynamics recipe's PDE block with its spectral reference cut to nx 64,
# dt 1e-2 over [0, 1].
DYNAMICS = dict(
    domain=[[0.0, 6.283185307179586]], time_domain=[0.0, 1.0],
    exact_solution={"type": "spectral", "ic_modes": [[1, 0.6], [2, 0.3]], "nx": 64, "dt": 1e-2},
    initial_condition={"type": "spectral"}, boundary_conditions={"periodic": {}})


def _t(a):
    return torch.from_numpy(np.array(a))


def _domain(pair):
    return dict(domain=tuple(tuple(d) for d in pair.tpde.domain), time_domain=pair.tpde.time_domain)


def _jax_residual(pair, params, x, t):
    fn = jax.jit(lambda p, xx, tt: pair.jpde.compute_residual(pair.jmodel.apply, p, xx, tt))
    return np.asarray(fn(params, jnp.asarray(x), jnp.asarray(t)))


def _f64_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _jax_loss_and_grads(pair, x, t, key):
    def total(p):
        losses = pair.jpde.compute_loss(pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t),
                                        key=key)
        return losses["total"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(pair.jmodel.params)
    return {k: float(v) for k, v in losses.items()}, grads


def _check_loss_and_grads(monkeypatch, pair, x, t, key, keys):
    ref, g_j = _jax_loss_and_grads(pair, x, t, key)
    inject_loss_draws(monkeypatch, pair.tpde, jax_loss_draws(pair.jpde, key, x.shape[0]))
    params = torch_params(pair.tmodel)
    got = pair.tpde.compute_loss(pair.tmodel.apply, params, _t(x), _t(t))
    assert sorted(got) == sorted(ref)
    for k in keys:
        assert abs(float(got[k].detach()) - ref[k]) / abs(ref[k]) < 1e-5, k
    grads = dict(zip(params, torch.autograd.grad(got["total"], list(params.values()))))
    for name, rel in jax_grad_rels(grads, g_j).items():
        assert rel < 1e-4, name


# ------------------------------------------------------------------ residuals


@pytest.mark.parametrize("formulation,dim", [("direct", 1), ("direct", 2), ("mixed", 1),
                                             ("mixed", 2)])
def test_residual_matches_jax_in_float32_and_float64(formulation, dim):
    pair = ch_pair(formulation, dim)
    k = 2 if formulation == "mixed" else 1
    assert pair.tpde.system_size == pair.jpde.system_size == k
    assert pair.tpde.spatial_orders == pair.jpde.spatial_orders
    assert not pair.tpde.attach_fast_bundle(pair.tmodel)
    x, t = points(3, N, **_domain(pair))
    ref = _jax_residual(pair, pair.jmodel.params, x, t)
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, _t(x), _t(t))
    assert got.shape == ref.shape == (N, k)
    assert rel_to_max(got, ref) < 1e-5

    with jax.enable_x64(True):
        ref64 = _jax_residual(pair, _f64_tree(pair.jmodel.params), x.astype(np.float64),
                              t.astype(np.float64))
    assert ref64.dtype == np.float64
    pair.tmodel.module.double()
    with torch.no_grad():
        got64 = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params,
                                           _t(x).double(), _t(t).double())
    assert got64.dtype == torch.float64
    assert rel_to_max(got64, ref64) < 1e-12


def test_mixed_residual_scores_and_validates_on_channel_0():
    """On a 2-channel head: residual_score l2-collapses the channels, and
    validate reads channel 0, on JAX's validation points."""
    from pinnrl_tpu.sampling import sample_uniform as jax_sample_uniform

    pair = ch_pair("mixed", 2)
    key = jax.random.PRNGKey(2)
    x, t = (np.array(a) for a in jax_sample_uniform(key, 64, pair.jpde.domain,
                                                    pair.jpde.time_domain))
    params = pair.tmodel.params
    with torch.no_grad():
        r = pair.tpde.compute_residual(pair.tmodel.apply, params, _t(x), _t(t))
        score = pair.tpde.residual_score(pair.tmodel.apply, params, _t(x), _t(t))
        got = pair.tpde._validate_on(pair.tmodel.apply, params, _t(x), _t(t))
    assert torch.equal(score, torch.sqrt(torch.sum(r * r, dim=1)))
    ref = pair.jpde.validate(pair.jmodel.apply, pair.jmodel.params, key=key, num_points=64)
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-5 * abs(v), k


# ------------------------------------------------------ exact solutions, IC, BC


@pytest.mark.parametrize("exact,ic,dim", [
    ("tanh", "tanh", 1), ("tanh", "tanh", 2), ("spinodal", "random", 1), ("spinodal", "random", 2),
    ("stationary_interface", "stationary_interface", 2), ("stationary_interface", "tanh", 1)])
def test_exact_solution_and_targets_match_jax(exact, ic, dim):
    """Each exact type, the IC factory (the stationary trace whenever the
    target is the standing interface) and the shipped Dirichlet (the exact
    trace under the standing interface, else 0) and zero-Neumann targets."""
    pair = ch_pair("direct", dim, pde={"exact_solution": {"type": exact},
                                       "initial_condition": {"type": ic, "amplitude": 0.1}})
    assert list(pair.tpde.boundary_conditions) == list(pair.jpde.boundary_conditions) == [
        "dirichlet", "neumann", "initial"]
    x, t = points(7, 64, **_domain(pair))
    got = pair.tpde.exact_solution(_t(x), _t(t))
    ref = np.asarray(pair.jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
    assert got.shape == ref.shape == (64, 1)
    assert rel_to_max(got, ref) < 1e-6
    for name, fn in pair.tpde.boundary_conditions.items():
        got = fn(_t(x), _t(t))
        ref = np.asarray(pair.jpde.boundary_conditions[name](jnp.asarray(x), jnp.asarray(t)))
        if np.abs(ref).max() == 0.0:
            assert float(got.abs().max()) == 0.0, name
        else:
            assert rel_to_max(got, ref) < 1e-6, name


@pytest.fixture(scope="module")
def dynamics_pair():
    """The dynamics recipe's mixed form on its cut spectral block, with its
    penalty weights (non-causal: the non-causal bounds apply)."""
    return ch_pair("mixed", 1, eps=0.5, pde=DYNAMICS,
                   training={"loss_weights": {"mass": 100.0, "mu_h2": 0.1}})


def test_spectral_target_matches_jax(dynamics_pair):
    pair = dynamics_pair
    x, t = points(8, 64, **_domain(pair))
    ref = np.asarray(pair.jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
    assert rel_to_max(pair.tpde.exact_solution(_t(x), _t(t)), ref) < 1e-5
    ic = pair.tpde.boundary_conditions["initial"](_t(x), _t(t))
    assert rel_to_max(ic, np.asarray(pair.jpde.boundary_conditions["initial"](
        jnp.asarray(x), jnp.asarray(t)))) < 1e-5


# ---------------------------------------------------------------- Neumann loss


@pytest.mark.parametrize("dim,value", [(1, 0.0), (2, 0.0), (2, 0.3)])
def test_neumann_loss_on_jax_draws_matches_jax(dim, value):
    pair = ch_pair("direct", dim, pde={"boundary_conditions": {"neumann": {"value": value}}})
    key = jax.random.PRNGKey(11)
    draws = jax_loss_draws(pair.jpde, key, 320)  # n_b 32: 8 points per face in 2-D
    # The boundary key compute_loss hands the Neumann loss (its only BC).
    k_bc = jax.random.split(jax.random.split(jax.random.fold_in(key, 0xB0), 2)[0])[1]
    ref = pair.jpde._neumann_loss(pair.jpde._scalar_u(pair.jmodel.apply, pair.jmodel.params),
                                  pair.jpde.boundary_conditions["neumann"], k_bc, 32)
    faces = [(_t(xf), _t(tf)) for xf, tf in draws["neumann"]]
    assert len(faces) == 2 * dim and faces[0][0].shape[0] == 32 // (2 * dim)
    u = pair.tpde._scalar_u(pair.tmodel.apply, pair.tmodel.params)
    got = pair.tpde._neumann_terms(u, pair.tpde.boundary_conditions["neumann"], faces)
    assert abs(float(got.detach()) - float(ref)) / abs(float(ref)) < 1e-5


def test_neumann_draws_follow_the_face_order(monkeypatch):
    """Per axis, the low face then the high, each x then t, from the
    loss's generator."""
    pair = ch_pair("direct", 2)
    tpde = pair.tpde
    seen = []
    terms = tpde._neumann_terms
    monkeypatch.setattr(tpde, "_neumann_terms",
                        lambda u, f, draws: seen.extend(draws) or terms(u, f, draws))
    gen = torch.Generator().manual_seed(5)
    tpde._neumann_loss(tpde._scalar_u(pair.tmodel.apply, pair.tmodel.params),
                       tpde.boundary_conditions["neumann"], gen, 16)
    replay = torch.Generator().manual_seed(5)
    for axis in range(2):
        for face_val in tpde.domain[axis]:
            x_f, t_f = seen.pop(0)
            assert torch.equal(x_f, tpde._sample_face(replay, 4, axis, face_val))
            assert torch.equal(t_f, tpde._sample_boundary_time(replay, 4))
    assert torch.equal(gen.get_state(), replay.get_state())


# ------------------------------------------------------ penalties, compute_loss


def test_dynamics_compute_loss_with_penalties_matches_jax(monkeypatch, dynamics_pair):
    """Periodic BC, spectral IC, mass and mu-H2 on JAX's draws: every
    component and every parameter gradient."""
    x, t = points(21, N, **_domain(dynamics_pair))
    _check_loss_and_grads(monkeypatch, dynamics_pair, x, t, jax.random.PRNGKey(4),
                          ("residual", "boundary", "initial", "mass", "mu_h2", "total"))


def test_mu_h2_by_rfft_equals_jax_dft_by_matmul_in_float64(dynamics_pair):
    pair = dynamics_pair
    key = jax.random.PRNGKey(9)
    with jax.enable_x64(True):
        # The penalty's own draw, in float64 as JAX makes it under x64.
        ts = np.array(jax.random.uniform(jax.random.fold_in(key, 0x4D55), (8, 1),
                                         minval=pair.jpde.time_domain[0],
                                         maxval=pair.jpde.time_domain[1]))
        assert ts.dtype == np.float64
        params = _f64_tree(pair.jmodel.params)
        out = pair.jpde._mu_h2_penalty(pair.jmodel.apply, params, None, key,
                                       {"total": jnp.zeros((), jnp.float64)}, 1.0)
        ref = float(out["mu_h2"])
        assert out["mu_h2"].dtype == jnp.float64
    model = pair.tmodel
    p64 = {k: v.detach().double() for k, v in model.params.items()}
    saved = {k: v.clone() for k, v in model.module.state_dict().items()}
    model.module.double()
    try:
        with torch.no_grad():
            got = pair.tpde._mu_h2_terms(model.apply, p64, None, _t(ts))
    finally:
        model.module.float()
        model.module.load_state_dict(saved)
    assert got.dtype == torch.float64
    assert abs(float(got) - ref) / abs(ref) < 1e-12


def test_direct_compute_loss_matches_jax(monkeypatch):
    """The biharmonic recipe's block (standing interface on [-1, 1], eps
    0.18, exact Dirichlet) on a narrow trunk with its t-free basis."""
    pair = ch_pair("direct", 1, eps=0.18, domain=(-1.0, 1.0), scale=(1.0, 0.0),
                   pde={"boundary_conditions": {"dirichlet": {"type": "exact"}}})
    x, t = points(22, N, **_domain(pair))
    _check_loss_and_grads(monkeypatch, pair, x, t, jax.random.PRNGKey(6),
                          ("residual", "boundary", "initial", "total"))


@pytest.mark.parametrize("formulation,dim,weights,want", [
    ("mixed", 1, {"mass": 0.0, "mu_h2": 0.1}, set()),
    ("mixed", 2, {"mass": 100.0, "mu_h2": 0.1}, set()),
    ("direct", 1, {"mass": 100.0, "mu_h2": 0.1}, {"mass"}),
    ("mixed", 1, {"mass": 100.0, "mu_h2": 0.0}, {"mass"}),
    ("mixed", 1, {"mass": 100.0, "mu_h2": 0.1}, {"mass", "mu_h2"})])
def test_penalties_apply_as_the_reference_gates_them(formulation, dim, weights, want):
    """mass <= 0 skips both (as pinnrl_tpu's early return does), both need
    one space dimension, mu-H2 the mixed form; each draws its times after
    the base loss, mass first, and adds weight x term to the total."""
    pair = ch_pair(formulation, dim, training={"loss_weights": weights})
    tpde, apply = pair.tpde, pair.tmodel.apply
    x, t = points(2, N, **_domain(pair))
    params = pair.tmodel.params
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        got = tpde.compute_loss(apply, params, _t(x), _t(t), generator=gen)
        replay = torch.Generator().manual_seed(3)
        base = PDEBase.compute_loss(tpde, apply, params, _t(x), _t(t), generator=replay)
        total = base["total"]
        for name, k in (("mass", 16), ("mu_h2", 8)):
            if name in want:
                ts = tpde._draw_times(replay, k)
                term = (tpde._mass_terms(apply, params, ts) if name == "mass"
                        else tpde._mu_h2_terms(apply, params, None, ts))
                assert torch.equal(got[name], term)
                total = total + weights[name] * term
    assert set(got) - set(base) == want
    assert torch.equal(gen.get_state(), replay.get_state())
    assert torch.allclose(got["total"], total, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("pde_type", ["burgers", "heat"])
def test_other_losses_draw_only_the_base_points(pde_type):
    """Burgers's and heat's compute_loss leave the generator where their
    BC (periodic for heat) and IC draws alone leave it."""
    from pinnrl_tpu_torch.config import load_config
    from pinnrl_tpu_torch.models import PINNModel
    from pinnrl_tpu_torch.pdes import create_pde

    cfg = load_config(pde_type=pde_type, architecture="fourier", device="cpu")
    cfg.model.hidden_dims = [8]
    cfg.model.arch_params["mapping_size"] = 4
    pde, model = create_pde(cfg), PINNModel(cfg, seed=0)
    x, t = pde.generate_collocation_points(torch.Generator().manual_seed(0), 64, "uniform")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        pde.compute_loss(model.apply, model.params, x, t, generator=gen)
    replay = torch.Generator().manual_seed(7)
    n_b, n_i = pde._bc_counts(64)
    for bc_type in pde.boundary_conditions:
        if bc_type == "periodic":
            per_axis = max(n_b // (2 * pde.dimension), 1)
            los, his = pde._space_bounds(replay.device)
            pde._uniform(replay, per_axis, los, his)
            pde._sample_boundary_time(replay, per_axis)
        elif bc_type != "initial":
            pde._sample_boundary_points(replay, n_b)
    pde._sample_initial_points(replay, n_i)
    assert torch.equal(gen.get_state(), replay.get_state())


# ------------------------------------------------------------------ random IC


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_random_ic_matches_jax(dim):
    pair = ch_pair("direct", dim, pde={"exact_solution": {"type": "spinodal"},
                                       "initial_condition": {"type": "random", "amplitude": 0.1}})
    x, t = points(12, 128, **_domain(pair))
    got = pair.tpde.boundary_conditions["initial"](_t(x), _t(t))
    ref = np.asarray(pair.jpde.boundary_conditions["initial"](jnp.asarray(x), jnp.asarray(t)))
    assert got.shape == ref.shape == (128, 1)
    assert rel_to_max(got, ref) < 1e-6


def test_random_ic_outside_the_table_raises():
    """Series outside the former table are JAX's draws (the threefry
    replica); a negative mode count raises, as jax.random does."""
    for seed, modes, dim in ((1, 16, 1), (0, 8, 1), (0, 16, 4)):
        k_w, k_p, k_a = jax.random.split(jax.random.PRNGKey(seed), 3)
        ref = (jax.random.normal(k_w, (dim, modes)) * 4.0,
               jax.random.uniform(k_p, (modes,), maxval=2 * jnp.pi),
               jax.random.normal(k_a, (modes,)) / jnp.sqrt(modes))
        for got, want in zip(random_ic_basis(seed, modes, dim), ref):
            assert got.numpy().tobytes() == np.asarray(want, np.float32).tobytes(), (seed, modes)
        with pytest.raises(ValueError):
            random_ic_basis(seed, -modes, dim)
    W, phase, amp = random_ic_basis(0, 16, 2)
    assert W.shape == (2, 16) and phase.shape == amp.shape == (16,)


# -------------------------------------------------------------------- recipes


@pytest.mark.parametrize("key", RECIPES)
def test_recipe_config_equals_jax(key):
    a = jax_conv.build_recipe_config(key).to_dict()
    b = convergence.build_recipe_config(key, device="cpu").to_dict()
    a.pop("device"), b.pop("device")
    assert a == b
    assert convergence.RECIPES[key] == jax_conv.RECIPES[key]


def test_all_fourteen_recipes_build():
    assert sorted(convergence.RECIPES) == sorted(jax_conv.RECIPES) and len(convergence.RECIPES) == 14
    for key in convergence.RECIPES:
        assert convergence.build_recipe_config(key, epochs=1, device="cpu").training.num_epochs == 1
    with pytest.raises(KeyError, match="unknown convergence recipe"):
        convergence.build_recipe_config("cahn_hilliard_3d", device="cpu")


@pytest.mark.parametrize("key", RECIPES)
def test_recipe_trains_on_cpu(key):
    """Each recipe cut to CPU size (a Fourier trunk 16x2 with mapping 8, or
    the attention trunk 8 wide, 1 layer, 2 heads; 256 points in batches of
    128) for 4 epochs: finite, falling losses, the switch where the recipe
    has one, the penalties on the dynamics recipe, no kernel 1."""
    trainer = small_recipe_trainer(key, epochs=4)
    if key == "cahn_hilliard":
        from pinnrl_tpu_torch.models import PINNModel
        from pinnrl_tpu_torch.pdes import create_pde
        from pinnrl_tpu_torch.training import PDETrainer

        cfg = trainer.config
        cfg.model.arch_params.update({"hidden_dim": 8, "num_layers": 1, "num_heads": 2})
        trainer = PDETrainer(PINNModel(cfg, seed=0), create_pde(cfg), cfg)
        assert trainer.model.architecture_name == "attention"
    assert not trainer.fused_kernel_active and not trainer.fast_bundle_active
    cfg, pde = trainer.config, trainer.pde
    res = trainer.train(seed=0)
    hist = res["history"]["train_loss"]
    assert res["status"] == "completed" and len(hist) == 4
    assert all(np.isfinite(v) for v in hist + res["history"]["val_loss"])
    assert hist[-1] < hist[0]
    want_switch = (int(cfg.training.adam_lbfgs_switch_ratio * 4)
                   if cfg.training.optimizer == "adam_lbfgs" else None)
    assert trainer.switch_epoch == want_switch
    x, t = pde.generate_collocation_points(torch.Generator().manual_seed(1), 64, "uniform")
    with torch.no_grad():
        losses = pde.compute_loss(trainer.model.apply, trainer.model.params, x, t)
    penalties = {"mass", "mu_h2"} if key == "cahn_hilliard_dynamics" else set()
    assert penalties <= set(losses) and not ({"mass", "mu_h2"} - penalties) & set(losses)
    assert all(bool(torch.isfinite(v)) for v in losses.values())


def test_random_ic_table_is_shipped_with_the_package():
    import tomllib

    repo = Path(__file__).resolve().parent.parent
    data = tomllib.loads((repo / "pyproject.toml").read_text())
    package_data = data["tool"]["setuptools"]["package-data"]["pinnrl_tpu_torch"]
    # The series are drawn by the threefry replica: no table, and the
    # replica is a module of the package.
    assert not any("bases.json" in entry for entry in package_data)
    assert not (repo / "pinnrl_tpu_torch/config/random_ic_bases.json").exists()
    assert (repo / "pinnrl_tpu_torch/utils/prng.py").exists()
    assert [a.shape for a in random_ic_basis(0, 16, 3)] == [(3, 16), (16,), (16,)]



@pytest.mark.parametrize("key", RECIPES)
def test_chip_smoke_counts_equal_the_cpu_rehearsal(key, monkeypatch):
    """Kernel 2's launches and jvp-rule calls per loss that chip_smoke.py
    holds the card to, counted here on the CPU by running the plain version
    through ``_FourierFeaturesFn`` as the card runs the kernel (a CPU tensor
    otherwise takes the plain version without the Function), with one
    launch per validate on a Fourier trunk."""
    import importlib.util

    from pinnrl_tpu_torch.ops.kernels import fourier_feats as ff

    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tr = small_recipe_trainer(key, epochs=4)
    params = tr.model.params
    gen = torch.Generator().manual_seed(0)
    opt = tr._make_adam(1, 1, list(params.values()))
    tr._step(params, opt, gen, 128)  # warm
    calls = {"launches": 0, "jvps": 0}

    def launch(x, B, two_pi=True):
        calls["launches"] += 1
        return ff.fourier_features_plain(x, B, two_pi)

    def through_function(x, B, two_pi=True):
        if ff.needs_rules(x, B):
            return ff._FourierFeaturesFn.apply(x, B, bool(two_pi), launch)
        return launch(x, B, two_pi)

    rule = ff._FourierFeaturesFn.jvp

    def counted_rule(ctx, *args):
        calls["jvps"] += 1
        return rule(ctx, *args)

    monkeypatch.setattr(ff, "fourier_features", through_function)
    monkeypatch.setattr(ff._FourierFeaturesFn, "jvp", staticmethod(counted_rule))
    got = {}
    for what, fn in (("adam_step", lambda: tr._step(params, opt, gen, 128)),
                     ("validate", lambda: tr.pde.validate(tr.model.apply, params, num_points=64))):
        calls.update(launches=0, jvps=0)
        fn()
        got[what] = dict(calls)
    launches, jvps = smoke.CH_FF_PER_LOSS[key]
    assert got["adam_step"] == {"launches": launches, "jvps": jvps}
    assert got["validate"] == {"launches": int(key != "cahn_hilliard"), "jvps": 0}
