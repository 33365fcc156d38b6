"""Inverse and data modes of the port against pinnrl_tpu.

Small problems (Fourier 16x2, mapping 8; BC/IC 32 points), the same
parameters through the bridge and the same numpy-seeded points and
observations in both packages (JAX draws observations with threefry, so
both get them through ``set_observations``), the BC/IC draws of one JAX key
injected into the port. Tolerances: the JAX suite's for its kernels
(``tests/test_pallas_parity_tpu.py:152-155``), loss 1e-5 relative and each
gradient 1e-4 relative to its max. One Adam step moves each coefficient by
lr times the sign of its gradient, so the coefficients after it agree to
1e-6; the network's leaves to a quarter of a step (``test_torch_trainer.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity_helpers import (
    DOMAINS,
    HEAT_DOMAIN,
    burgers_pair,
    inject_periodic_draws,
    inject_points,
    jax_bc_ic_points,
    jax_grad_rels,
    pde_pair,
    points,
    rel_to_max,
)

from pinnrl_tpu.benchmarks import inverse as jax_inverse
from pinnrl_tpu.training.trainer import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.pdes import create_pde
from pinnrl_tpu_torch.training import PDETrainer

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
COEFF_ATOL = 1e-6
PARAM_ATOL = 5e-4
N = 128
OBS = 96
DOMAIN = {"heat": HEAT_DOMAIN, "black_scholes": DOMAINS["black_scholes"]}


def inverse_pair(key, mode="inverse", trainable=True):
    """The inverse recipe ``key``'s PDE block at small width in both
    packages, in ``mode``; with ``trainable`` its identified parameters at
    their recipe guesses."""
    recipe = jax_inverse.RECIPES[key]
    pde = dict(recipe.get("pde") or {})
    if trainable:
        pde["trainable_parameters"] = list(recipe["identify"])
        pde["parameter_initial_guesses"] = dict(recipe["guesses"])
    pair = pde_pair(key, hidden=(16, 16), mapping=8, scale=recipe["model"]["scale"], pde=pde)
    for cfg in (pair.jcfg, pair.tcfg):
        cfg.training.mode = mode
    return pair


def observe(pair, key, seed=7):
    """The same noisy observations of the exact solution in both packages."""
    x, t = points(seed, OBS, **DOMAIN[key])
    u = np.asarray(pair.jpde.exact_solution(jnp.asarray(x), jnp.asarray(t)))
    u = (u + 0.01 * np.random.default_rng(seed).standard_normal(u.shape)).astype(np.float32)
    pair.jpde.set_observations(x, t, u)
    pair.tpde.set_observations(x, t, u)
    return x, t, u


def inject_draws(monkeypatch, pair, key, jkey):
    if key == "heat":
        inject_periodic_draws(monkeypatch, pair, jkey, N)
    else:
        inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, jkey, N))


def trainers(pair):
    return JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg), PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)


def test_data_loss_matches_jax():
    pair = inverse_pair("heat")
    observe(pair, "heat")
    ref = pair.jpde._compute_data_loss(pair.jmodel.apply, pair.jmodel.params)
    got = pair.tpde._compute_data_loss(pair.tmodel.apply, pair.tmodel.params)
    assert abs(float(got.detach()) - float(ref)) / abs(float(ref)) < LOSS_TOL
    obs = pair.tpde.observations
    assert [tuple(a.shape) for a in obs] == [(OBS, 1), (OBS, 1), (OBS, 1)]
    assert all(a.dtype == torch.float32 for a in obs)


@pytest.mark.parametrize("key", ["heat", "black_scholes"])
def test_loss_and_coefficient_gradients_match_jax(monkeypatch, key):
    """The total loss in inverse mode and its gradient with respect to each
    coefficient (heat's alpha; Black-Scholes' sigma and r) and each network
    leaf, against jax.grad over {"net", "coeffs"}."""
    pair = inverse_pair(key)
    observe(pair, key)
    jtr, ttr = trainers(pair)
    assert ttr.fast_bundle_active and not ttr.fused_kernel_active
    x, t = points(3, N, **DOMAIN[key])
    jkey = jax.random.PRNGKey(4)

    def jtotal(p):
        return jtr._loss_components(p, jnp.asarray(x), jnp.asarray(t), jkey)["total"]

    jparams = {"net": pair.jmodel.params, "coeffs": pair.jpde.init_coeffs()}
    l_j, g_j = jax.value_and_grad(jtotal)(jparams)
    inject_draws(monkeypatch, pair, key, jkey)
    params = pair.tmodel.params
    losses = ttr._loss_components(params, torch.from_numpy(x), torch.from_numpy(t), None)
    names = sorted(ttr.coeffs)
    assert names == sorted(jax_inverse.RECIPES[key]["identify"])
    grads = torch.autograd.grad(losses["total"], ttr._leaves(params))
    assert abs(float(losses["total"].detach()) - float(l_j)) / abs(float(l_j)) < LOSS_TOL
    assert float(losses["data"].detach()) > 0.0
    for name, g in zip(names, grads):
        ref = float(g_j["coeffs"][name])
        assert abs(float(g) - ref) / abs(ref) < GRAD_TOL, name
    net_grads = dict(zip(params, grads[len(names):]))
    rels = jax_grad_rels(net_grads, g_j["net"])
    assert max(rels.values()) < GRAD_TOL, rels


@pytest.mark.parametrize("mode", ["data_only", "data_augmented"])
def test_data_mode_totals_match_jax(monkeypatch, mode):
    """Every component and the gated total in the data modes (no trainable
    coefficients), against the JAX package's compute_loss."""
    pair = inverse_pair("heat", mode=mode, trainable=False)
    observe(pair, "heat")
    x, t = points(5, N, **HEAT_DOMAIN)
    jkey = jax.random.PRNGKey(6)
    ref = pair.jpde.compute_loss(pair.jmodel.apply, pair.jmodel.params, jnp.asarray(x),
                                 jnp.asarray(t), coeffs={}, key=jkey)
    inject_periodic_draws(monkeypatch, pair, jkey, N)
    got = pair.tpde.compute_loss(pair.tmodel.apply, pair.tmodel.params, torch.from_numpy(x),
                                 torch.from_numpy(t), coeffs={})
    for k in ("total", "residual", "boundary", "initial", "data"):
        r = float(ref[k])
        assert abs(float(got[k].detach()) - r) <= LOSS_TOL * abs(r), k
    data_w = float(pair.tcfg.training.loss_weights["data"])
    if mode == "data_only":
        assert float(got["total"].detach()) == pytest.approx(data_w * float(got["data"].detach()), rel=1e-6)


def test_one_adam_step_over_net_and_coefficients_matches_optax(monkeypatch):
    """AdamW (weight decay 5e-4, the inverse recipes' default) with global-norm
    clipping over {"coeffs", "net"}: one step from the same point."""
    pair = inverse_pair("black_scholes")
    for cfg in (pair.jcfg, pair.tcfg):
        cfg.training.optimizer_config.weight_decay = 5e-4
    observe(pair, "black_scholes")
    jtr, ttr = trainers(pair)
    x, t = points(8, N, **DOMAIN["black_scholes"])
    jkey = jax.random.PRNGKey(9)
    jparams = {"net": pair.jmodel.params, "coeffs": pair.jpde.init_coeffs()}
    jopt = jtr._make_adam(1, 2)
    l_j, g_j = jax.value_and_grad(
        lambda p: jtr._loss_components(p, jnp.asarray(x), jnp.asarray(t), jkey)["total"])(jparams)
    updates, _ = jopt.update(g_j, jopt.init(jparams), jparams)
    jparams = optax.apply_updates(jparams, updates)

    inject_draws(monkeypatch, pair, "black_scholes", jkey)
    params = pair.tmodel.params
    topt = ttr._make_adam(1, 2, ttr._leaves(params))
    losses = ttr._loss_components(params, torch.from_numpy(x), torch.from_numpy(t), None)
    losses["total"].backward()
    topt.step()
    assert abs(float(losses["total"].detach()) - float(l_j)) / abs(float(l_j)) < LOSS_TOL
    for name, ref in jparams["coeffs"].items():
        assert abs(float(ttr.coeffs[name].detach()) - float(ref)) < COEFF_ATOL, name
    for module, leaves in jparams["net"].items():
        for leaf, ref in leaves.items():
            name = f"{module}.{ {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}[leaf] }"
            got = params[name].detach().numpy()
            got = got.T if got.ndim == 2 else got
            assert np.max(np.abs(got - np.asarray(ref))) < PARAM_ATOL, name


def test_leaf_without_gradient_steps_as_zero():
    """A coefficient that got no gradient (the loss here does not read
    alpha) steps as optax steps a zero gradient, not skipped as torch's Adam
    would skip it."""
    pair = inverse_pair("heat")
    _, ttr = trainers(pair)
    params = pair.tmodel.params
    opt = ttr._make_adam(1, 1, ttr._leaves(params))
    before = float(ttr.coeffs["alpha"].detach())
    loss = sum((v ** 2).sum() for v in params.values())
    loss.backward()
    assert ttr.coeffs["alpha"].grad is None
    opt.step()
    assert ttr.coeffs["alpha"].grad is not None
    assert float(ttr.coeffs["alpha"].detach()) == before  # no weight decay in the pair


def test_one_lbfgs_iteration_with_coefficients_matches_optax(monkeypatch):
    """optax.lbfgs over {"coeffs", "net"} against the port's LBFGS over the
    coefficients then the network: the same value, line-search trials and
    parameters after one iteration."""
    pair = inverse_pair("heat")
    observe(pair, "heat")
    jtr, ttr = trainers(pair)
    x, t = points(11, N, **HEAT_DOMAIN)
    jkey = jax.random.PRNGKey(12)

    def jloss(p):
        return jtr._loss_components(p, jnp.asarray(x), jnp.asarray(t), jkey)["total"]

    jopt = jtr._make_lbfgs()
    jparams = {"net": pair.jmodel.params, "coeffs": pair.jpde.init_coeffs()}
    jstate = jopt.init(jparams)
    value, grads = jax.value_and_grad(jloss)(jparams)
    updates, jstate = jopt.update(grads, jstate, jparams, value=value, grad=grads, value_fn=jloss)
    jparams = optax.apply_updates(jparams, updates)
    trials = int(jstate[-1].info.num_linesearch_steps)

    inject_periodic_draws(monkeypatch, pair, jkey, N)
    params = pair.tmodel.params
    topt = ttr._make_lbfgs(ttr._leaves(params))
    comps = ttr._lbfgs_step(params, topt, (torch.from_numpy(x), torch.from_numpy(t), 0),
                            torch.Generator().manual_seed(0))
    assert abs(float(comps[0]) - float(value)) / abs(float(value)) < LOSS_TOL
    assert topt.trials == trials
    ref = float(jparams["coeffs"]["alpha"])
    assert abs(float(ttr.coeffs["alpha"].detach()) - ref) / abs(ref) < GRAD_TOL
    for module, leaves in jax.device_get(jparams["net"]).items():
        for leaf, r in leaves.items():
            name = f"{module}.{ {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}[leaf] }"
            got = params[name].detach().numpy()
            got = got.T if got.ndim == 2 else got
            assert rel_to_max(got, np.asarray(r)) < GRAD_TOL, name


def _tiny_trainer(key, guesses=None):
    pair = inverse_pair(key)
    t = pair.tcfg.training
    t.num_collocation_points, t.batch_size, t.validation_frequency = 256, 128, 2
    if guesses:
        pair.tcfg.pde.parameter_initial_guesses.update(guesses)
        pair.tpde = create_pde(pair.tcfg)
    pair.tpde.generate_synthetic_observations(torch.Generator().manual_seed(1), OBS, 0.01)
    return PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)


def test_train_records_coefficients_and_returns_identified_values():
    tr = _tiny_trainer("heat")
    res = tr.train(num_epochs=3, seed=0)
    hist = res["history"]["param_alpha"]
    assert len(hist) == 3 == len(res["history"]["train_loss"])
    assert len(res["history"]["val_loss"]) == 2
    assert res["identified_parameters"] == {"alpha": hist[-1]}
    assert res["true_parameters"] == {"alpha": 0.01}
    assert hist[0] != pytest.approx(0.1, abs=1e-9)  # alpha moved from its guess
    assert tr._final_state["params"]["coeffs"]["alpha"] is tr.coeffs["alpha"]


def test_identified_sigma_is_canonical():
    """Black-Scholes reads sigma only as sigma^2: a run started at a
    negative guess reports |sigma|, as the JAX package's canonicalize does."""
    tr = _tiny_trainer("black_scholes", guesses={"sigma": -0.4})
    res = tr.train(num_epochs=1, seed=0)
    raw = res["history"]["param_sigma"][-1]
    assert raw < 0 and res["identified_parameters"]["sigma"] == abs(raw)
    assert res["identified_parameters"]["r"] == res["history"]["param_r"][-1]


def test_kernel1_gate_in_both_directions(monkeypatch):
    """Live coefficients take the plain path (the fused callable replaced by
    one that raises is never called); ``coeffs={}`` takes the fused one.
    The trainer attaches kernel 1 in data_augmented mode and not in
    inverse mode, as the JAX package's ``supports``."""
    pair = burgers_pair()
    assert pair.tpde.attach_fast_bundle(pair.tmodel)
    calls = []

    def counting(params, z):
        calls.append(z.shape[0])
        return torch.zeros((), requires_grad=True)

    def raising(params, z):
        raise AssertionError("kernel 1 called with live coefficients")

    x, t = (torch.from_numpy(a) for a in points(1, 64))
    monkeypatch.setattr(pair.tpde, "_fused_residual_loss", raising)
    live = pair.tpde.compute_loss(pair.tmodel.apply, pair.tmodel.params, x, t,
                                  coeffs={"nu": torch.tensor(0.01, requires_grad=True)})
    plain = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, x, t)
    assert float(live["residual"]) == pytest.approx(float(torch.mean(plain ** 2)), rel=1e-6)
    monkeypatch.setattr(pair.tpde, "_fused_residual_loss", counting)
    pair.tpde.compute_loss(pair.tmodel.apply, pair.tmodel.params, x, t, coeffs={})
    assert calls == [64]

    for mode, trainable, want in (("data_augmented", False, True), ("inverse", True, False)):
        cfg = load_config(pde_type="burgers", architecture="fourier", device="cpu")
        cfg.model.hidden_dims, cfg.model.arch_params["mapping_size"] = [16, 16], 8
        cfg.training.mode = mode
        if trainable:
            cfg.pde.trainable_parameters = ["nu"]
        from pinnrl_tpu_torch.models import PINNModel

        tr = PDETrainer(PINNModel(cfg), create_pde(cfg), cfg)
        assert tr.fused_kernel_active == want, mode
        assert (tr.coeffs == {}) == (not trainable)


def test_observation_loaders(tmp_path, monkeypatch):
    """An .npz path, a dict, a tuple and a The Well spec load as the JAX
    package loads them."""
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu.pdes import create_pde as jax_create_pde

    rng = np.random.default_rng(0)
    x, t, u = (rng.random((20, 1), np.float32) for _ in range(3))
    np.savez(tmp_path / "obs.npz", x=x, t=t, u=u)
    for spec in (str(tmp_path / "obs.npz"), {"x": x, "t": t, "u": u}, (x, t, u.reshape(-1))):
        jcfg, tcfg = jax_load_config(pde_type="heat"), load_config(pde_type="heat", device="cpu")
        jcfg.pde.observation_data = tcfg.pde.observation_data = spec
        got, ref = create_pde(tcfg).observations, jax_create_pde(jcfg).observations
        for a, b in zip(got, ref):
            assert a.shape == b.shape and np.array_equal(a.numpy(), np.asarray(b))
    from pinnrl_tpu_torch.datasets.synthetic import ensure_synthetic_well_cache

    monkeypatch.setenv("PINNRL_WELL_CACHE", str(tmp_path / "well"))
    ensure_synthetic_well_cache(n_traj=1, n_points=40, seed=0)
    spec = {"source": "well", "name": "synthetic_heat_2d", "n_traj": 1, "n_points": 40}
    jcfg, tcfg = jax_load_config(pde_type="heat_2d"), load_config(pde_type="heat_2d", device="cpu")
    jcfg.pde.observation_data = tcfg.pde.observation_data = spec
    got, ref = create_pde(tcfg).observations, jax_create_pde(jcfg).observations
    for a, b in zip(got, ref):
        assert a.shape == b.shape and np.array_equal(a.numpy(), np.asarray(b))
    tcfg = load_config(pde_type="heat", device="cpu")
    tcfg.pde.observation_data = 3.0
    with pytest.raises(ValueError, match="Unsupported observation_data"):
        create_pde(tcfg)


def test_synthetic_observations_read_the_true_coefficients():
    """generate_synthetic_observations samples the exact solution at the
    TRUE alpha (not the guess), plus noise from the given generator only."""
    cfg = load_config(pde_type="heat", device="cpu")
    cfg.pde.trainable_parameters = ["alpha"]
    cfg.pde.parameter_initial_guesses = {"alpha": 0.5}
    pde = create_pde(cfg)
    assert float(pde.init_coeffs()["alpha"]) == 0.5 and pde.true_parameters == {"alpha": 0.01}
    pde.generate_synthetic_observations(torch.Generator().manual_seed(3), 500, 0.0)
    x, t, u = pde.observations
    assert torch.allclose(u, pde.exact_solution(x, t), atol=0, rtol=0)
    assert not torch.allclose(u, pde.exact_solution(x, t, pde.init_coeffs()))
    pde.generate_synthetic_observations(torch.Generator().manual_seed(3), 500, 0.1)
    noise = pde.observations[2] - pde.exact_solution(x, t)
    assert torch.equal(pde.observations[0], x)
    assert 0.08 < float(noise.std()) < 0.12


def test_kdv_exact_solution_carries_the_speed_gradient():
    """The fault of this slice's check: KdV's exact solution took
    ``math.sqrt`` of the speed, which reads a live (trainable) speed as a
    float and cuts its gradient. Against jax.grad of the JAX package's."""
    pair = pde_pair("kdv", hidden=(16, 16), mapping=8,
                    pde={"trainable_parameters": ["speed"],
                         "parameter_initial_guesses": {"speed": 1.3}})
    x, t = points(2, 64, domain=((-15.0, 15.0),), time_domain=(0.0, 5.0))

    def jsum(c):
        return jnp.sum(pair.jpde.exact_solution(jnp.asarray(x), jnp.asarray(t), c))

    coeffs_j = pair.jpde.init_coeffs()
    ref = jax.grad(jsum)(coeffs_j)["speed"]
    coeffs = {k: v.requires_grad_(True) for k, v in pair.tpde.init_coeffs().items()}
    total = torch.sum(pair.tpde.exact_solution(torch.from_numpy(x), torch.from_numpy(t), coeffs))
    (g,) = torch.autograd.grad(total, [coeffs["speed"]])
    assert abs(float(total.detach()) - float(jsum(coeffs_j))) <= LOSS_TOL * abs(float(jsum(coeffs_j)))
    assert abs(float(g) - float(ref)) / abs(float(ref)) < GRAD_TOL


@pytest.mark.parametrize("key", ["heat", "black_scholes"])
def test_kernel2_calls_per_inverse_loss(monkeypatch, key):
    """What chip_smoke.py's phase 28 counts on the card, rehearsed on the
    CPU: the Fourier embedding runs three times per loss of an inverse
    recipe (heat: IC, periodic faces, data; Black-Scholes: Dirichlet, IC,
    data), the residual through the bundle's own embedding."""
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    pair = inverse_pair(key)
    observe(pair, key)
    _, ttr = trainers(pair)
    calls = []
    plain = fourier_feats.fourier_features

    def counting(x, B, two_pi=True):
        calls.append(x.shape[0])
        return plain(x, B, two_pi)

    monkeypatch.setattr(fourier_feats, "fourier_features", counting)
    x, t = (torch.from_numpy(a) for a in points(1, N, **DOMAIN[key]))
    ttr._loss_components(pair.tmodel.params, x, t, torch.Generator().manual_seed(0))
    assert len(calls) == 3 and OBS in calls
