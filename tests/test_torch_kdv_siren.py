"""KdV on its shipped configuration (``load_config(pde_type="kdv")``: a
124x7 SIREN, omega_0 30) through the generic derivative engine: residual,
loss components and parameter gradients against pinnrl_tpu on bridged
weights with JAX's BC/IC draws, and the trainer on the generic path.

Tolerances: the loss components 1e-4 relative and each parameter gradient
1e-3 relative to its max, the bounds JAX holds its own causal kernel to;
the order-3 residual of an omega_0 = 30 network (each order multiplies f32
rounding by ~omega) is held to the same 1e-4 relative to max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (KDV_DOMAIN, inject_points, jax_bc_ic_points, points, rel_to_max,
                                  siren_kdv_pair, torch_params)

from pinnrl_tpu_torch.ops.kernels import siren
from pinnrl_tpu_torch.training import PDETrainer

N = 64


@pytest.fixture(scope="module")
def shipped():
    pair = siren_kdv_pair()
    assert tuple(pair.tcfg.model.hidden_dims) == (124,) * 7
    assert pair.tcfg.model.arch_params["omega_0"] == 30.0
    return pair


def test_residual_matches_jax(shipped):
    pair = shipped
    assert not pair.tpde.attach_fast_bundle(pair.tmodel)
    x, t = points(5, N, **KDV_DOMAIN)
    ref = jax.jit(lambda p: pair.jpde.compute_residual(pair.jmodel.apply, p, jnp.asarray(x),
                                                       jnp.asarray(t)))(pair.jmodel.params)
    with torch.no_grad():
        got = pair.tpde.compute_residual(pair.tmodel.apply, pair.tmodel.params, torch.from_numpy(x),
                                         torch.from_numpy(t))
        score = pair.tpde.residual_score(pair.tmodel.apply, pair.tmodel.params,
                                         torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (N, 1) and score.shape == (N,)
    assert rel_to_max(got, np.asarray(ref)) < 1e-4
    assert torch.equal(score, got.abs().reshape(-1))


def test_loss_and_gradients_match_jax(monkeypatch, shipped):
    pair = shipped
    pair.tpde.attach_fast_bundle(pair.tmodel)
    assert not pair.tpde.attach_fused_residual_kernel(pair.tmodel)
    x, t = points(21, N, **KDV_DOMAIN)
    key = jax.random.PRNGKey(4)

    def jtotal(p):
        losses = pair.jpde.compute_loss(pair.jmodel.apply, p, jnp.asarray(x), jnp.asarray(t), key=key)
        return losses["total"], losses

    (_, ref), g_j = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(pair.jmodel.params)
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, N))
    params = torch_params(pair.tmodel)
    got = pair.tpde.compute_loss(pair.tmodel.apply, params, torch.from_numpy(x), torch.from_numpy(t))
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k].detach()) - float(ref[k])) / abs(float(ref[k])) < 1e-4, k
    grads = torch.autograd.grad(got["total"], list(params.values()))
    for name, g in zip(params, grads):
        module, leaf = name.split(".")
        ref_g = np.asarray(g_j[module]["kernel" if leaf == "weight" else leaf])
        got_g = g.numpy().T if leaf == "weight" else g.numpy()
        assert rel_to_max(got_g, ref_g) < 1e-3, name


def _small_cfg(pair):
    t = pair.tcfg.training
    t.num_collocation_points, t.batch_size, t.validation_frequency = 128, 64, 1
    pair.tcfg.evaluation.num_points = 64
    return pair


def test_trainer_takes_the_generic_path():
    """SIREN attaches neither the bundle nor kernel 1: every step and every
    validation runs the residual through nested jvp and finishes finite."""
    pair = _small_cfg(siren_kdv_pair(hidden=(16,) * 3))
    trainer = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    assert not trainer.fast_bundle_active and not trainer.fused_kernel_active
    res = trainer.train(num_epochs=2, seed=0)
    hist = res["history"]
    assert len(hist["train_loss"]) == 2 and len(hist["val_loss"]) == 2
    assert all(np.isfinite(v) for v in hist["train_loss"] + hist["val_loss"])
    metrics = pair.tpde.validate(pair.tmodel.apply, trainer._final_state["params"]["net"],
                                 num_points=200)
    assert np.isfinite(metrics["rel_l2"])


def test_rar_sampling_scores_through_the_engine():
    pair = _small_cfg(siren_kdv_pair(hidden=(16,) * 3))
    pair.tcfg.training.collocation_distribution = "residual_based"
    trainer = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    x, t = trainer._sample(torch.Generator().manual_seed(0), 64, pair.tmodel.params)
    assert x.shape == (64, 1) and t.shape == (64, 1)
    assert float(x.min()) >= -15.0 and float(x.max()) <= 15.0


def test_siren_layer_calls_per_step_and_validation(monkeypatch):
    """The count chip_smoke.py asserts on the card, derived here from the
    code: a KdV step evaluates the network on u, u_t (one jvp), u_x..u_xxx
    (one nest of three jvps), the BC and the IC points: 5 evaluations of
    every SIREN layer; validation the same."""
    pair = _small_cfg(siren_kdv_pair(hidden=(16,) * 3))
    calls = []
    plain = siren.siren_layer

    def counting(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(siren, "siren_layer", counting)
    trainer = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    params = pair.tmodel.params
    opt = trainer._make_adam(1, 1, list(params.values()))
    trainer._step(params, opt, torch.Generator().manual_seed(0), 64)
    assert len(calls) == 5 * 3
    calls.clear()
    trainer._val_loss(params, torch.Generator().manual_seed(1))
    assert len(calls) == 5 * 3


def test_first_adam_step_at_the_shipped_rate_matches_optax(monkeypatch):
    """One Adam step of the shipped configuration (lr 5e-3, weight decay
    5e-4) in both packages: the parameters agree to 5e-4 absolute (as
    tests/test_torch_trainer.py) except where a gradient at rounding level
    has another sign in the two packages (Adam's first step is +-lr there;
    at most 1 entry in 1000), and in both the step raises the loss by more
    than 100x. This is why chip_smoke.py checks this network's descent at
    a smaller rate."""
    import optax

    from pinnrl_tpu.training import PDETrainer as JaxTrainer

    pair = siren_kdv_pair()
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    x, t = points(40, N, **KDV_DOMAIN)
    key = jax.random.PRNGKey(2)

    def jtotal(p):
        return jtr._loss_components(p, jnp.asarray(x), jnp.asarray(t), key)["total"]

    jparams = {"net": pair.jmodel.params, "coeffs": {}}
    jopt = jtr._make_adam(1, 2)
    l0_j, g_j = jax.jit(jax.value_and_grad(jtotal))(jparams)
    updates, _ = jopt.update(g_j, jopt.init(jparams), jparams)
    jparams = optax.apply_updates(jparams, updates)
    l1_j = jax.jit(jtotal)(jparams)

    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, N))
    params = pair.tmodel.params
    topt = ttr._make_adam(1, 2, list(params.values()))
    l0_t = ttr._loss_components(params, torch.from_numpy(x), torch.from_numpy(t), None)["total"]
    l0_t.backward()
    topt.step()
    l1_t = ttr._loss_components(params, torch.from_numpy(x), torch.from_numpy(t), None)["total"]
    assert abs(float(l0_t.detach()) - float(l0_j)) / float(l0_j) < 1e-4
    for module, leaves in jparams["net"].items():
        for leaf, ref in leaves.items():
            name = f"{module}.{'weight' if module.startswith('Dense') and leaf == 'kernel' else leaf}"
            got = params[name].detach().numpy()
            got = got.T if name.endswith("weight") else got
            off = np.abs(got - np.asarray(ref)) >= 5e-4
            assert off.mean() <= 1e-3, (name, int(off.sum()))
    print(f"loss before/after one step: JAX {float(l0_j):.4e} -> {float(l1_j):.4e}, "
          f"port {float(l0_t.detach()):.4e} -> {float(l1_t.detach()):.4e}")
    assert float(l1_j) > 100.0 * float(l0_j) and float(l1_t.detach()) > 100.0 * float(l0_t.detach())
