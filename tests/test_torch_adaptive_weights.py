"""Adaptive loss weights (RBW and LRW) in the port against pinnrl_tpu.

- ``AdaptiveLossWeights``'s transitions on one value sequence: 1e-6.
- Three Adam steps of the trainer with each strategy on the small Burgers
  pair, from bridged parameters on the same collocation, BC and IC points,
  against JAX's adaptive branch (its own ``_loss_components``,
  ``AdaptiveLossWeights.update``, ``_weighted_total`` and optax chain):
  the weighted loss 1e-5 relative, the weights 1e-5, the parameters 1e-4
  absolute after 3 steps.
- LRW's per-component gradient norms (three ``torch.autograd.grad`` calls
  through kernel 1's plain twin) against JAX's ``jacrev`` norms: 1e-4.
- Adaptive weights with an L-BFGS phase 2 are refused before any step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity_helpers import burgers_pair, inject_points, jax_bc_ic_points, points

from pinnrl_tpu.training.adaptive_weights import AdaptiveLossWeights as JaxAW
from pinnrl_tpu.training.trainer import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.models.bridge import params_to_flax
from pinnrl_tpu_torch.training import PDETrainer
from pinnrl_tpu_torch.training.adaptive_weights import AdaptiveLossWeights


@pytest.mark.parametrize("strategy", ["rbw", "lrw"])
def test_transitions_match_jax(strategy):
    rng = np.random.default_rng(0)
    kw = dict(strategy=strategy, alpha=0.8, eps=1e-5, initial_weights=[0.2, 0.5, 0.3])
    ja, ta = JaxAW(**kw), AdaptiveLossWeights(**kw)
    js, ts = ja.init(), ta.init()
    for _ in range(6):
        v = rng.random(3).astype(np.float32) * 10.0 ** rng.integers(-3, 3, 3)
        js = ja.update(js, jnp.asarray(v))
        ts = ta.update(ts, torch.from_numpy(v))
        for f in ("running", "weights", "prev_weights"):
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=1e-6, err_msg=f)
        assert bool(ts.initialized) == bool(js.initialized)
    # The first update returns the initial weights.
    first = ta.update(ta.init(), torch.tensor([1.0, 2.0, 3.0]))
    np.testing.assert_allclose(first.weights.numpy(), [0.2, 0.5, 0.3])
    with pytest.raises(ValueError, match="lrw|rbw"):
        AdaptiveLossWeights(strategy="nope")


def _aw_pair(strategy):
    pair = burgers_pair()
    for cfg in (pair.jcfg, pair.tcfg):
        aw = cfg.training.adaptive_weights
        aw.enabled, aw.strategy, aw.alpha = True, strategy, 0.8
        cfg.training.optimizer = "adam"
    return pair


def _jax_norms(jtr, jparams, x, t, key):
    def comps(p):
        losses = jtr._loss_components(p, x, t, key)
        return jnp.stack([losses["residual"], losses["boundary"], losses["initial"]])

    jac = jax.jacrev(comps)(jparams)
    return jnp.sqrt(sum(jnp.sum(leaf.reshape(3, -1) ** 2, axis=1)
                        for leaf in jax.tree_util.tree_leaves(jac)))


@pytest.mark.parametrize("strategy", ["rbw", "lrw"])
def test_three_adaptive_adam_steps_match_jax(monkeypatch, strategy):
    pair = _aw_pair(strategy)
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    assert jtr.aw_enabled and ttr.aw_enabled and ttr.fused_kernel_active
    epochs, steps = 1, 4
    jopt = jtr._make_adam(epochs, steps)
    jparams = {"net": pair.jmodel.params, "coeffs": {}}
    jstate, aw_state = jopt.init(jparams), jtr.adaptive_weights.init()
    params = pair.tmodel.params
    topt = ttr._make_adam(epochs, steps, ttr._leaves(params))
    gen = torch.Generator().manual_seed(0)

    for step in range(3):
        x, t = points(200 + step, 128)
        xj, tj = jnp.asarray(x), jnp.asarray(t)
        key = jax.random.PRNGKey(step)
        losses = jtr._loss_components(jparams, xj, tj, key)
        if strategy == "lrw":
            aw_state = jtr.adaptive_weights.update(aw_state, _jax_norms(jtr, jparams, xj, tj, key))
        else:
            aw_state = jtr.adaptive_weights.update(aw_state, jnp.stack(
                [losses["residual"], losses["boundary"], losses["initial"]]))
        weights = jax.lax.stop_gradient(jtr.adaptive_weights.get_weights(aw_state))
        total, grads = jax.value_and_grad(lambda p: jtr._weighted_total(
            jtr._loss_components(p, xj, tj, key), weights))(jparams)
        updates, jstate = jopt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

        inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, 128))
        monkeypatch.setattr(ttr, "_sample",
                            lambda g, n, p: (torch.from_numpy(x), torch.from_numpy(t)))
        row = ttr._step(params, topt, gen, 128)
        assert abs(float(row[0]) - float(total)) / abs(float(total)) < 1e-5, step
        np.testing.assert_allclose(row[6:].numpy(), np.asarray(weights), rtol=1e-5, atol=1e-7)

    got = params_to_flax({k: v.detach() for k, v in params.items()})[0]
    for (path, ref), (_, mine) in zip(jax.tree_util.tree_flatten_with_path(jparams["net"])[0],
                                      jax.tree_util.tree_flatten_with_path(got)[0]):
        assert np.max(np.abs(np.asarray(mine) - np.asarray(ref))) < 1e-4, jax.tree_util.keystr(path)


def test_lrw_norms_match_jacrev(monkeypatch):
    pair = _aw_pair("lrw")
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    x, t = points(7, 128)
    key = jax.random.PRNGKey(5)
    ref = _jax_norms(jtr, {"net": pair.jmodel.params, "coeffs": {}}, jnp.asarray(x), jnp.asarray(t),
                     key)
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, 128))
    params = pair.tmodel.params
    losses = ttr._loss_components(params, torch.from_numpy(x), torch.from_numpy(t), None)
    ttr._adaptive_total(losses, ttr._leaves(params))
    # The first update's running average is the values themselves.
    np.testing.assert_allclose(ttr._aw_state.running.numpy(), np.asarray(ref), rtol=1e-4)


def test_adam_lbfgs_with_adaptive_weights_is_refused_before_any_step(monkeypatch):
    """The JAX package trains the Adam phase and then crashes at the switch;
    the port refuses the combination when the trainer is built."""
    pair = _aw_pair("rbw")
    cfg = pair.tcfg
    cfg.training.optimizer = "adam_lbfgs"
    steps = []
    monkeypatch.setattr(PDETrainer, "_step", lambda self, *a: steps.append(a))
    with pytest.raises(ValueError, match="adaptive_weights.*adam_lbfgs"):
        PDETrainer(pair.tmodel, pair.tpde, cfg).train(num_epochs=2)
    assert steps == []
    # An Adam phase 2 takes them, as in JAX; pure L-BFGS turns them off.
    monkeypatch.undo()
    cfg.training.phase2_optimizer = "adam"
    cfg.training.num_collocation_points, cfg.training.batch_size = 128, 128
    res = PDETrainer(pair.tmodel, pair.tpde, cfg).train(num_epochs=4)
    assert res["status"] == "completed" and len(res["history"]["adaptive_weights"]) == 4
    assert all(abs(sum(w) - 1.0) < 1e-5 and len(w) == 4 for w in res["history"]["adaptive_weights"])
    cfg.training.optimizer = "lbfgs"
    assert not PDETrainer(pair.tmodel, pair.tpde, cfg).aw_enabled
