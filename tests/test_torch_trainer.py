"""The training step of the port against pinnrl_tpu's optax chain.

Three Adam steps from bridged parameters on identical collocation, BC and
IC points: the loss at each step agrees to 1e-4 relative, and the
parameters after 3 steps to 5e-4 absolute. That is a quarter of one step at
lr 2e-3: Adam turns gradient differences near zero into full-size steps, so
a tighter bound on every entry would test Adam, not the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity_helpers import burgers_pair, inject_points, jax_bc_ic_points, points

from pinnrl_tpu.training.trainer import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.training import PDETrainer
from pinnrl_tpu_torch.training.trainer import cosine_decay

LOSS_TOL = 1e-4
PARAM_ATOL = 5e-4


def test_three_adam_steps_match_optax(monkeypatch):
    pair = burgers_pair()
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    assert ttr.fused_kernel_active and ttr.fast_bundle_active

    epochs, steps = 1, 4  # a cosine schedule that moves within the 3 steps
    jopt = jtr._make_adam(epochs, steps)
    jparams = {"net": pair.jmodel.params, "coeffs": {}}
    jstate = jopt.init(jparams)
    params = pair.tmodel.params
    topt = ttr._make_adam(epochs, steps, list(params.values()))

    for step in range(3):
        x, t = points(100 + step, 128)
        key = jax.random.PRNGKey(step)

        def jtotal(p):
            return jtr._loss_components(p, jnp.asarray(x), jnp.asarray(t), key)["total"]

        l_j, g_j = jax.value_and_grad(jtotal)(jparams)
        updates, jstate = jopt.update(g_j, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

        inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, 128))
        losses = ttr._loss_components(params, torch.from_numpy(x), torch.from_numpy(t), None)
        for p in topt.params:
            p.grad = None
        losses["total"].backward()
        topt.step()
        assert abs(float(losses["total"].detach()) - float(l_j)) / abs(float(l_j)) < LOSS_TOL, step

    for module, leaves in jparams["net"].items():
        for leaf, ref in leaves.items():
            name = f"{module}.{ {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}[leaf] }"
            got = params[name].detach().numpy()
            got = got.T if got.ndim == 2 else got
            assert np.max(np.abs(got - np.asarray(ref))) < PARAM_ATOL, name


def test_train_returns_finite_history():
    pair = burgers_pair()
    cfg = pair.tcfg.training
    cfg.num_collocation_points, cfg.batch_size = 256, 128
    cfg.validation_frequency = 1
    trainer = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    res = trainer.train(num_epochs=2, seed=0)
    hist = res["history"]
    assert len(hist["train_loss"]) == 2 and len(hist["val_loss"]) == 2
    assert all(np.isfinite(v) for v in hist["train_loss"] + hist["val_loss"])
    assert res["final_train_loss"] == hist["train_loss"][-1]
    assert res["status"] == "completed"
    assert trainer._final_state["params"]["net"].keys() == pair.tmodel.params.keys()
    assert len(hist["loss_components"]["residual"]) == 2
    metrics = pair.tpde.validate(pair.tmodel.apply, trainer._final_state["params"]["net"],
                                 num_points=400)
    assert np.isfinite(metrics["rel_l2"])


def test_validation_takes_the_fused_residual_path(monkeypatch):
    """Validation runs the residual through the fused kernel, as the JAX
    val_fn does: the no-grad loss equals JAX's at 1e-5 (the compute_loss
    bound), and train() calls the fused residual once per step and once per
    validation."""
    pair = burgers_pair()
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    calls = []
    fused = pair.tpde._fused_residual_loss

    def spy(params, z):
        calls.append(torch.is_grad_enabled())
        return fused(params, z)

    monkeypatch.setattr(pair.tpde, "_fused_residual_loss", spy)
    x, t = points(5, 128)
    key = jax.random.PRNGKey(3)
    ref = jtr._loss_components({"net": pair.jmodel.params, "coeffs": {}},
                               jnp.asarray(x), jnp.asarray(t), key)
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, 128))
    with torch.no_grad():
        got = ttr._loss_components(pair.tmodel.params, torch.from_numpy(x), torch.from_numpy(t), None)
    assert calls == [False]
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(got[k]) - float(ref[k])) / abs(float(ref[k])) < 1e-5, k

    monkeypatch.undo()
    monkeypatch.setattr(pair.tpde, "_fused_residual_loss", spy)
    calls.clear()
    cfg = pair.tcfg.training
    cfg.num_collocation_points, cfg.batch_size, cfg.validation_frequency = 256, 128, 1
    ttr.train(num_epochs=2, seed=0)
    assert calls == [True, True, False] * 2


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(init_value=2e-3, decay_steps=52, alpha=1e-7 / 2e-3)
    ours = cosine_decay(2e-3, 52, 1e-7 / 2e-3)
    # optax evaluates in float32: allow its rounding (eps * init_value).
    for count in (0, 1, 13, 26, 51, 52, 60):
        assert math.isclose(ours(count), float(sched(count)), rel_tol=1e-6, abs_tol=2.4e-10)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax_global_norm(scale):
    """scale = min(1, max_norm / ||g||), no epsilon, on the whole tree."""
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) * scale,
             rng.standard_normal(7).astype(np.float32) * scale]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    from pinnrl_tpu_torch.training.trainer import AdamStep

    step = AdamStep(params, lambda c: 0.0, 1.0, 0.9, 0.999, 0.0)
    step.step()  # lr 0: the parameters stay, the grads are clipped in place
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
