"""The shipped SIREN (wave) and ResNet (Cahn-Hilliard) configurations at
their shipped learning rates: the first Adam steps in both packages.

Both trunks at reduced width (SIREN 32x3, omega_0 30; ResNet hidden 32, 2
blocks), bridged, on the same points and with JAX's BC/IC draws injected,
through each trainer's own Adam chain (clip 1.0, AdamW lr 5e-3 cosine over
the shipped 3000 epochs, weight decay 5e-4), in float64 (JAX under x64).
In float32 the two packages' losses agree to 3e-7 before the first step
and drift to 1e-5 - 2e-4 relative over three steps: Adam's first steps
move each weight by about lr whatever its gradient's size, so gradient
entries at rounding level move weights too. In float64 the losses agree to
~1e-13, so the float64 run tells a fault from rounding. Tolerance: the
total loss before each step and after the last within 1e-5 relative. Both
packages' wave loss rises over the three steps, and both Cahn-Hilliard
losses rise on the first step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (_pair, inject_loss_draws, inject_points, jax_bc_ic_points,
                                  jax_loss_draws, jax_velocity_points, points)

from pinnrl_tpu_torch.training import PDETrainer

N = 64
STEPS = 3


def _shipped_pair(name):
    from pinnrl_tpu.config import load_config as jax_load_config
    from pinnrl_tpu_torch.config import load_config

    cfgs = [jax_load_config(pde_type=name), load_config(pde_type=name, device="cpu")]
    for cfg in cfgs:
        if name == "wave":
            assert cfg.model.architecture == "siren"
            cfg.model.hidden_dims = [32, 32, 32]
        else:
            assert cfg.model.architecture == "resnet"
            cfg.model.arch_params.update({"hidden_dim": 32, "num_blocks": 2})
        cfg.training.num_boundary_points = cfg.training.num_initial_points = 32
    return _pair(*cfgs, seed=0, jitter_ln=name != "wave")


@pytest.mark.parametrize("name", ["wave", "cahn_hilliard"])
def test_first_adam_steps_at_the_shipped_rate_match_optax(monkeypatch, name):
    import optax

    from pinnrl_tpu.training import PDETrainer as JaxTrainer

    pair = _shipped_pair(name)
    tc = pair.tcfg.training
    assert tc.optimizer_config.learning_rate == pair.jcfg.training.optimizer_config.learning_rate
    epochs, per_epoch = tc.num_epochs, math.ceil(tc.num_collocation_points / tc.batch_size)
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    domain = dict(domain=tuple(tuple(d) for d in pair.tcfg.pde.domain),
                  time_domain=tuple(pair.tcfg.pde.time_domain))
    x, t = (a.astype(np.float64) for a in points(40, N, **domain))
    key = jax.random.PRNGKey(2)

    def jtotal(p):
        return jtr._loss_components(p, jnp.asarray(x), jnp.asarray(t), key)["total"]

    with jax.enable_x64(True):
        jparams = {"net": jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                                                 pair.jmodel.params), "coeffs": {}}
        jopt = jtr._make_adam(epochs, per_epoch)
        jstate = jopt.init(jparams)
        value_and_grad = jax.jit(jax.value_and_grad(jtotal))
        losses_j = []
        for _ in range(STEPS):
            loss, g = value_and_grad(jparams)
            assert loss.dtype == jnp.float64
            losses_j.append(float(loss))
            updates, jstate = jopt.update(g, jstate, jparams)
            jparams = optax.apply_updates(jparams, updates)
        losses_j.append(float(jax.jit(jtotal)(jparams)))
        # The draws JAX's loss took, in float64 as x64 makes them.
        if name == "wave":
            inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, key, N),
                          velocity=jax_velocity_points(pair.jpde, key, N))
        else:
            inject_loss_draws(monkeypatch, pair.tpde, jax_loss_draws(pair.jpde, key, N))

    params = {k: v.detach().double().requires_grad_(True) for k, v in pair.tmodel.params.items()}
    topt = ttr._make_adam(epochs, per_epoch, list(params.values()))
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    losses_t = []
    for _ in range(STEPS):
        for p in params.values():
            p.grad = None
        loss = ttr._loss_components(params, xt, tt, None)["total"]
        assert loss.dtype == torch.float64
        loss.backward()
        topt.step()
        losses_t.append(float(loss.detach()))
    with torch.no_grad():
        losses_t.append(float(ttr._loss_components(params, xt, tt, None)["total"]))
    print(f"{name}: JAX {losses_j}, port {losses_t}")
    rels = np.abs(np.array(losses_t) - losses_j) / np.abs(losses_j)
    assert np.all(rels < 1e-5), rels
    for losses in (losses_j, losses_t):
        assert losses[1] > losses[0]
        if name == "wave":
            assert losses[-1] > 5.0 * losses[0]
