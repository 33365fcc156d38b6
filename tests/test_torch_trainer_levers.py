"""The trainer's levers in the port against pinnrl_tpu (the smoothness and
gPINN penalties are in ``test_torch_penalties.py``).

- The plateau scale (``AdamStep`` with ``plateau``) on one value sequence
  against optax's ``reduce_on_plateau``: exact, through a drop and the
  reset of its counter; a quadratic stepped by the whole chain (clip, Adam,
  plateau) with the scales exact and the iterates at 1e-5; the ``reduce_lr`` learning-rate history against JAX's
  own loop (its epoch functions replaced by recorders that set the scale).
- EMA: the debiased average after every Adam step and at the switch (the
  L-BFGS phase's start), against JAX's arithmetic and ``_ema_read``: 1e-5;
  a run that ends on Adam ends on the average.
- The hard-IC transform: u and u_t (heat, first-order ramp) and u and u_tt
  (wave, second-order ramp, v0 from the exact solution): 1e-5.
- ``profile_dir`` writes a Chrome trace.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax.contrib import reduce_on_plateau
from torch_parity_helpers import (
    _pair,
    burgers_pair,
    heat_pair,
    pde_pair,
    points,
    rel_to_max,
    small_recipe_trainer,
)

from pinnrl_tpu.benchmarks import convergence as jax_conv
from pinnrl_tpu.training import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.benchmarks import convergence
from pinnrl_tpu_torch.models.bridge import params_to_flax
from pinnrl_tpu_torch.training import PDETrainer
from pinnrl_tpu_torch.training.trainer import AdamStep

# ------------------------------------------------------------------ plateau


def test_plateau_scale_matches_optax_exactly():
    factor, patience = 0.5, 2
    tx = reduce_on_plateau(factor=factor, patience=patience, accumulation_size=1)
    state = tx.init({"w": jnp.zeros(3)})
    opt = AdamStep([torch.zeros(3, requires_grad=True)], lambda c: 1e-3, None, 0.9, 0.999, 0.0,
                   plateau=(factor, patience))
    best = np.float32(1.0) * np.float32(1 - 1e-4)
    values = [1.0, 0.8, 0.9, 0.85, 0.7, 0.7, 0.7, float(0.7 * (1 - 0.5e-4)), 0.69, 0.69, 0.69,
              0.5, 0.6, float(best), 0.6, 0.6]
    scales, counts = [], []
    for v in values:
        _, state = tx.update({"w": jnp.ones(3)}, state, value=jnp.float32(v))
        opt._update_scale(torch.tensor(v, dtype=torch.float32))
        assert float(opt.scale) == float(state.scale), v
        assert float(opt.best) == float(state.best_value), v
        assert int(opt.plateau_count) == int(state.plateau_count), v
        scales.append(float(opt.scale))
        counts.append(int(opt.plateau_count))
    assert scales[-1] < 0.5 * scales[0] and 0 in counts[3:] and max(counts) == patience - 1


def test_plateau_chain_steps_as_optax():
    """clip -> Adam -> plateau on a quadratic, the value each step's loss
    before its update: the new scale multiplies this step's update. The
    scales agree exactly; the iterates to 1e-5 (torch's Adam and optax's
    round their bias corrections differently, 1e-7 a step)."""
    c = np.array([0.3, -1.2, 2.0, 0.5], np.float32)
    lr, factor, patience = 0.1, 0.5, 2
    chain = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr),
                        reduce_on_plateau(factor=factor, patience=patience, accumulation_size=1))
    wj = jnp.zeros(4)
    state = chain.init(wj)
    w = torch.zeros(4, requires_grad=True)
    opt = AdamStep([w], lambda k: lr, 1.0, 0.9, 0.999, 0.0, plateau=(factor, patience))
    for _ in range(60):
        val, g = jax.value_and_grad(lambda p: jnp.sum((p - c) ** 2))(wj)
        updates, state = chain.update(g, state, wj, value=val)
        wj = optax.apply_updates(wj, updates)
        loss = torch.sum((w - torch.from_numpy(c)) ** 2)
        w.grad = None
        loss.backward()
        opt.step(loss.detach())
        assert float(opt.scale) == float(state[-1].scale)
    assert float(opt.scale) < 0.5
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(wj), rtol=0, atol=1e-5)


def _scale(epochs_done: int) -> float:
    return 0.5 ** (epochs_done // 3)


def test_reduce_lr_history_matches_jax(monkeypatch):
    """The heat recipe (adam_lbfgs, switch at 12 of 30) with reduce_lr:
    ``learning_rate * scale`` at each chunk's end, 1 after the switch."""
    cfgs = [jax_conv.build_recipe_config("heat", epochs=30),
            convergence.build_recipe_config("heat", epochs=30, device="cpu")]
    for cfg in cfgs:
        cfg.model.hidden_dims = [8, 8]
        cfg.model.arch_params["mapping_size"] = 4
        t = cfg.training
        t.scheduler_type, t.validation_frequency = "reduce_lr", 4
        t.num_collocation_points, t.batch_size = 64, 32
        t.num_boundary_points = t.num_initial_points = 16
    pair = _pair(*cfgs, seed=0, jitter_ln=False)

    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)

    def build_epoch_fn(optimizer, batch_size, steps_per_epoch, lbfgs, f64=None):
        def epoch_fn(state, chunk):
            done = len(jtr.history["train_loss"]) + chunk
            opt_state = state["opt_state"]
            if isinstance(opt_state, tuple) and not lbfgs:
                opt_state = tuple(s._replace(scale=jnp.asarray(_scale(done), jnp.float32))
                                  if hasattr(s, "scale") else s for s in opt_state)
            z = np.zeros(chunk, np.float32)
            metrics = {k: z for k in ("total", "residual", "boundary", "initial", "smoothness",
                                      "data")}
            metrics["weights"] = np.zeros((chunk, 3), np.float32)
            metrics["pts"] = np.zeros((chunk, 64, 2), np.float32)
            return {**state, "opt_state": opt_state}, metrics
        return epoch_fn

    monkeypatch.setattr(jtr, "_build_epoch_fn", build_epoch_fn)
    monkeypatch.setattr(jtr, "_build_val_fn", lambda num_points=1000: lambda p, k: 1.0)
    j_hist = jtr.train(seed=0)["history"]

    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    steps = []
    row = torch.zeros(9)

    def step(params, opt, generator, batch_size):
        steps.append(opt)
        opt.scale = torch.tensor(_scale(len(steps) // 2))  # 2 steps per epoch
        return row

    monkeypatch.setattr(ttr, "_step", step)
    monkeypatch.setattr(ttr, "_lbfgs_step", lambda params, opt, batch, generator: row)
    monkeypatch.setattr(ttr, "_val_loss", lambda params, generator: 1.0)
    t_hist = ttr.train(seed=0)["history"]
    assert len(steps) == 24 and steps[0].plateau == (pair.tcfg.training.lr_scheduler.factor,
                                                     pair.tcfg.training.lr_scheduler.patience)
    assert len(t_hist["learning_rate"]) == len(j_hist["learning_rate"]) == 30
    np.testing.assert_allclose(t_hist["learning_rate"], j_hist["learning_rate"], rtol=1e-7)
    assert min(t_hist["learning_rate"][:12]) < t_hist["learning_rate"][0]
    assert t_hist["learning_rate"][12:] == [2e-3] * 18


# ---------------------------------------------------------------------- EMA


def _jax_debiased(jtr, snapshots, d):
    """JAX's zero-initialized EMA over ``snapshots`` (flax trees) and its
    ``_ema_read``, after each update."""
    shadow = jax.tree_util.tree_map(jnp.zeros_like, snapshots[0])
    out = []
    for n, p in enumerate(snapshots, start=1):
        shadow = jax.tree_util.tree_map(lambda e, q: d * e + (1.0 - d) * q, shadow, p)
        out.append(jtr._ema_read((shadow, jnp.asarray(n, jnp.int32))))
    return out


def _flax(params):
    return jax.tree_util.tree_map(jnp.asarray, params_to_flax(
        {k: v.detach().clone() for k, v in params.items()})[0])


def _max_rel(tree_a, tree_b):
    return max(rel_to_max(a, b) for a, b in zip(jax.tree_util.tree_leaves(tree_a),
                                                jax.tree_util.tree_leaves(tree_b)))


@pytest.mark.parametrize("optimizer", ["adam_lbfgs", "adam"])
def test_ema_matches_jax_after_each_step_and_at_the_switch(monkeypatch, optimizer):
    d = 0.9
    pair = burgers_pair()
    for cfg in (pair.jcfg, pair.tcfg):
        t = cfg.training
        t.param_ema, t.optimizer, t.adam_lbfgs_switch_ratio = d, optimizer, 0.5
        t.num_collocation_points, t.batch_size, t.validation_frequency = 128, 64, 2
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg)
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg)
    snaps, reads, starts = [], [], []
    update, lbfgs_step = ttr._ema_update, ttr._lbfgs_step

    def recording_update(params):
        snaps.append(_flax(params))
        update(params)
        reads.append(ttr._ema_read())

    def recording_lbfgs(params, opt, batch, generator):
        if not starts:
            starts.append(_flax(params))
        return lbfgs_step(params, opt, batch, generator)

    monkeypatch.setattr(ttr, "_ema_update", recording_update)
    monkeypatch.setattr(ttr, "_lbfgs_step", recording_lbfgs)
    ttr.train(num_epochs=4, seed=0)
    n_adam = 4 if optimizer == "adam_lbfgs" else 8  # 2 epochs of 2 steps, or 4
    assert len(snaps) == n_adam
    ref = _jax_debiased(jtr, snaps, d)
    names = list(pair.tmodel.params)
    for r_port, r_jax in zip(reads, ref):
        assert _max_rel(_flax(dict(zip(names, r_port))), r_jax) < 1e-5
    if optimizer == "adam_lbfgs":
        assert _max_rel(starts[0], ref[-1]) < 1e-5  # phase 2 starts from the average
        assert ttr._ema_n == 0  # a fresh shadow, never updated by L-BFGS
    else:
        assert _max_rel(_flax(pair.tmodel.params), ref[-1]) < 1e-5  # it ends on the average


# ------------------------------------------------------------------ hard IC


@pytest.mark.parametrize("kind", ["heat", "wave"])
def test_hard_ic_transform_matches_jax(kind):
    pair = heat_pair() if kind == "heat" else pde_pair("wave", scale=0.35)
    pair.jmodel.output_transform = pair.jpde.hard_ic_transform()
    pair.tmodel.output_transform = pair.tpde.hard_ic_transform()
    order = 2 if kind == "wave" else 1
    dom = dict(domain=pair.tpde.domain, time_domain=pair.tpde.time_domain)
    x, t = points(5, 64, **dom)
    z = np.concatenate([x, t], axis=1)
    e = np.zeros_like(z)
    e[:, -1] = 1.0

    def jf(zz):
        return pair.jmodel.apply(pair.jmodel.params, zz)

    def tf(zz):
        return pair.tmodel.apply(pair.tmodel.params, zz)

    refs, gots = [jf(jnp.asarray(z))], [tf(torch.from_numpy(z))]
    jfn, tfn = jf, tf
    for _ in range(order):
        jfn = (lambda f: lambda zz: jax.jvp(f, (zz,), (jnp.asarray(e),))[1])(jfn)
        tfn = (lambda f: lambda zz: torch.func.jvp(f, (zz,), (torch.from_numpy(e),))[1])(tfn)
        refs.append(jfn(jnp.asarray(z)))
        gots.append(tfn(torch.from_numpy(z)))
    for k, (got, ref) in enumerate(zip(gots, refs)):
        assert rel_to_max(got, ref) < 1e-5, k
    # The IC holds exactly at t0.
    z0 = z.copy()
    z0[:, -1] = pair.tpde.time_domain[0]
    with torch.no_grad():
        u0 = tf(torch.from_numpy(z0))
        ic = pair.tpde.boundary_conditions["initial"](torch.from_numpy(x),
                                                      torch.from_numpy(z0[:, -1:]))
    assert float((u0 - ic).abs().max()) == 0.0


# ----------------------------------------------------------------- profiler


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    tr = small_recipe_trainer("burgers", epochs=3)
    tr.tcfg.profile_dir = str(tmp_path / "prof")
    tr.tcfg.validation_frequency = 1
    tr.train(seed=0)
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name == "trace_epoch1.json"  # the chunk after the first
    assert json.loads(trace.read_text())["traceEvents"]
